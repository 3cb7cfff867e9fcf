"""3-D ResNet stages (port of ``models/resnet.py:23-210``).

Reference: slowfast/models/resnet_helper.py (BasicTransform :25-107,
BottleneckTransform :110-240, ResBlock :243-358, ResStage :361-561). Module
names are the reference's, so its state_dict loads as it is. A stage puts a
non-local block (``pathway{p}_nonlocal{i}``, ``models/nonlocal_block.py``)
after block i of pathway p for each i of ``nonlocal_inds[p]``.

A ResStage built with ``remat`` is rematerialised in training, the
counterpart of the JAX package's ``nn.remat`` stage (``models/slowfast.py::
_stage_cls``): ``torch.utils.checkpoint`` keeps only its inputs and runs it
again in the backward. The recompute normalises with the same batch
statistics but leaves the running ones alone, so that they are updated
once per step, as flax's remat updates ``batch_stats`` once.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.conv import Conv3d
from ..ops.norm import BatchNorm3d, SubBatchNorm3d
from .nonlocal_block import Nonlocal


class BasicTransform(nn.Module):
    """Tx3x3 → BN → ReLU → 1x3x3 → BN (final BN may be zero-init)."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel_size: int,
                 stride: int, dim_inner: int | None = None,
                 num_groups: int = 1, stride_1x1: bool = False,
                 dilation: int = 1, zero_init_final_bn: bool = False,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        tk = temp_kernel_size
        self.a = Conv3d(dim_in, dim_out, (tk, 3, 3), (1, stride, stride),
                        (tk // 2, 1, 1), dtype=dtype)
        self.a_bn = norm(dim_out)
        self.b = Conv3d(dim_out, dim_out, (1, 3, 3), 1, (0, 1, 1), dtype=dtype)
        self.b_bn = norm(dim_out, zero_init_gamma=zero_init_final_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.a_bn(self.a(x)))
        return self.b_bn(self.b(x))


class BottleneckTransform(nn.Module):
    """Tx1x1 → 1x3x3 (stride, groups, dilation) → 1x1x1, BN+ReLU between."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel_size: int,
                 stride: int, dim_inner: int = 64, num_groups: int = 1,
                 stride_1x1: bool = False, dilation: int = 1,
                 zero_init_final_bn: bool = False,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        str1, str3 = (stride, 1) if stride_1x1 else (1, stride)
        tk = temp_kernel_size
        self.a = Conv3d(dim_in, dim_inner, (tk, 1, 1), (1, str1, str1),
                        (tk // 2, 0, 0), dtype=dtype)
        self.a_bn = norm(dim_inner)
        self.b = Conv3d(dim_inner, dim_inner, (1, 3, 3), (1, str3, str3),
                        (0, dilation, dilation), groups=num_groups,
                        dilation=(1, dilation, dilation), dtype=dtype)
        self.b_bn = norm(dim_inner)
        self.c = Conv3d(dim_inner, dim_out, 1, dtype=dtype)
        self.c_bn = norm(dim_out, zero_init_gamma=zero_init_final_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.a_bn(self.a(x)))
        x = F.relu(self.b_bn(self.b(x)))
        return self.c_bn(self.c(x))


_TRANS_FUNCS = {
    "basic_transform": BasicTransform,
    "bottleneck_transform": BottleneckTransform,
}


def get_trans_func(name: str):
    assert name in _TRANS_FUNCS, f"Transformation function '{name}' not supported"
    return _TRANS_FUNCS[name]


class ResBlock(nn.Module):
    """Residual block with projection shortcut on dim/stride change."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel_size: int,
                 stride: int, trans_func_name: str = "bottleneck_transform",
                 dim_inner: int = 64, num_groups: int = 1,
                 stride_1x1: bool = False, dilation: int = 1,
                 zero_init_final_bn: bool = False,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim_in != dim_out or stride != 1:
            self.branch1 = Conv3d(dim_in, dim_out, 1, (1, stride, stride),
                                  dtype=dtype)
            self.branch1_bn = norm(dim_out)
        self.branch2 = get_trans_func(trans_func_name)(
            dim_in, dim_out, temp_kernel_size, stride, dim_inner=dim_inner,
            num_groups=num_groups, stride_1x1=stride_1x1, dilation=dilation,
            zero_init_final_bn=zero_init_final_bn, norm=norm, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sc = self.branch1_bn(self.branch1(x)) if hasattr(self, "branch1") else x
        return F.relu(sc + self.branch2(x))


class ResStage(nn.Module):
    """Multi-pathway stage of residual blocks.

    Per-block temporal kernel schedule: the first ``num_block_temp_kernel``
    blocks cycle through the pathway's temporal kernels, the rest use 1
    (reference: resnet_helper.py:443-447). A non-local block of pathway p
    has ``dim_out[p] // 2`` inner channels; with ``nonlocal_group[p]`` g > 1
    it attends within each of g groups of consecutive frames, folded into
    the batch (reference :541-558).
    """

    def __init__(self, dim_in: Sequence[int], dim_out: Sequence[int],
                 dim_inner: Sequence[int],
                 temp_kernel_sizes: Sequence[Sequence[int]],
                 stride: Sequence[int], num_blocks: Sequence[int],
                 num_groups: Sequence[int],
                 num_block_temp_kernel: Sequence[int],
                 nonlocal_inds: Sequence[Sequence[int]],
                 nonlocal_group: Sequence[int],
                 nonlocal_pool: Sequence[Sequence[int]],
                 instantiation: str = "dot_product",
                 trans_func_name: str = "bottleneck_transform",
                 stride_1x1: bool = False, dilation: Sequence[int] = (1, 1),
                 zero_init_final_bn: bool = False,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 use_flash: bool = True, flash_min_tokens: int = 1024):
        super().__init__()
        self.remat = remat
        self.num_blocks = list(num_blocks)
        self.nonlocal_inds = [list(inds) for inds in nonlocal_inds]
        self.nonlocal_group = list(nonlocal_group)
        for p in range(len(num_blocks)):
            tks = ((list(temp_kernel_sizes[p]) * num_blocks[p])
                   [:num_block_temp_kernel[p]]
                   + [1] * (num_blocks[p] - num_block_temp_kernel[p]))
            for i in range(num_blocks[p]):
                self.add_module(f"pathway{p}_res{i}", ResBlock(
                    dim_in[p] if i == 0 else dim_out[p], dim_out[p], tks[i],
                    stride[p] if i == 0 else 1,
                    trans_func_name=trans_func_name,
                    dim_inner=dim_inner[p], num_groups=num_groups[p],
                    stride_1x1=stride_1x1, dilation=dilation[p],
                    zero_init_final_bn=zero_init_final_bn, norm=norm,
                    dtype=dtype))
                if i in self.nonlocal_inds[p]:
                    self.add_module(f"pathway{p}_nonlocal{i}", Nonlocal(
                        dim_out[p], dim_out[p] // 2, nonlocal_pool[p],
                        instantiation, norm=norm, use_flash=use_flash,
                        flash_min_tokens=flash_min_tokens, dtype=dtype))

    def forward(self, inputs):
        assert len(inputs) == len(self.num_blocks)
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(self._pathways, *inputs, use_reentrant=False,
                              context_fn=self._remat_contexts)
        return self._pathways(*inputs)

    def _pathways(self, *inputs):
        outputs = []
        for p, x in enumerate(inputs):
            for i in range(self.num_blocks[p]):
                x = getattr(self, f"pathway{p}_res{i}")(x)
                if i in self.nonlocal_inds[p]:
                    x = self._nonlocal(p, i, x)
            outputs.append(x)
        return outputs

    def _nonlocal(self, p, i, x):
        nln = getattr(self, f"pathway{p}_nonlocal{i}")
        g = self.nonlocal_group[p]
        if g == 1:
            return nln(x)
        # g groups of T/g consecutive frames, as the JAX package's reshape
        # of its (B, T, H, W, C) tensor: in the channels-last view, so that
        # batch entry b g + j holds frames j T/g .. (j + 1) T/g - 1 of b
        b, c, t, h, w = x.shape
        y = x.permute(0, 2, 3, 4, 1).reshape(b * g, t // g, h, w, c)
        y = nln(y.permute(0, 4, 1, 2, 3))
        return y.permute(0, 2, 3, 4, 1).reshape(b, t, h, w, c).permute(
            0, 4, 1, 2, 3)

    def _remat_contexts(self):
        """(forward, recompute) contexts of the checkpoint: the recompute
        leaves the BN running statistics alone."""
        return contextlib.nullcontext(), self._frozen_stats()

    @contextlib.contextmanager
    def _frozen_stats(self):
        bns = [m for m in self.modules()
               if isinstance(m, (BatchNorm3d, SubBatchNorm3d))]
        for m in bns:
            m.update_stats = False
        try:
            yield
        finally:
            for m in bns:
                m.update_stats = True
