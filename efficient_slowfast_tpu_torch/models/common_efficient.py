"""Shared building blocks of the efficient two-pathway families (port of
``models/common_efficient.py``).

Reference: slowfast/models/{shufflenetv2,shufflenet,mobilenetv2,
ghostnet}_helper.py, stem_helper.py:181-336 and head_helper.py:436-609 (the efficient heads).

The reference builds these models from ``nn.Sequential`` chains, so its
state_dict names carry indices (``s1.pathway0_stem.1.weight`` is the stem's
BN) and channel counts (``s2.pathway0_channel_224.features.0``). The port's
modules reproduce that tree, so a reference ``.pyth`` loads with
``strict=True``: ``ConvBNAct`` is a Sequential of conv, BN and activation
(indices 0, 1, 2) whose children a family splices into its own chains.

Activations are NCDHW views of ``channels_last_3d`` memory, as everywhere in
the port. ``channel_shuffle`` and ``shuffle_cat`` work in the (B, T, H, W, C)
view, as the JAX package's channels-last shuffle does, so their one copy
leaves the result channels-last and the convs after them take it as it is.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Conv3d, Linear
from ..ops.norm import BatchNorm3d
from ..ops.pool import adaptive_avg_pool3d_1
from .fuse import FuseFastAndSlow
from .heads import dropout


def _cl(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)  # NCDHW → the (B, T, H, W, C) view


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Channel shuffle: new channel cp·groups + g ← old channel g·C/groups +
    cp (reference: shufflenetv2_helper.py:32-43), one reshape and
    transpose of the (B, T, H, W, C) view."""
    cl = _cl(x)
    *lead, c = cl.shape
    cl = cl.reshape(*lead, groups, c // groups).transpose(-1, -2)
    return _ncdhw(cl.reshape(*lead, c))


def shuffle_cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``channel_shuffle(cat([a, b]), 2)`` of two equally wide tensors in
    one copy: channel 2i is a's i, channel 2i + 1 b's i."""
    out = torch.stack([_cl(a), _cl(b.to(a.dtype))], dim=-1)
    return _ncdhw(out.flatten(-2))


def make_divisible(v, divisor, min_value=None):
    """TF-style channel rounding (reference: ghostnet_helper.py:11-24)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


class ConvBNAct(nn.Sequential):
    """conv (0) → BN (1) → activation (2, where ``act`` is a module class)
    with torch-style integer padding and no conv bias."""

    def __init__(self, dim_in: int, dim_out: int, kernel,
                 stride=1, padding=0, groups: int = 1,
                 act: Optional[Callable[[], nn.Module]] = nn.ReLU,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        layers = [Conv3d(dim_in, dim_out, kernel, stride, padding,
                         groups=groups, dtype=dtype), norm(dim_out)]
        if act is not None:
            layers.append(act())
        super().__init__(*layers)


class _Features(nn.Module):
    """A chain under the reference's ``features`` attribute."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        return self.features(x)


class PathwayStage(nn.Module):
    """One stage of both pathways: pathway p runs its own blocks under the
    reference's name ``pathway{p}_channel_{c}.features``, ``c`` the
    family's channel label of that pathway."""

    def __init__(self, labels: Sequence[int],
                 blocks: Sequence[Sequence[nn.Module]]):
        super().__init__()
        self.names = [f"pathway{p}_channel_{c}" for p, c in enumerate(labels)]
        for name, chain in zip(self.names, blocks):
            self.add_module(name, _Features(chain))

    def forward(self, x):
        return [getattr(self, n)(xi) for n, xi in zip(self.names, x)]


class EfficientStem(nn.Module):
    """Per-pathway 3×3×3/s(1,2,2) conv → BN → activation, with an optional
    3×3×3/s(1,2,2) max pool (pad 1). ``features`` puts the chain under a
    ``features`` attribute (MobilenetV2_Model_Stem, ReLU6, no pool);
    without it the chain is the pathway's module itself (the ShuffleNetV2,
    ShuffleNet and GhostNet stems) (reference: stem_helper.py:181-336)."""

    def __init__(self, dim_in: Sequence[int], dim_out: Sequence[int],
                 with_pool: bool = False,
                 act: Callable[[], nn.Module] = nn.ReLU,
                 features: bool = False,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_pathways = len(dim_out)
        for p in range(self.num_pathways):
            chain = list(ConvBNAct(dim_in[p], dim_out[p], 3, (1, 2, 2), 1,
                                   act=act, norm=norm, dtype=dtype))
            if with_pool:
                chain.append(nn.MaxPool3d(3, (1, 2, 2), 1))
            self.add_module(f"pathway{p}_stem", _Features(chain) if features
                            else nn.Sequential(*chain))

    def forward(self, x):
        assert len(x) == self.num_pathways, (
            f"Input tensor does not contain {self.num_pathways} pathways")
        return [getattr(self, f"pathway{p}_stem")(x[p])
                for p in range(self.num_pathways)]


def classifier(dim_in: int, num_classes: int, fc_init_std: float,
               dtype: torch.dtype) -> nn.Sequential:
    """The reference's ``classifier`` (Dropout, Linear): index 0 holds no
    weights and stands in for the dropout, whose mask the port draws from
    the train step's generator (``heads.dropout``)."""
    return nn.Sequential(nn.Identity(), Linear(dim_in, num_classes,
                                               init_std=fc_init_std,
                                               dtype=dtype))


class EfficientBasicHead(nn.Module):
    """Per-pathway optional 1×1×1 conv → BN → activation, global average
    pool, concat, dropout, linear; eval applies ``act_func`` (in float32)
    and then the mean over (T, H, W).

    Covers MobileNetV2BasicHead (:436-486; ReLU6, ``pathway{p}_conv1x1x1``
    the conv chain itself), ShuffleNetV2BasicHead (:499-557; ReLU, the
    chain nested once more, ``nested``) and ShuffleNetBasicHead (:562-609;
    ``last_channel`` None, no conv) (reference: head_helper.py).
    """

    def __init__(self, dim_in: Sequence[int], num_classes: int,
                 last_channel: Optional[Sequence[int]] = None,
                 act: Callable[[], nn.Module] = nn.ReLU,
                 nested: bool = False, dropout_rate: float = 0.0,
                 act_func: str = "softmax", fc_init_std: float = 0.01,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if act_func not in ("softmax", "sigmoid"):
            raise NotImplementedError(act_func)
        self.act_func = act_func
        self.dropout_rate = dropout_rate
        self.num_pathways = len(dim_in)
        self.with_conv = last_channel is not None
        if self.with_conv:
            for p in range(self.num_pathways):
                conv = ConvBNAct(dim_in[p], last_channel[p], 1, act=act,
                                 norm=norm, dtype=dtype)
                self.add_module(f"pathway{p}_conv1x1x1",
                                nn.Sequential(conv) if nested else conv)
        width = sum(last_channel if self.with_conv else dim_in)
        self.classifier = classifier(width, num_classes, fc_init_std, dtype)

    def forward(self, inputs, generator: Optional[torch.Generator] = None):
        pools = []
        for p, x in enumerate(inputs):
            if self.with_conv:
                x = getattr(self, f"pathway{p}_conv1x1x1")(x)
            pools.append(adaptive_avg_pool3d_1(x))
        x = _cl(torch.cat(pools, dim=1))  # (B, 1, 1, 1, C)
        if self.training and self.dropout_rate > 0:
            x = dropout(x, self.dropout_rate, generator)
        x = self.classifier[1](x)
        if not self.training:
            x = x.float()
            x = (F.softmax(x, dim=-1) if self.act_func == "softmax"
                 else torch.sigmoid(x))
            x = x.mean(dim=(1, 2, 3))
        return x.reshape(x.shape[0], -1)


def cmda_fuse(cfg, dims: Sequence[int], norm, dtype):
    """The CMDA fusion (``FuseFastAndSlow``, reduction 1) of pathways
    ``dims`` = [slow, fast] channels wide, and the widths it leaves:
    [slow + fast, slow // β + fast]."""
    beta = cfg.SLOWFAST.BETA_INV
    fuse = FuseFastAndSlow(dims[0], dims[1], cfg.SLOWFAST.ALPHA, beta,
                           reduction=1, norm=norm, dtype=dtype,
                           use_flash=cfg.TPU.FLASH_ATTENTION,
                           flash_min_tokens=cfg.TPU.FLASH_MIN_TOKENS)
    return fuse, [dims[0] + dims[1], dims[0] // beta + dims[1]]
