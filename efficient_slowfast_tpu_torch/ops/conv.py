"""3-D convolution and linear layers (port of ``ops/conv.py:333-446``).

Activations are NCDHW tensors kept in ``torch.channels_last_3d`` memory
format, so cuDNN takes its NDHWC path. Padding is torch-style symmetric
integers; the conv weight starts from the reference's MSRA fan-out normal
init (reference: slowfast/models/weight_init_helper.py:10-43) and the linear
layer from normal(std=fc_init_std) with a zero bias.

Each layer computes in its ``dtype`` (the cfg's compute dtype) while its
parameters stay float32, as the JAX package keeps ``param_dtype`` float32.

``TPU.TAP_DECOMPOSE`` and ``TPU.STEM_D2S`` are exact rewrites of the same
conv for the TPU; here they run the plain conv.

Under ``TPU.SPATIAL_SHARD`` a conv of a height-split activation runs on
its band with the neighbours' halo rows, or on the whole height where its
output would not split (``conv3d``, ``parallel/spatial.py::window``); an
int8 conv the same way, K3 on the slab: its integer products and per
element dequantization give the unsplit conv's output rows bit for bit,
at the space group's range.

int8 serving (port of ``ops/conv.py:184-330, 361-382``): after
``enable_int8(model, cfg)`` (which ``build_model`` calls), a model under
``TPU.INT8_EVAL`` serves every conv of
kernel (1, 1, 1), padding 0, groups 1 and dilation 1 (strided projections
included) as an int8 conv (``ops/kernels/int8_conv.py``, K3), and with
``TPU.INT8_SPATIAL`` also every other groups-1 conv (the stems included);
grouped and depthwise convs and ``Linear`` stay float. Such a conv keeps
its calibrated activation range in the buffer ``act_max`` and its weight
codes in ``w_codes``/``w_scale``, all non-persistent: like the JAX
package's ``quant`` collection they are no part of the checkpoint
(``engine/quantize.py`` persists the ranges). In ``calibrating`` mode it
runs the float conv in the compute dtype and raises ``act_max`` to the
largest |x| it sees (of the strided input for a pointwise conv, as JAX
slices before its matmul); otherwise it runs the int8 conv.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import spatial
from .kernels.int8_conv import int8_conv, weight_codes

def _int8_kind(m, pointwise: bool, spatial: bool):
    """"pointwise", "spatial" or None for the conv ``m``: the gates of
    ``ops/conv.py:361-382`` there."""
    if m.groups != 1 or m.dilation != (1, 1, 1):
        return None
    if m.kernel_size == (1, 1, 1) and m.padding == (0, 0, 0):
        return "pointwise" if pointwise else None
    return "spatial" if spatial else None


def enable_int8(model: nn.Module, cfg) -> nn.Module:
    """Give every conv of ``model`` its int8 serving branch from
    ``TPU.INT8_EVAL`` and ``TPU.INT8_SPATIAL`` (which needs INT8_EVAL, as
    ``ops/options.py:59-60`` there), with the non-persistent buffers of
    the chosen convs on their weight's device."""
    pointwise = bool(cfg.TPU.INT8_EVAL)
    spatial = pointwise and bool(cfg.TPU.INT8_SPATIAL)
    for m in model.modules():
        if not isinstance(m, Conv3d):
            continue
        m.int8 = _int8_kind(m, pointwise, spatial)
        if m.int8:
            dev = m.weight.device
            m.register_buffer("act_max", torch.zeros((), device=dev),
                              persistent=False)
            m.register_buffer("w_codes", torch.zeros(
                0, dtype=torch.int8, device=dev), persistent=False)
            m.register_buffer("w_scale", torch.zeros(0, device=dev),
                              persistent=False)
            m._codes_of = None
    return model


def _triple(v) -> tuple:
    if isinstance(v, (tuple, list)):
        assert len(v) == 3
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def conv3d(x, weight, bias=None, stride=(1, 1, 1), padding=(0, 0, 0),
           dilation=(1, 1, 1), groups: int = 1) -> torch.Tensor:
    """``F.conv3d`` of an NCDHW ``x``, split or whole
    (``spatial.window``)."""
    stride, padding, dilation = (_triple(stride), _triple(padding),
                                 _triple(dilation))
    xin, ph, split = spatial.window(x, weight.shape[3], stride[1],
                                    padding[1], dilation[1])
    y = F.conv3d(xin, weight, bias, stride, (padding[0], ph, padding[2]),
                 dilation, groups)
    return spatial.as_split(y) if split else y


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` with MSRA fan-out init that computes in ``dtype``."""

    def __init__(self, dim_in: int, dim_out: int,
                 kernel_size: Sequence[int] | int,
                 stride: Sequence[int] | int = 1,
                 padding: Sequence[int] | int = 0,
                 groups: int = 1, bias: bool = False,
                 dilation: Sequence[int] | int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        self.compute_dtype = dtype
        super().__init__(dim_in, dim_out, _triple(kernel_size),
                         _triple(stride), _triple(padding), _triple(dilation),
                         groups, bias, device=device)
        self.int8 = None  # "pointwise" / "spatial": set by enable_int8
        self.calibrating = False

    def reset_parameters(self) -> None:
        kt, kh, kw = self.kernel_size
        fan_out = self.out_channels * kt * kh * kw // self.groups
        nn.init.normal_(self.weight, 0.0, math.sqrt(2.0 / fan_out))
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def weight_codes(self):
        """(codes, scales) of the weight (``int8_conv.weight_codes``),
        quantized once and kept until the weight changes: a new tensor (a
        move) or an in-place write (``load_state_dict``, an optimizer step)
        bumps the key. The activation range is read at each call, so a new
        ``act_max`` needs no refresh. While ``torch.export`` traces, the
        buffers as they stand are the graph's constants."""
        if torch.compiler.is_compiling():
            return self.w_codes, self.w_scale
        w = self.weight
        key = (w.data_ptr(), w._version, w.device)
        if key != self._codes_of:
            with torch.inference_mode(False), torch.no_grad():
                self.w_codes, self.w_scale = weight_codes(w)
            self._codes_of = key
        return self.w_codes, self.w_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        if not self.int8:
            return conv3d(x.to(dt), self.weight.to(dt), bias, self.stride,
                          self.padding, self.dilation, self.groups)
        # a split x: its band with the halo rows, or the whole height
        # (``conv3d``'s window; int8 convs have dilation 1)
        xin, ph, split = spatial.window(x, self.kernel_size[1],
                                        self.stride[1], self.padding[1])
        padding = (self.padding[0], ph, self.padding[2])
        if self.calibrating:
            # the range of what the int8 conv reads: a pointwise conv's
            # strided positions; a band's range is raised to the group's
            # by ``engine/quantize.py::calibrate_int8``
            xs = xin[:, :, ::self.stride[0], ::self.stride[1],
                     ::self.stride[2]] if self.int8 == "pointwise" else xin
            with torch.no_grad():
                self.act_max.copy_(torch.maximum(
                    self.act_max, xs.abs().amax().float()))
            y = F.conv3d(xin.to(dt), self.weight.to(dt), bias, self.stride,
                         padding, self.dilation, self.groups)
        else:
            codes, scale = self.weight_codes()
            y = int8_conv(xin, codes, scale, self.act_max, bias,
                          self.kernel_size, self.stride, padding, dt)
        return spatial.as_split(y) if split else y


def int8_convs(model: nn.Module):
    """The int8-serving convs of ``model``, by name."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, Conv3d) and m.int8}


def quant_is_calibrated(model: nn.Module) -> bool:
    """True when the model has int8 convs and every one recorded a positive
    range (``ops/conv.py:321-330`` there); serving an uncalibrated (zero)
    range would zero the network."""
    convs = int8_convs(model).values()
    return bool(convs) and all(float(m.act_max) > 0.0 for m in convs)


class Linear(nn.Linear):
    """``nn.Linear`` with the reference's fc init that computes in ``dtype``."""

    def __init__(self, dim_in: int, dim_out: int, init_std: float = 0.01,
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None):
        self.init_std = init_std
        self.compute_dtype = dtype
        super().__init__(dim_in, dim_out, bias, device=device)

    def reset_parameters(self) -> None:
        nn.init.normal_(self.weight, 0.0, self.init_std)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), bias)
