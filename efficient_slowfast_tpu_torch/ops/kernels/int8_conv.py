"""The int8 convolution (K3): quantizers, plain version and CUDA kernel.

The JAX package serves ``TPU.INT8_EVAL`` (and ``TPU.INT8_SPATIAL``) convs
as int8 × int8 → int32 products that XLA computes
(``efficient_slowfast_tpu/ops/conv.py:243-247`` ``lax.dot_general`` for the
pointwise convs, ``:309-313`` ``lax.conv_general_dilated`` for the rest);
no stock PyTorch CUDA op computes an int8 3-D convolution, so here it is
the hand-written kernel ``csrc/int8_conv.cu``. The arithmetic, step by
step as XLA runs it:

- weights, per output channel, from the float32 kernel:
  ``s_w = max(max|w|, 1e-12) · f32(1/127)`` and
  ``wq = clip(round(w / s_w), ±127)``;
- activations, per tensor, from the calibrated ``act_max``:
  ``s_act = act_max · f32(1/127)`` and ``xq = clip(round(x / s_act), ±127)``
  with x in float32 (a bf16 x is widened first, as JAX promotes it);
- ``acc = Σ xq · wq`` in int32, then ``y = f32(acc) · (s_act · s_w)``
  rounded to the compute dtype, then ``+ bias`` in that dtype.

XLA turns each division by the constant 127 into a product with its float32
reciprocal (``0x3c010204``) and keeps the divisions by a scale, and the
rounding is half to even; both are followed here bit for bit, so the codes
and the accumulators are JAX's.

``int8_conv`` runs the kernel on a CUDA tensor (one launch a call) and the
plain version ``int8_conv_reference`` (the same quantization, the integer
codes convolved in float64, exact as |acc| ≤ 127² · 4608 < 2⁵³) on a CPU
tensor; both go through the ``torch.library`` op ``esf_torch::int8_conv``,
which a ``torch.export`` graph holds. ``int8_conv_accumulator`` returns the
int32 accumulator of the same launch instead of the output.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build

# float32(1 / 127): XLA's rewrite of a division by the constant 127
INV127 = 0.007874015718698502
# the kernel's K (kt·kh·kw·Cin, tap-major) is padded to the MMA's depth
K_ALIGN = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def weight_codes(weight: torch.Tensor):
    """(codes (Co, Kp) int8, scales (Co,) float32) of a float conv weight
    (Co, Cin, kt, kh, kw): per output channel, K ordered (kt, kh, kw, Cin)
    as the kernel reads channels-last activations, zero-padded to a
    multiple of ``K_ALIGN``."""
    w = weight.detach().float()
    co = w.shape[0]
    w_max = torch.clamp(w.abs().amax(dim=(1, 2, 3, 4)), min=1e-12)
    scale = w_max * INV127
    q = torch.clamp(torch.round(w / scale[:, None, None, None, None]),
                    -127, 127).to(torch.int8)
    q = q.permute(0, 2, 3, 4, 1).reshape(co, -1)
    k = q.shape[1]
    return F.pad(q, (0, -(-k // K_ALIGN) * K_ALIGN - k)).contiguous(), scale


def activation_codes(x: torch.Tensor, act_max: torch.Tensor) -> torch.Tensor:
    """int8 codes of ``x`` at the per-tensor scale of ``act_max``."""
    s_act = act_max.float() * INV127
    return torch.clamp(torch.round(x.float() / s_act), -127, 127).to(
        torch.int8)


def _out_shape(x, co, kernel, stride, padding):
    sizes = [(x.shape[2 + i] + 2 * padding[i] - kernel[i]) // stride[i] + 1
             for i in range(3)]
    return (x.shape[0], co, *sizes)


def int8_conv_reference(x, codes, w_scale, act_max, bias, kernel, stride,
                        padding, out_dtype, accumulate=False):
    """Plain PyTorch version: ``x`` (B, Cin, T, H, W) quantized, convolved
    with the weight codes in float64 (exact), dequantized; the int32
    accumulator where ``accumulate``. Returns channels-last (B, Co, T', H',
    W'), in ``out_dtype`` (or int32)."""
    co, ci = codes.shape[0], x.shape[1]
    kt, kh, kw = kernel
    wq = codes[:, :kt * kh * kw * ci].reshape(co, kt, kh, kw, ci)
    wq = wq.permute(0, 4, 1, 2, 3).double()
    xq = activation_codes(x, act_max).double().contiguous()
    acc = F.conv3d(xq, wq.contiguous(), None, tuple(stride),
                   tuple(padding)).to(torch.int32)
    if accumulate:
        y = acc
    else:
        s = act_max.float() * INV127 * w_scale
        y = (acc.float() * s[None, :, None, None, None]).to(out_dtype)
        if bias is not None:
            y = y + bias.to(out_dtype)[None, :, None, None, None]
    return y.contiguous(memory_format=torch.channels_last_3d)


def _check(x, codes, w_scale, act_max, bias, kernel, stride, padding):
    if x.dim() != 5:
        raise ValueError(f"int8_conv: x must be (B, Cin, T, H, W), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_conv: x is {x.dtype}; float32 or bfloat16")
    if len(kernel) != 3 or len(stride) != 3 or len(padding) != 3:
        raise ValueError("int8_conv: kernel, stride and padding are triples")
    co, kp = codes.shape
    k = kernel[0] * kernel[1] * kernel[2] * x.shape[1]
    if codes.dtype != torch.int8 or kp != -(-k // K_ALIGN) * K_ALIGN:
        raise ValueError(f"int8_conv: codes must be int8 (Co, {k} padded to "
                         f"{K_ALIGN}), got {codes.dtype} {tuple(codes.shape)}")
    if w_scale.shape != (co,) or w_scale.dtype != torch.float32:
        raise ValueError("int8_conv: w_scale must be float32 (Co,)")
    if act_max.numel() != 1 or act_max.dtype != torch.float32:
        raise ValueError("int8_conv: act_max must be one float32")
    if bias is not None and bias.shape != (co,):
        raise ValueError(f"int8_conv: bias must be ({co},)")
    if min(_out_shape(x, co, kernel, stride, padding)[2:]) <= 0:
        raise ValueError("int8_conv: empty output")


@torch.library.custom_op("esf_torch::int8_conv", mutates_args=(),
                         device_types="cpu")
def _op(x: torch.Tensor, codes: torch.Tensor, w_scale: torch.Tensor,
        act_max: torch.Tensor, bias: Optional[torch.Tensor],
        kernel: List[int], stride: List[int], padding: List[int],
        out_dtype: torch.dtype, accumulate: bool) -> torch.Tensor:
    _check(x, codes, w_scale, act_max, bias, kernel, stride, padding)
    return int8_conv_reference(x, codes, w_scale, act_max, bias, kernel,
                               stride, padding, out_dtype, accumulate)


@_op.register_kernel("cuda")
def _cuda(x, codes, w_scale, act_max, bias, kernel, stride, padding,
          out_dtype, accumulate):
    _check(x, codes, w_scale, act_max, bias, kernel, stride, padding)
    out_dtype = torch.int32 if accumulate else out_dtype
    if out_dtype not in _DTYPES:
        raise TypeError(f"int8_conv: no kernel writes {out_dtype}")
    x = x.contiguous(memory_format=torch.channels_last_3d)
    tensors = [x, codes, w_scale, act_max] + ([bias] if bias is not None
                                              else [])
    for t in tensors:
        if t.device != x.device:
            raise ValueError("int8_conv: all tensors on one device")
    if bias is not None:
        bias = bias.to(out_dtype).contiguous()
    codes, w_scale = codes.contiguous(), w_scale.contiguous()
    b, ci, t, h, w = x.shape
    co = codes.shape[0]
    shape = _out_shape(x, co, kernel, stride, padding)
    out = torch.empty(shape, dtype=out_dtype, device=x.device,
                      memory_format=torch.channels_last_3d)
    ptr = lambda v: None if v is None else ctypes.c_void_p(v.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().int8_conv_launch(
            _DTYPES[x.dtype], _DTYPES[out_dtype], ptr(x), ptr(codes),
            ptr(w_scale), ptr(act_max), ptr(bias), ptr(out), b, t, h, w, ci,
            *shape[2:], co, *kernel, *stride, *padding, codes.shape[1],
            int(x.data_ptr() % 16 == 0 and ci % 8 == 0),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"int8_conv kernel launch failed: CUDA error {err} (x "
            f"{tuple(x.shape)} {x.dtype}, Co {co}, kernel {kernel}, stride "
            f"{stride}, padding {padding})")
    int8_conv.launches += 1
    return out


@_op.register_fake
def _fake(x, codes, w_scale, act_max, bias, kernel, stride, padding,
          out_dtype, accumulate):
    return torch.empty(_out_shape(x, codes.shape[0], kernel, stride, padding),
                       dtype=torch.int32 if accumulate else out_dtype,
                       device=x.device, memory_format=torch.channels_last_3d)


def int8_conv(x, codes, w_scale, act_max, bias, kernel: Sequence[int],
              stride: Sequence[int], padding: Sequence[int],
              out_dtype: torch.dtype):
    """The int8 conv of ``x`` (B, Cin, T, H, W; float32 or bfloat16) with
    weight ``codes``/``w_scale`` (``weight_codes``) at the activation range
    ``act_max`` (one float32), plus ``bias``: channels-last (B, Co, T', H',
    W') in ``out_dtype``. The kernel on CUDA, the plain version on CPU."""
    return _op(x, codes, w_scale, act_max, bias, list(kernel), list(stride),
               list(padding), out_dtype, False)


int8_conv.launches = 0


def int8_conv_accumulator(x, codes, act_max, kernel, stride, padding):
    """The int32 accumulator Σ xq · wq of the same launch (or plain
    version): the integer part of ``int8_conv``, for exact comparisons."""
    scale = torch.ones(codes.shape[0], device=codes.device)
    return _op(x, codes, scale, act_max, None, list(kernel), list(stride),
               list(padding), torch.float32, True)


def conv_flops(x_shape, co, kernel, stride, padding) -> int:
    """2 · output positions · Co · kt·kh·kw·Cin: the float conv's count."""
    b, ci = x_shape[0], x_shape[1]
    sizes = [(x_shape[2 + i] + 2 * padding[i] - kernel[i]) // stride[i] + 1
             for i in range(3)]
    return 2 * b * sizes[0] * sizes[1] * sizes[2] * co * ci * (
        kernel[0] * kernel[1] * kernel[2])


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_conv")
    f = lib.int8_conv_launch
    f.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                  + [ctypes.c_int] * 20 + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return lib
