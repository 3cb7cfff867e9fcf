"""The int8 convolution (K3): quantizers, planner, plain versions and CUDA
kernel.

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

``int8_conv`` runs the kernel on a CUDA tensor and the plain version
``int8_conv_reference`` (the same quantization, the integer codes convolved
in float64, exact as |acc| ≤ 127² · 4608 < 2⁵³) on a CPU tensor; both go
through the ``torch.library`` op ``esf_torch::int8_conv``, which a
``torch.export`` graph holds. ``int8_conv_accumulator`` returns the int32
accumulator of the same launches instead of the output.

On the card one op call is two launches (the source's note has the
design): a quantize pass that writes each activation's code once into a
scratch buffer laid out for the conv (``quantized_layout`` is its plain
version; the stems' weight codes get the matching K layout,
``padded_codes``), and a ``wgmma`` s8 GEMM over the codes whose tiles,
K split and ring depth ``plan`` picks per shape.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build

# float32(1 / 127): XLA's rewrite of a division by the constant 127
INV127 = 0.007874015718698502
# the kernel's K (kt·kh·kw·Cin, tap-major) is padded to the MMA's depth
K_ALIGN = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

# H100 SXM limits used by the planner (NVIDIA data sheet: 132 SMs, 228 KB of
# shared memory per SM, 227 KB per block)
SMS = 132
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
# wgmma's N of the GEMM's instantiations (integer wgmma takes N in 8, 16,
# 24, 32, 48, ..., 256; these are the ones compiled), the ring's K slab in
# bytes (four k32 steps), its deepest ring, and the most K splits
WGMMA_N = (8, 16, 32, 64, 128, 256)
SLAB = 128
MAX_STAGES = 8
MAX_SPLIT = 16


# the plan's fields that the CUDA launch reads, in order
PLAN_INTS = 45


class Plan(NamedTuple):
    """One conv's launch plan; ``args`` is the int array the CUDA launch
    reads (``Plan`` in csrc/int8_conv.cu, field for field).

    The code buffer is (B, Tq, Hq, Wq, Cp) int8: position q reads x at
    q * qs + qo (zero outside x, and on channels Ci..Cp). The GEMM runs the
    conv (kernel ``kt, kh, kw``, stride ``st, sh, sw``, no padding) over it:
    A's row of an output position is kt·kh segments of ``seg`` bytes (kw·Cp
    of them the taps' codes), ``k_a`` bytes in all; B's rows are ``k_b``
    bytes (the codes' ``kp``, or their ``padded_codes`` where ``relayout``).
    A comes by TMA (``gather`` 0) or by cp.async of ``gather`` bytes.
    ``s2d``: a stride-2 conv of at most 4 channels (the stems) reads a
    buffer of 2 x 2 blocks of padded positions (16 bytes a position: sub-
    position (a, b) major, ``cp0`` channels minor; position q reads x at
    2 q + (a, b) + qo), as a stride-1 conv of its kernel halved (``kh0`` x
    ``kw0`` taps originally): 16-byte gathers in place of 8-byte ones."""
    b: int
    t: int
    h: int
    w: int
    ci: int
    tq: int
    hq: int
    wq: int
    cp: int
    qst: int
    qsh: int
    qsw: int
    qot: int
    qoh: int
    qow: int
    kt: int
    kh: int
    kw: int
    st: int
    sh: int
    sw: int
    to: int
    ho: int
    wo: int
    co: int
    m: int
    gather: int
    seg: int
    k_a: int
    k_b: int
    kp: int
    relayout: int
    s2d: int
    kh0: int
    kw0: int
    cp0: int
    nwg: int
    bn: int
    split: int
    stages: int
    smem: int
    off_b: int
    off_ws: int
    off_cnt: int
    q_bytes: int
    # not in the launch's array
    scratch: int  # bytes of the op's scratch tensor
    tiles: int
    ctas: int
    nk: int  # K slabs

    @property
    def bm(self) -> int:
        return 64 * self.nwg

    @property
    def args(self):
        return self[:PLAN_INTS]


def smem_bytes(nwg: int, bn: int, stages: int, out_size: int,
               chunks: int = 0) -> int:
    """Shared memory of a GEMM block (``Smem`` in the CUDA source): the
    ring, the staged output tile, two mbarriers a stage and the split-K
    flag, two tiles' column scales and biases, the tile's row offsets, the
    offsets of A's ``chunks`` gather units in a row, and 1 KB to align the
    base for the 128-byte swizzle."""
    bm = 64 * nwg
    return ((bm + bn) * SLAB * stages + _up(bm * (bn * out_size + 16), 16)
            + 16 * stages + 16 + 16 * bn + 4 * bm + _up(4 * chunks, 16)
            + 1024)


def _lowbit(v: int) -> int:
    return v & -v


def _up(v: int, a: int) -> int:
    return -(-v // a) * a


def _tiles(m, co, bm, bn):
    return -(-m // bm) * -(-co // bn)


@functools.lru_cache(maxsize=None)
def plan(x_shape, co: int, kernel, stride, padding, out_dtype) -> Plan:
    """The launch plan of an int8 conv of ``x_shape`` (B, Cin, T, H, W) into
    ``co`` channels (``out_dtype``, or torch.int32 for the accumulator)."""
    b, ci, t, h, w = x_shape
    kt, kh, kw = kernel
    to, ho, wo = _out_shape(x_shape, co, kernel, stride, padding)[2:]
    m = b * to * ho * wo
    cp0 = cp = _up(ci, 4)
    kh0, kw0 = kh, kw
    pointwise = tuple(kernel) == (1, 1, 1) and not any(padding)
    s2d = int(not pointwise and tuple(stride[1:]) == (2, 2) and cp == 4)
    if pointwise:  # the strided positions only (JAX slices first)
        tq, hq, wq = to, ho, wo
        qs, qo = tuple(stride), (0, 0, 0)
        kt = kh = kw = 1
        st = sh = sw = 1
        unit = min(16, _lowbit(cp))
    elif s2d:  # 2 x 2 blocks of the padded positions, the kernel halved
        kh, kw = -(-kh0 // 2), -(-kw0 // 2)
        tq = t + 2 * padding[0]
        hq = max(-(-(h + 2 * padding[1]) // 2), ho + kh - 1)
        wq = max(-(-(w + 2 * padding[2]) // 2), wo + kw - 1)
        qs, qo = (1, 2, 2), tuple(-p for p in padding)
        st, sh, sw = stride[0], 1, 1
        cp = 4 * cp0
        unit = 16
    else:  # the zero padding written in; rows padded to the gather's unit
        unit = min(16, _lowbit(cp * stride[2]))
        tq, hq = t + 2 * padding[0], h + 2 * padding[1]
        wq = _up(w + 2 * padding[2], unit // min(unit, _lowbit(cp)))
        qs, qo = (1, 1, 1), tuple(-p for p in padding)
        st, sh, sw = stride
    seg = _up(kw * cp, unit)
    k_a = kt * kh * seg
    kp = _up(kernel[0] * kernel[1] * kernel[2] * ci, K_ALIGN)
    relayout = int(cp != ci or seg != kw * cp)
    k_b = _up(k_a, K_ALIGN) if relayout else kp
    gather = 0 if pointwise and cp % 16 == 0 else unit
    nk = -(-k_b // SLAB)
    out_size = 2 if out_dtype == torch.bfloat16 else 4
    if co <= 256:
        bn = min(n for n in WGMMA_N if n >= co)
    else:
        bn = 256 if _tiles(m, co, 128, 256) >= SMS else 128
    if out_size == 4:  # a 128 x 256 tile staged in 4 bytes leaves 1 stage
        bn = min(bn, 128)
    # BM 128 unsplit where the grid is full; else BM 64 unsplit; else K
    # split over BM 128 tiles; else (K too short) BM 64 split as K allows
    nwg, split = 2, 1
    if _tiles(m, co, 128, bn) < SMS:
        if _tiles(m, co, 64, bn) >= SMS:
            nwg = 1
        else:
            tiles = _tiles(m, co, 128, bn)
            split = min(nk, MAX_SPLIT, -(-SMS // tiles))
            if tiles * split < SMS:
                nwg = 1
                split = min(nk, MAX_SPLIT,
                            -(-SMS // _tiles(m, co, 64, bn)))
    bm = 64 * nwg
    tiles = _tiles(m, co, bm, bn)
    budget = SMEM_PER_BLOCK if bn > 64 else SMEM_PER_SM // 2 - 1024
    chunks = k_a // gather if gather else 0
    # as deep a ring as fits: a block's producer runs on into its next
    # tile's slabs
    stages = 1
    while (stages < MAX_STAGES and
           smem_bytes(nwg, bn, stages + 1, out_size, chunks) <= budget):
        stages += 1
    smem = smem_bytes(nwg, bn, stages, out_size, chunks)
    q_bytes = _up(b * tq * hq * wq * cp + SLAB, 16)  # gathers read past
    off_b = _up(q_bytes, 256)
    off_ws = _up(off_b + (co * k_b if relayout else 0), 256)
    ws = split * m * -(-co // bn) * bn * 4 if split > 1 else 0
    off_cnt = _up(off_ws + ws, 256)
    scratch = off_cnt + (4 * tiles if split > 1 else 0)
    if max(b * tq * hq * wq, m * max(co, 1)) >= 2 ** 31 or scratch >= 2 ** 31:
        raise ValueError(f"int8_conv: x {tuple(x_shape)} into {co} channels "
                         "exceeds the kernel's 32-bit indexing")
    return Plan(b, t, h, w, ci, tq, hq, wq, cp, *qs, *qo, kt, kh, kw, st, sh,
                sw, to, ho, wo, co, m, gather, seg, k_a, k_b, kp, relayout,
                s2d, kh0, kw0, cp0, nwg, bn, split, stages, smem, off_b,
                off_ws, off_cnt, q_bytes, scratch, tiles, tiles * split, nk)


def quantized_layout(x: torch.Tensor, act_max: torch.Tensor,
                     p: Plan) -> torch.Tensor:
    """Plain version of the quantize pass's code buffer: (B, Tq, Hq, Wq, Cp)
    int8, ``activation_codes`` of the kept positions (a pointwise conv's
    strided ones), zero codes on the padding, the padded channels and the
    rows' alignment columns; for ``s2d`` each position a 2 x 2 block of
    padded positions, sub-position major."""
    codes = activation_codes(x, act_max)
    if p.s2d:
        before = (-p.qot, -p.qoh, -p.qow)
        sizes = (p.tq, 2 * p.hq, 2 * p.wq)
    else:
        codes = codes[:, :, ::p.qst, ::p.qsh, ::p.qsw]
        before = (-p.qot, -p.qoh, -p.qow)
        sizes = (p.tq, p.hq, p.wq)
    after = [q - s - b for q, s, b in zip(sizes, codes.shape[2:], before)]
    codes = F.pad(codes, (before[2], after[2], before[1], after[1],
                          before[0], after[0]))
    codes = F.pad(codes.permute(0, 2, 3, 4, 1), (0, p.cp0 - p.ci))
    if p.s2d:  # (B, T, 2 Hq, 2 Wq, cp0) -> (B, T, Hq, Wq, 2, 2, cp0)
        codes = codes.reshape(p.b, p.tq, p.hq, 2, p.wq, 2, p.cp0).permute(
            0, 1, 2, 4, 3, 5, 6).reshape(p.b, p.tq, p.hq, p.wq, p.cp)
    return codes.contiguous()


def padded_codes(codes: torch.Tensor, p: Plan) -> torch.Tensor:
    """Plain version of the weight codes the GEMM reads: ``codes`` (Co, Kp)
    itself, or where the plan pads K (channels to Cp, each kw·Cp segment to
    the gather's unit; s2d's halved kernel over 2 x 2 blocks) the same
    codes in that layout, (Co, k_b)."""
    if not p.relayout:
        return codes
    co = codes.shape[0]
    w = codes[:, :p.kt * p.kh0 * p.kw0 * p.ci].reshape(co, p.kt, p.kh0,
                                                       p.kw0, p.ci)
    w = F.pad(w, (0, p.cp0 - p.ci))
    if p.s2d:  # taps (2 dy + a, 2 dx + b) -> (dy, dx, a, b)
        w = F.pad(w, (0, 0, 0, 2 * p.kw - p.kw0, 0, 2 * p.kh - p.kh0))
        w = w.reshape(co, p.kt, p.kh, 2, p.kw, 2, p.cp0).permute(
            0, 1, 2, 4, 3, 5, 6)
    w = w.reshape(co, p.kt * p.kh, p.kw * p.cp)
    w = F.pad(w, (0, p.seg - p.kw * p.cp)).reshape(co, p.k_a)
    return F.pad(w, (0, p.k_b - p.k_a)).contiguous()


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


def _out_shape(x_shape, co, kernel, stride, padding):
    sizes = [(x_shape[2 + i] + 2 * padding[i] - kernel[i]) // stride[i] + 1
             for i in range(3)]
    return (x_shape[0], co, *sizes)


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
    if min(_out_shape(x.shape, co, kernel, stride, padding)[2:]) <= 0:
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


def _launch(x, codes, w_scale, act_max, bias, kernel, stride, padding,
            out_dtype, quantize_only=False):
    """Both launches (or the quantize pass alone) on the card: returns
    (plan, out or None, scratch)."""
    x = x.contiguous(memory_format=torch.channels_last_3d)
    for t in (codes, w_scale, act_max, bias):
        if t is not None and t.device != x.device:
            raise ValueError("int8_conv: all tensors on one device")
    if bias is not None:
        bias = bias.to(out_dtype).contiguous()
    codes, w_scale = codes.contiguous(), w_scale.contiguous()
    p = plan(tuple(x.shape), codes.shape[0], tuple(kernel), tuple(stride),
             tuple(padding), out_dtype)
    out = None if quantize_only else torch.empty(
        _out_shape(x.shape, p.co, kernel, stride, padding), dtype=out_dtype,
        device=x.device, memory_format=torch.channels_last_3d)
    scratch = torch.empty(p.scratch, dtype=torch.int8, device=x.device)
    lib = _lib()
    ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
    dev = x.device.index
    switch = dev is not None and dev != torch.cuda.current_device()
    with torch.cuda.device(x.device) if switch else _NO_SWITCH:
        err = lib.int8_conv_launch(
            _plan_array(p), len(p.args), _DTYPES[x.dtype], _DTYPES[out_dtype],
            x.data_ptr(), codes.data_ptr(), w_scale.data_ptr(),
            act_max.data_ptr(), ptr(bias), ptr(out), scratch.data_ptr(),
            int(quantize_only), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"int8_conv kernel launch failed: CUDA error {err} (x "
            f"{tuple(x.shape)} {x.dtype}, Co {p.co}, kernel {kernel}, stride "
            f"{stride}, padding {padding}, plan {p})")
    return p, out, scratch


_NO_SWITCH = contextlib.nullcontext()


@functools.lru_cache(maxsize=None)
def _plan_array(p: Plan):
    return (ctypes.c_int * len(p.args))(*p.args)


@_op.register_kernel("cuda")
def _cuda(x, codes, w_scale, act_max, bias, kernel, stride, padding,
          out_dtype, accumulate):
    _check(x, codes, w_scale, act_max, bias, kernel, stride, padding)
    out_dtype = torch.int32 if accumulate else out_dtype
    if out_dtype not in _DTYPES:
        raise TypeError(f"int8_conv: no kernel writes {out_dtype}")
    _, out, _ = _launch(x, codes, w_scale, act_max, bias, kernel, stride,
                        padding, out_dtype)
    int8_conv.launches += 1
    return out


@_op.register_fake
def _fake(x, codes, w_scale, act_max, bias, kernel, stride, padding,
          out_dtype, accumulate):
    return torch.empty(_out_shape(x.shape, codes.shape[0], kernel, stride,
                                    padding),
                       dtype=torch.int32 if accumulate else out_dtype,
                       device=x.device, memory_format=torch.channels_last_3d)


def int8_conv(x, codes, w_scale, act_max, bias, kernel: Sequence[int],
              stride: Sequence[int], padding: Sequence[int],
              out_dtype: torch.dtype):
    """The int8 conv of ``x`` (B, Cin, T, H, W; float32 or bfloat16) with
    weight ``codes``/``w_scale`` (``weight_codes``) at the activation range
    ``act_max`` (one float32), plus ``bias``: channels-last (B, Co, T', H',
    W') in ``out_dtype``. The kernel on CUDA, the plain version on CPU.

    An eager call on plain CUDA tensors runs the op's CUDA kernel
    directly: the dispatcher's ~40 us a call buys nothing there. A traced
    call (``torch.export``'s fake or functional tensors, a compiler) or one
    that autograd would record goes through the op, so that a graph holds
    its node."""
    if (type(x) is torch.Tensor and x.is_cuda and
            not torch.compiler.is_compiling() and
            not (torch.is_grad_enabled() and x.requires_grad)):
        return _cuda(x, codes, w_scale, act_max, bias, kernel, stride,
                     padding, out_dtype, False)
    return _op(x, codes, w_scale, act_max, bias, list(kernel), list(stride),
               list(padding), out_dtype, False)


int8_conv.launches = 0


def int8_conv_accumulator(x, codes, act_max, kernel, stride, padding):
    """The int32 accumulator Σ xq · wq of the same launch (or plain
    version): the integer part of ``int8_conv``, for exact comparisons."""
    scale = torch.ones(codes.shape[0], device=codes.device)
    return _op(x, codes, scale, act_max, None, list(kernel), list(stride),
               list(padding), torch.float32, True)


def int8_conv_layout(x, codes, act_max, kernel, stride, padding):
    """(code buffer, weight codes) that the GEMM reads for this conv: on a
    CUDA tensor the quantize pass's own outputs (its launch alone, not
    counted), on a CPU tensor their plain versions (``quantized_layout``,
    ``padded_codes``); for exact checks of the quantize pass."""
    p = plan(tuple(x.shape), codes.shape[0], tuple(kernel), tuple(stride),
             tuple(padding), torch.float32)
    if x.device.type != "cuda":
        return quantized_layout(x, act_max, p), padded_codes(codes, p)
    scale = torch.ones(codes.shape[0], device=codes.device)
    _, _, scratch = _launch(x, codes, scale, act_max, None, kernel, stride,
                            padding, torch.float32, quantize_only=True)
    q = scratch[:p.b * p.tq * p.hq * p.wq * p.cp].view(
        p.b, p.tq, p.hq, p.wq, p.cp)
    bq = codes if not p.relayout else scratch[
        p.off_b:p.off_b + p.co * p.k_b].view(p.co, p.k_b)
    return q, bq


def conv_flops(x_shape, co, kernel, stride, padding) -> int:
    """2 · output positions · Co · kt·kh·kw·Cin: the float conv's count."""
    b, ci = x_shape[0], x_shape[1]
    sizes = [(x_shape[2 + i] + 2 * padding[i] - kernel[i]) // stride[i] + 1
             for i in range(3)]
    return 2 * b * sizes[0] * sizes[1] * sizes[2] * co * ci * (
        kernel[0] * kernel[1] * kernel[2])


_LIB: List[ctypes.CDLL] = []


def _lib() -> ctypes.CDLL:
    """The kernel library, its argument types set once at load."""
    if not _LIB:
        lib = _build.load("int8_conv")
        f = lib.int8_conv_launch
        f.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                      + [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p])
        f.restype = ctypes.c_int
        if lib.int8_conv_plan_ints() != PLAN_INTS:
            raise RuntimeError("int8_conv: the library's plan differs from "
                               "ops/kernels/int8_conv.py::Plan")
        _LIB.append(lib)
    return _LIB[0]
