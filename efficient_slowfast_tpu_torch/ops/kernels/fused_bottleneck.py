"""Fused eval bottleneck block: BN folding, plain version and CUDA kernel.

Port of ``efficient_slowfast_tpu/ops/pallas/fused_bottleneck.py``. One
eval-mode ResNet bottleneck block with BN folded into its convs, on a
channels-last ``x`` of shape (N = B*T, H, W, Cin):

  a   = relu(Tx1x1 conv(x) + ba)        kt in {1, 3}, zero taps at clip edges
  b   = relu(1x3x3 conv(a, pad 1) + bb)
  out = relu(b @ wc + bc + residual)    residual = x or x @ wp + bp

``fused_bottleneck`` runs the hand-written kernel ``csrc/fused_bottleneck.cu``
on a CUDA tensor (one launch per block; a and b never reach device memory)
and the plain version ``bottleneck_reference`` on a CPU tensor. A CUDA
tensor never takes the plain version: what the kernel does not take raises.
Both are the ``torch.library`` op ``esf_torch::fused_bottleneck``, so a
``torch.export`` graph holds the block as one node; the split (``plan``)
is picked inside the op, from the concrete shape of each call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build

# H100 SXM limits used to pick the split (NVIDIA data sheet: 132 SMs, 228 KB
# of shared memory per SM, 227 KB per block)
_SMS = 132
_SMEM_PER_SM = 233472
_SMEM_PER_BLOCK = 232448
# float32 kernel: f32 staging of one K chunk (16) of the largest A tile
# (512) plus its B tile (8); kStageFloats in the CUDA source
_STAGE_BYTES = 16 * (512 + 8) * 4
# bfloat16 kernel: its least ring, three stages of a staged x chunk (128
# pixels x (32 + 8)) and a weight chunk (32 x (128 + 8)), bf16 (kRingElems
# in the CUDA source); a block that has an SM to itself gets the rest of
# its 227 KB, one of two gets the rest of half the SM's 228 KB less 1 KB
_RING_BYTES = 2 * 3 * (128 * 40 + 32 * 136)
_HALF_SM_BYTES = _SMEM_PER_SM // 2 - 1024
# the split's cost model: effective rates of one block of the bfloat16
# kernel on an H100 SM (per ns; tensor-core FLOPs, bytes from L2) and its
# cost per K chunk of a pass, fitted to the kernel's measured times over
# splits (PERF.md, K1); and the blocks that run at once for each cluster
# size at one and at two blocks per SM (cudaOccupancyMaxActiveClusters on
# an H100 SXM, whose clusters must fit in one GPC)
_FLOP_PER_NS = 374.6
_BYTES_PER_NS = 10.4
_NS_PER_CHUNK = 1000.0
_SLOTS = {1: {1: 132, 2: 132, 4: 120, 8: 120},
          2: {1: 264, 2: 264, 4: 248, 8: 240}}


def fold_bn(kernel, scale, bias, mean, var, eps=1e-5):
    """Fold an eval-mode BN affine into the preceding conv.

    kernel: (..., Cin, Cout); BN params are (Cout,). Returns (W', b') with
    W' = W * g, b' = bias - mean * g, g = scale / sqrt(var + eps).
    """
    g = scale * torch.rsqrt(var.float() + eps)
    return kernel * g, bias - mean * g


def bottleneck_reference(x, t_len, wa, ba, wb, bb, wc, bc, wp=None, bp=None):
    """Plain PyTorch version of the fused block, float32 throughout.

    x: (N, H, W, Cin) with N = B*t_len; wa: (kt, Cin, Ci); wb: (3, 3, Ci, Ci);
    wc: (Ci, Cout); optional projection wp: (Cin, Cout). Returns x's dtype.
    """
    n, h, w, cin = x.shape
    kt = wa.shape[0]
    xf = x.float()
    if kt == 1:
        a = xf @ wa[0].float()
    else:
        xc = xf.reshape(n // t_len, t_len, h, w, cin)
        xm = F.pad(xc, (0, 0, 0, 0, 0, 0, 1, 1))
        a = sum(xm[:, dt:dt + t_len] @ wa[dt].float()
                for dt in range(3)).reshape(n, h, w, -1)
    a = torch.relu(a + ba)
    ap = F.pad(a, (0, 0, 1, 1, 1, 1))
    bacc = sum(ap[:, dy:dy + h, dx:dx + w] @ wb[dy, dx].float()
               for dy in range(3) for dx in range(3))
    bv = torch.relu(bacc + bb)
    cv = bv @ wc.float() + bc
    res = xf @ wp.float() + bp if wp is not None else xf
    return torch.relu(cv + res).to(x.dtype)


def _pad16(c: int) -> int:
    return -(-c // 16) * 16


def smem_bytes(elem_bytes: int, h: int, w: int, ci: int, rows: int,
               ring: int = _RING_BYTES) -> int:
    """Shared memory of one block: fused_bottleneck_smem_bytes (float32) and
    fused_bottleneck_tc_smem_bytes (bfloat16, with a ring of ``ring``
    bytes) in the .cu."""
    if elem_bytes == 4:
        return _STAGE_BYTES + (2 * rows + 2) * w * ci * elem_bytes
    lda = _pad16(ci) + 8  # a pixel's channels, padded by 16 bytes
    a_pixels = min(rows + 2, h) * w + 1  # image rows and a zero pixel
    return 2 * (a_pixels + rows * w) * lda + ring


class Split(NamedTuple):
    """How one launch divides the work."""
    cluster: int  # blocks of a thread block cluster
    rows: int     # output rows of a cluster's strip of one frame
    ctas: int     # blocks of the launch
    pixels: int   # output pixels of a block's strip
    ring: int     # bytes of the bf16 kernel's ring (0 for float32)
    smem: int     # dynamic shared memory of a block, bytes


def plan_rows(n, h, w, cin, ci, cout, kt, elem_bytes, has_proj) -> int:
    """Strip height of one block: the least waves × per-block work.

    A strip of r rows recomputes a on r + 2 rows (its halo), so tall strips
    waste less; short strips make more blocks for the card's 132 SMs. At
    most two blocks share an SM (registers), fewer where shared memory says.
    """
    best = None
    for rows in range(1, h + 1):
        smem = smem_bytes(elem_bytes, h, w, ci, rows)
        if smem > _SMEM_PER_BLOCK:
            break
        per_sm = min(2, _SMEM_PER_SM // (smem + 1024))
        blocks = n * -(-h // rows)
        waves = -(-blocks // (_SMS * per_sm))
        work = ((rows + 2) * w * kt * cin * ci
                + rows * w * (9 * ci * ci + ci * cout
                              + (cin * cout if has_proj else 0)))
        if best is None or waves * work < best[0]:
            best = (waves * work, rows)
    if best is None:
        raise ValueError(
            f"fused_bottleneck: a one-row strip of W={w}, Ci={ci} does not "
            "fit in shared memory")
    return best[1]


@functools.lru_cache(maxsize=None)
def plan(n, h, w, cin, ci, cout, kt, elem_bytes, has_proj) -> Split:
    """The split of one launch, cached per shape.

    float32: one block per strip of ``plan_rows`` rows. bfloat16: a cluster
    of 1, 2, 4 or 8 blocks per strip of R rows (Ci and Cout multiples of 16
    times the cluster, at most 227 KB of shared memory a block, and at least
    64 output pixels a strip, or half a frame where a frame has fewer than
    128: the 8 x 8 frames of slow s5 would otherwise give 64 blocks to the
    card's 132 SMs), the one with the least waves x per-block time. A
    block's time is its tensor-core
    operations (halo and channel padding included), the bytes it reads (x
    for every block of a cluster, its slice of the weights) and writes, and
    its K chunks, at the fitted rates; one block runs per SM where Ci >= 64
    (the kernel's wide tiles take up to 255 registers), else two where
    shared memory allows.
    """
    if elem_bytes == 4:
        rows = plan_rows(n, h, w, cin, ci, cout, kt, elem_bytes, has_proj)
        return Split(1, rows, n * -(-h // rows), rows * w, 0,
                     smem_bytes(4, h, w, ci, rows))
    cip, cinp = _pad16(ci), _pad16(cin)
    min_pixels = min(64, h * w // 2)
    best = None
    for cl in (1, 2, 4, 8):
        if cl > 1 and (ci % (16 * cl) or cout % (16 * cl)):
            continue
        for rows in range(1, h + 1):
            least = smem_bytes(2, h, w, ci, rows)
            if least > _SMEM_PER_BLOCK:
                break
            if rows * w < min_pixels:
                continue
            per_sm = 1 if ci >= 64 or least > _HALF_SM_BYTES else 2
            budget = _SMEM_PER_BLOCK if per_sm == 1 else _HALF_SM_BYTES
            ring = _RING_BYTES + (budget - least) // 16 * 16
            smem = least - _RING_BYTES + ring
            ctas = cl * n * -(-h // rows)
            waves = -(-ctas // _SLOTS[per_sm][cl])
            rows_a = min(rows + 2, h)
            proj_k = cinp if has_proj else 0
            flops = 2 * w * (rows_a * kt * cinp * cip + rows * (
                9 * cip * cip + cip * cout + proj_k * cout)) / cl
            weights = kt * cin * ci + 9 * ci * ci + ci * cout + (
                cin * cout if has_proj else 0)
            nbytes = 2 * (rows_a * w * kt * cin
                          + (rows * w * cout + weights) / cl)
            chunks = (kt * cinp + 9 * cip + cip + proj_k) / 64
            cost = waves * (flops / _FLOP_PER_NS + nbytes / _BYTES_PER_NS
                            + chunks * _NS_PER_CHUNK)
            if best is None or cost < best[0]:
                best = (cost, Split(cl, rows, ctas, rows * w, ring, smem))
    if best is None:
        raise ValueError(
            f"fused_bottleneck: no split of W={w}, Ci={ci} fits in shared "
            "memory")
    return best[1]


def _check(x, t_len, wa, ba, wb, bb, wc, bc, wp, bp, stride, dilation,
           groups):
    if stride != 1 or dilation != 1 or groups != 1:
        raise ValueError("fused_bottleneck takes stride 1, dilation 1 and "
                         f"groups 1 only (got {stride}, {dilation}, {groups})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_bottleneck: x is {x.dtype}; "
                        "float32 or bfloat16 only")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got {tuple(x.shape)}")
    n, h, w, cin = x.shape
    if wa.dim() != 3 or wa.shape[0] not in (1, 3) or wa.shape[1] != cin:
        raise ValueError(f"wa must be (1|3, {cin}, Ci), got {tuple(wa.shape)}")
    ci = wa.shape[2]
    cout = wc.shape[-1]
    shapes = [(wb, (3, 3, ci, ci)), (wc, (ci, cout)), (ba, (ci,)),
              (bb, (ci,)), (bc, (cout,))]
    if (wp is None) != (bp is None):
        raise ValueError("wp and bp come together")
    if wp is not None:
        shapes += [(wp, (cin, cout)), (bp, (cout,))]
    elif cin != cout:
        raise ValueError(f"identity shortcut needs Cin == Cout ({cin}, {cout})")
    for t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
    if t_len <= 0 or n % t_len:
        raise ValueError(f"N={n} is not a whole number of {t_len}-frame clips")


def fused_bottleneck(x, t_len, wa, ba, wb, bb, wc, bc, wp=None, bp=None, *,
                     stride=1, dilation=1, groups=1):
    """Fused eval bottleneck. x: (N, H, W, Cin), N = B*t_len; BN folded.

    On a CUDA tensor it launches the kernel, with the split that ``plan``
    picks; on a CPU tensor it runs ``bottleneck_reference``.
    Returns (N, H, W, Cout) in x's dtype.
    """
    if stride != 1 or dilation != 1 or groups != 1:
        raise ValueError("fused_bottleneck takes stride 1, dilation 1 and "
                         f"groups 1 only (got {stride}, {dilation}, {groups})")
    return _op(x, t_len, wa, ba, wb, bb, wc, bc, wp, bp)


fused_bottleneck.launches = 0


@torch.library.custom_op("esf_torch::fused_bottleneck", mutates_args=(),
                         device_types="cpu")
def _op(x: torch.Tensor, t_len: int, wa: torch.Tensor, ba: torch.Tensor,
        wb: torch.Tensor, bb: torch.Tensor, wc: torch.Tensor,
        bc: torch.Tensor, wp: Optional[torch.Tensor],
        bp: Optional[torch.Tensor]) -> torch.Tensor:
    _check(x, t_len, wa, ba, wb, bb, wc, bc, wp, bp, 1, 1, 1)
    return bottleneck_reference(x, t_len, wa, ba, wb, bb, wc, bc, wp, bp)


@_op.register_fake
def _fake(x, t_len, wa, ba, wb, bb, wc, bc, wp, bp):
    return x.new_empty((*x.shape[:3], wc.shape[-1]))


@_op.register_kernel("cuda")
def _launch(x, t_len, wa, ba, wb, bb, wc, bc, wp, bp):
    _check(x, t_len, wa, ba, wb, bb, wc, bc, wp, bp, 1, 1, 1)
    n, h, w, cin = x.shape
    kt, _, ci = wa.shape
    cout = wc.shape[-1]
    elem = x.element_size()
    weights = [wa, wb, wc] + ([wp] if wp is not None else [])
    biases = [ba, bb, bc] + ([bp] if bp is not None else [])
    for t in [x] + weights + biases:
        if t.device != x.device:
            raise ValueError("fused_bottleneck: all tensors on one device")
        if not t.is_contiguous():
            raise ValueError("fused_bottleneck: tensors must be contiguous")
    for t in weights:
        if t.dtype != x.dtype:
            raise TypeError("fused_bottleneck: weights must have x's dtype")
    for t in biases:
        if t.dtype != torch.float32:
            raise TypeError("fused_bottleneck: biases must be float32")
    split = plan(n, h, w, cin, ci, cout, kt, elem, wp is not None)
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    lib = _lib()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr()) if t is not None else None
    with torch.cuda.device(x.device):  # the launch goes to the current device
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_bottleneck_launch(
            0 if x.dtype == torch.float32 else 1, ptr(x), ptr(wa), ptr(ba),
            ptr(wb), ptr(bb), ptr(wc), ptr(bc), ptr(wp), ptr(bp), ptr(out),
            n, t_len, h, w, cin, ci, cout, kt, split.rows, split.cluster,
            split.ring // 2, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"fused_bottleneck kernel launch failed: CUDA error {err} "
            f"(x {tuple(x.shape)} {x.dtype}, kt {kt}, {split})")
    fused_bottleneck.launches += 1
    return out


def flops(n, h, w, cin, ci, cout, kt, has_proj) -> int:
    """The block's multiply-adds times 2, as the plain version's products
    count them."""
    return 2 * n * h * w * (kt * cin * ci + 9 * ci * ci + ci * cout
                            + (cin * cout if has_proj else 0))


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_bottleneck")
    f = lib.fused_bottleneck_launch
    f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                  + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return lib
