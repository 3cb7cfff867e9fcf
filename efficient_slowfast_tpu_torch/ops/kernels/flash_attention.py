"""Flash attention: plain version and CUDA kernel.

Port of ``efficient_slowfast_tpu/ops/pallas/flash_attention.py``. For
q (B, N, D), k (B, M, D) and v (B, M, C) it computes softmax(q kᵀ) v with
no scale on the logits: the softmax runs online in float32 over key blocks,
with a running max and sum, so the (N, M) matrix never exists; the division
is by max(row_sum, 1e-30) and the output has v's dtype.

``flash_attention`` runs the hand-written kernel ``csrc/flash_attention.cu``
on CUDA tensors (one launch per call) and the plain version
``chunked_attention`` on CPU tensors. In bfloat16 the kernel computes both
products on the tensor cores and rounds the probabilities to bfloat16 once
before the product with v (the row sums stay float32), as the JAX package's
dense path does; in float32 it stays in float32 throughout. A CUDA tensor
never takes the plain version: what the kernel does not take raises. Unlike
the Pallas path, the kernel masks a key count that its tile does not
divide, and it takes any key count: the JAX package's
``TPU.FLASH_MAX_KEYS`` is a TPU compiler limit and bounds nothing here.

Forward only, as the port has no train step yet; in the JAX package the
gradient is the vjp of ``chunked_attention`` (``flash_attention.py:219-222``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_NEG_INF = -1e30
# widest D and C the kernel takes
MAX_DIM = 128


def chunked_attention(q, k, v, chunk: int = 512):
    """Plain PyTorch version: softmax(q kᵀ) v over key chunks, float32.

    q: (B, N, D), k: (B, M, D), v: (B, M, C) → (B, N, C) in v's dtype. The
    last chunk is cut short where M is ragged, which is the JAX version's
    padding with logits masked to -1e30 (they contribute exp(-1e30 - max),
    which is 0).
    """
    b, n, _ = q.shape
    m, c = v.shape[1], v.shape[2]
    qf = q.float()
    acc = torch.zeros((b, n, c), dtype=torch.float32, device=q.device)
    row_max = torch.full((b, n), _NEG_INF, dtype=torch.float32,
                         device=q.device)
    row_sum = torch.zeros((b, n), dtype=torch.float32, device=q.device)
    for s in range(0, m, chunk):
        kb = k[:, s:s + chunk].float()
        vb = v[:, s:s + chunk].float()
        logits = torch.bmm(qf, kb.transpose(1, 2))
        new_max = torch.maximum(row_max, logits.amax(-1))
        corr = torch.exp(row_max - new_max)
        p = torch.exp(logits - new_max[..., None])
        row_sum = row_sum * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.bmm(p, vb)
        row_max = new_max
    out = acc / torch.clamp(row_sum, min=1e-30)[..., None]
    return out.to(v.dtype)


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention: q, k and v must be (B, N, D), "
                         f"(B, M, D), (B, M, C); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, n, d = q.shape
    m, c = v.shape[1], v.shape[2]
    if k.shape != (b, m, d) or v.shape[0] != b:
        raise ValueError("flash_attention: mismatched shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if min(b, n, m, d, c) == 0:
        raise ValueError("flash_attention: empty input")
    if d > MAX_DIM or c > MAX_DIM:
        raise ValueError(f"flash_attention: D = {d} and C = {c} must be at "
                         f"most {MAX_DIM}")
    for t in (q, k, v):
        if t.dtype != q.dtype:
            raise TypeError("flash_attention: q, k and v must share a dtype")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: {q.dtype}; float32 or bfloat16 "
                        "only")


def flash_attention(q, k, v):
    """softmax(q kᵀ) v. q: (B, N, D), k: (B, M, D), v: (B, M, C), D and C
    at most 128, float32 or bfloat16. Returns (B, N, C) in v's dtype.

    On a CUDA tensor it launches the kernel; on a CPU tensor it runs
    ``chunked_attention``.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return chunked_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("flash_attention: q, k and v on one device")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash_attention: tensors must be contiguous")
    b, n, d = q.shape
    m, c = v.shape[1], v.shape[2]
    if b > 65535:
        raise ValueError(f"flash_attention: batch {b} > 65535")
    out = torch.empty((b, n, c), dtype=v.dtype, device=v.device)
    lib = _lib()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(q.device):  # the launch goes to the current device
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            0 if q.dtype == torch.float32 else 1, ptr(q), ptr(k), ptr(v),
            ptr(out), b, n, m, d, c, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} (q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"{q.dtype})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    f = lib.flash_attention_launch
    f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return lib
