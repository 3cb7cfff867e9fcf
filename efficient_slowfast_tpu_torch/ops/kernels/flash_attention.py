"""Flash attention, forward and backward: plain versions and CUDA kernels.

Port of ``efficient_slowfast_tpu/ops/pallas/flash_attention.py``. For
q (B, N, D), k (B, M, D) and v (B, M, C) it computes softmax(q kᵀ) v with
no scale on the logits: the softmax runs online in float32 over key blocks,
with a running max and sum, so the (N, M) matrix never exists; the division
is by max(row_sum, 1e-30) and the output has v's dtype.

``flash_attention`` is differentiable on every device, as the JAX
package's ``jax.custom_vjp`` is (``flash_attention.py:157-225``):

- Forward. On CUDA tensors it runs the hand-written kernel
  ``csrc/flash_attention.cu`` (one launch per call); on CPU tensors the
  plain version ``chunked_attention``. In bfloat16 the kernel computes both
  products on the tensor cores and rounds the probabilities to bfloat16
  once before the product with v (the row sums stay float32), as the JAX
  package's dense path does; in float32 it stays in float32 throughout.
  Where a gradient will be asked for, the forward also keeps each row's
  float32 log-sum-exp of its logits (``chunked_attention_lse`` on the CPU,
  the kernel's optional output on CUDA), in ``AttentionFunction``; the
  serving path (no grad, or ``inference_mode``) keeps none and launches
  the one kernel only.
- Backward. With D = rowsum(dO∘O) and P = exp(q kᵀ − lse):
  dV = Pᵀ dO, dS = P∘(dO vᵀ − D), dQ = dS k, dK = dSᵀ q. On CUDA tensors
  ``flash_attention_backward`` runs ``csrc/flash_attention_bwd.cu``
  (three launches per call); on CPU tensors ``attention_backward``, the
  same formulas chunked over the keys, so that its memory is O(N · chunk).
  In bfloat16 with D, C ≤ 128 the kernel makes one pass over the queries
  for each block of keys (``wgmma``, TMA loads by a producer warpgroup) and
  adds each block's part of dQ into a float32 accumulator, so **dQ is not
  deterministic** there (nor above 128: the wide widths below):
  the adds arrive in any order and dQ may differ in its last bits from call
  to call, while dK and dV are bit-identical.
  Inputs whose D or C is
  not a multiple of 8, or whose data is not 16-byte aligned, go to the
  kernel as zero-padded copies (``padded_backward``, exact), never to the
  plain version. In float32 the kernels are deterministic (no atomics).
  The JAX package's backward is the vjp of ``chunked_attention``
  (``flash_attention.py:219-222``), which keeps all N·M probabilities.
  Gradients come back in the inputs' dtypes. Both backwards take D from
  the output the forward returned (bf16 where the inputs are), as FA2 and
  SDPA do; autograd through ``chunked_attention`` takes it from the
  unrounded one.
- Wide widths. D or C above 128 (non-local blocks: 256 in s3, 512 in s4,
  1024 in a res5), any D and C. The bf16 forward runs the cluster kernel
  in its one launch, on the split that ``forward_split`` plans: the output
  columns of a tile of 128 queries go to column groups (one up to C =
  2048) of R blocks, each owning up to 256 columns of the output; where
  D is up to 256 and C up to 2048 each block computes the logits itself;
  else the blocks of a group form a thread block cluster whose first
  blocks own slices of D and add their partial logits over distributed
  shared memory in rank order, so each group computes q kᵀ once (at D = C
  = 1024, R = 4); q stays in shared memory up to D = 2048 and streams
  beside k beyond. ``wgmma`` products, TMA loads in the 128-byte swizzle;
  D and C reach it as multiples of 64, zero-padded copies where they are
  not (exact). The float32 forward keeps its wide kernel (a block per
  128-column slice of C, recomputing the logits). The bf16 backward above
  128 runs the backward's cluster kernel in its three launches (the
  statistics, the kernel, dQ), on the split that ``backward_split`` plans:
  a block owns 64 keys and two warpgroups, each owning 128 columns of D
  and of C (its dK and dV); R blocks (256 R ≥ D and ≥ C up to 2048; beyond,
  column groups of up to 8) form a thread block cluster that adds the
  partial logits q kᵀ and dO vᵀ over all of D and C in rank order over
  distributed shared memory, so each group computes them once and dV, dK
  and dQ are computed once; ``wgmma`` products, TMA loads. As at the
  narrow widths its dQ is added over key blocks by float32 bulk
  reduce-adds, so **bf16 dQ is not deterministic above 128 either**; dK
  and dV are bit-identical across calls. The float32 wide backward (a
  block per 128-column output slice, recomputing the logits) is
  deterministic.

``plain_attention`` is the same Function over the plain versions, on any
device: the explicit opt-out ``TPU.FLASH_ATTENTION False``.

The forward is the ``torch.library`` op ``esf_torch::flash_attention``
(q, k, v, with_lse) -> (out, lse), the kernel on CUDA and the plain
version on CPU, so a ``torch.export`` graph of the serving forward holds
it; without ``with_lse`` its lse is empty and the kernel writes none.
``AttentionFunction`` wraps it with the lse, which keeps the gradient.

``flash_attention`` never gives a CUDA tensor a plain version: what a
kernel does not take raises, and so does a failed build or launch. Unlike the Pallas path, the
kernels mask a key count that their tiles do not divide, and they take any
key count: the JAX package's ``TPU.FLASH_MAX_KEYS`` is a TPU compiler limit
and bounds nothing here.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

_NEG_INF = -1e30
# kernel launches of one flash_attention_backward call on CUDA
BACKWARD_LAUNCHES_PER_CALL = 3


def chunked_attention_lse(q, k, v, chunk: int = 512):
    """Plain PyTorch version: softmax(q kᵀ) v over key chunks, float32, and
    each row's log-sum-exp of its logits.

    q: (B, N, D), k: (B, M, D), v: (B, M, C) → ((B, N, C) in v's dtype,
    (B, N) float32). The last chunk is cut short where M is ragged, which
    is the JAX version's padding with logits masked to -1e30 (they
    contribute exp(-1e30 - max), which is 0).
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
    return out.to(v.dtype), row_max + torch.log(row_sum)


def chunked_attention(q, k, v, chunk: int = 512):
    """Plain PyTorch version of the forward: ``chunked_attention_lse``'s
    output alone. Differentiable by autograd, whose backward is the JAX
    package's (the vjp of its ``chunked_attention``)."""
    return chunked_attention_lse(q, k, v, chunk)[0]


def attention_backward(q, k, v, out, lse, dout, chunk: int = 512):
    """Plain PyTorch version of the backward: (dq, dk, dv) in the dtypes of
    q, k and v, from the forward's ``out`` and float32 ``lse`` (B, N) and
    the output's gradient ``dout`` (B, N, C).

    Float32 throughout, chunked over the keys: each chunk's probabilities
    P = exp(q kᵀ − lse) are recomputed and dropped, so the memory is
    O(B · N · chunk) however long M is."""
    qf, dof = q.float(), dout.float()
    delta = (dof * out.float()).sum(-1)  # D = rowsum(dO ∘ O), (B, N)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for s in range(0, k.shape[1], chunk):
        kb = k[:, s:s + chunk].float()
        vb = v[:, s:s + chunk].float()
        p = torch.exp(torch.bmm(qf, kb.transpose(1, 2)) - lse[..., None])
        dvs.append(torch.bmm(p.transpose(1, 2), dof))
        ds = p * (torch.bmm(dof, vb.transpose(1, 2)) - delta[..., None])
        dq += torch.bmm(ds, kb)
        dks.append(torch.bmm(ds.transpose(1, 2), qf))
    return (dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


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
    if any(size == 0 for size in (b, n, m, d, c)):
        raise ValueError("flash_attention: empty input")
    for t in (q, k, v):
        if t.dtype != q.dtype:
            raise TypeError("flash_attention: q, k and v must share a dtype")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: {q.dtype}; float32 or bfloat16 "
                        "only")


def _check_cuda(tensors):
    """The kernels take contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError("flash_attention: all tensors on one device")
        if not t.is_contiguous():
            raise ValueError("flash_attention: tensors must be contiguous")
    if tensors[0].shape[0] > 65535:
        raise ValueError(f"flash_attention: batch {tensors[0].shape[0]} > "
                         "65535")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _forward(q, k, v, with_lse: bool):
    """(out, lse or None): the kernel on CUDA, the plain version on CPU."""
    out, lse = _op(q, k, v, with_lse)
    return out, (lse if with_lse else None)


@torch.library.custom_op("esf_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    out, lse = chunked_attention_lse(q, k, v)
    return out, (lse if with_lse else lse.new_empty(0))


@_op.register_kernel("cuda")
def _op_cuda(q, k, v, with_lse):
    out, lse = _launch_forward(q, k, v, with_lse)
    return out, (lse if with_lse else q.new_empty(0, dtype=torch.float32))


@_op.register_fake
def _op_fake(q, k, v, with_lse):
    return (v.new_empty((q.shape[0], q.shape[1], v.shape[2])),
            q.new_empty((q.shape[0], q.shape[1]) if with_lse else (0,),
                        dtype=torch.float32))


def flops(b, n, m, d, c) -> int:
    """2 · B · N · M · (D + C): the two products, as the plain version's
    count them."""
    return 2 * b * n * m * (d + c)


# The bf16 cluster kernel of D or C above 128 (csrc/flash_attention.cu,
# cluster_smem_bytes): query rows of a tile, the largest output slice of a
# block, the shared memory of a block and its mbarriers, the ring stages
# tried (k, v), most first: a tile's stages are refilled after its
# products, so a ring needs two, and where the exchange is deferred (q
# resident, the slots of one round: S then runs two tiles ahead) k's needs
# three; where q streams beside k a stage holds 80 KB, and two each fit.
_CLUSTER_ROWS = 128
# keys of a tile: 64, or 32 where the blocks exchange partial logits (the
# slots and the rings then fit shared memory)
_CLUSTER_KEYS = 64
_EXCHANGE_KEYS = 32
# D and C reach the kernel as multiples of its 64-column atoms (the 128-byte
# swizzle), zero-padded where they are not
_CLUSTER_ATOM = 64
_CLUSTER_MAX_COLS = 256
_SMEM_LIMIT = 232448
_BARRIER_BYTES = 256
_STAGES = ((3, 3), (3, 2), (2, 2))
_DEFERRED_STAGES = ((3, 3), (3, 2))
_STREAM_STAGES = ((2, 2),)
# the blocks of a column group (one cluster: its portable size)
_MAX_CLUSTER = 8
# columns of D in a block's logits (the kernel's kClDSlice: four atoms,
# whose k steps its wgmma chain takes unrolled)
_D_SLICE = 256
_SPLIT_FIELDS = ("cluster", "exchange", "pushers", "groups", "slices",
                 "c_slice", "width", "keys", "k_stages", "v_stages", "rounds",
                 "smem")


def _ceil(x, to):
    return -(-x // to) * to


def cluster_smem_bytes(mode, width, keys, k_stages, v_stages, pushers=1,
                       rounds=1) -> int:
    """Shared memory of one block of the cluster kernel in ``mode`` (0 one
    block a query tile, 1 a cluster with q resident, 2 a cluster with q
    streamed): q (128 x 256 bf16, modes 0 and 1), the k stages (keys x 256,
    beside a 128 x 256 slice of q in mode 2), the v stages (keys x width),
    where the blocks exchange a float32 slot of 128 x keys partial logits
    for each pusher over the ``rounds`` of a tile's exchange, the
    mbarriers, and 1024 bytes to align the tiles (the 128-byte swizzle):
    the kernel's own arithmetic."""
    q = 0 if mode == 2 else _CLUSTER_ROWS * _D_SLICE
    stage = (_CLUSTER_ROWS + keys if mode == 2 else keys) * _D_SLICE
    slots = (pushers * _CLUSTER_ROWS * _EXCHANGE_KEYS * 4 // rounds
             if mode else 0)
    return (2 * (q + k_stages * stage + v_stages * keys * width) + slots
            + _BARRIER_BYTES + 1024)


def forward_split(b, n, m, d, c) -> dict:
    """The bf16 cluster kernel's split of one call with D or C above 128,
    D and C rounded up to multiples of 64 as the kernel takes them (the
    wrapper pads them with zero columns). Every D and C has one.

    A tile of ``rows`` queries belongs to ``groups`` (G = ceil(C / 2048))
    column groups of ``cluster`` (R) blocks, block r of group g owning the
    output columns [(g R + r) c_slice, (g R + r + 1) c_slice) (c_slice up
    to 256: a block's float32 accumulator). Where D and C are up to 256
    and 2048 (one slice of D, one group) each block computes the logits
    itself and the blocks are no cluster (``exchange`` False; ``recompute``
    R: on the card that is faster than one block's broadcast). Else the R
    blocks of a group are one thread block cluster whose first ``pushers``
    (P) each own ``slices`` 256-column slices of D and add their partial
    logits in rank order over distributed shared memory, so a group
    computes q kᵀ once: ``recompute``, the times a call computes it, is
    then G (1 up to C = 2048), and ``padded`` the columns it multiplies
    over D's (the slices' zero columns). Up to D = 2048 a pusher owns one
    slice, whose q stays in shared memory (``stream`` False); beyond,
    several, whose q streams beside k: at the fewest ``rounds`` of a
    tile's exchange (one, deferred, or two halves), the fewest slices a
    pusher whose slots fit. ``keys`` a tile (32 where the blocks exchange,
    so that the slots and the rings fit, else 64), ``k_stages`` and
    ``v_stages`` the rings, ``smem`` a block's bytes, ``width`` the
    accumulator's columns (64, 128 or 256), ``blocks`` the grid. Raises
    ValueError for a width below 1, which no kernel holds."""
    plan = _forward_plan(d, c)
    return dict(plan, blocks=plan["blocks"] * -(-n // _CLUSTER_ROWS) * b)


@functools.lru_cache(maxsize=None)
def _forward_plan(d, c) -> dict:
    """forward_split's plan of widths D, C; its ``blocks`` those of one
    query tile of one clip (the wrapper asks once a width, not once a
    call)."""
    if d < 1 or c < 1:
        raise ValueError(f"flash_attention: no bf16 kernel split for D {d}, "
                         f"C {c}")
    d_in = d
    d, c = _ceil(d, _CLUSTER_ATOM), _ceil(c, _CLUSTER_ATOM)
    groups = -(-c // (_MAX_CLUSTER * _CLUSTER_MAX_COLS))
    d_slices = -(-d // _D_SLICE)
    stream = d_slices > _MAX_CLUSTER
    # one slice of D and one column group: each of R blocks computes the
    # logits itself, no cluster (faster on the card than one block's
    # broadcast at (64, 2048), PERF.md)
    alone = d_slices == 1 and groups == 1
    need = max(-(-d_slices // _MAX_CLUSTER), 1)
    for rounds, slices in itertools.product(
            (1, 2), range(need, d_slices + 1) if stream else (1,)):
        pushers = -(-d_slices // slices)
        cluster = 1
        while cluster < max(pushers, -(-c // (_CLUSTER_MAX_COLS
                                               * groups))):
            cluster *= 2
        exchange = cluster > 1 and not alone
        if alone:
            pushers = cluster
        c_slice = _ceil(-(-c // (groups * cluster)), _CLUSTER_ATOM)
        width = next(w for w in (64, 128, _CLUSTER_MAX_COLS)
                     if c_slice <= w)
        mode = 0 if not exchange else 2 if stream else 1
        keys = _EXCHANGE_KEYS if mode else _CLUSTER_KEYS
        stages = (_STREAM_STAGES if stream else _DEFERRED_STAGES
                  if mode and rounds == 1 else _STAGES)
        for k_stages, v_stages in stages:
            smem = cluster_smem_bytes(mode, width, keys, k_stages,
                                      v_stages, pushers, rounds)
            if smem <= _SMEM_LIMIT:
                return dict(
                    cluster=cluster, exchange=exchange, pushers=pushers,
                    groups=groups, slices=slices, stream=stream,
                    d_slice=_D_SLICE, c_slice=c_slice, width=width,
                    k_stages=k_stages, v_stages=v_stages, rounds=rounds,
                    smem=smem, rows=_CLUSTER_ROWS, keys=keys,
                    blocks=groups * cluster,
                    recompute=cluster if alone else groups,
                    padded=slices * _D_SLICE / d_in * (
                        1 if alone else pushers))
    raise AssertionError(f"forward_split: no split fits D {d}, C {c}")


def _pad(t, width, multiple=8):
    """A fresh contiguous copy of ``t`` whose last dimension is ``width``
    rounded up to ``multiple``, holding ``t`` in its first ``width``
    columns and zeros after them (one op: the padded calls' host time)."""
    extra = _ceil(width, multiple) - width
    return F.pad(t, (0, extra)) if extra else t.clone(
        memory_format=torch.contiguous_format)


def _launch_forward(q, k, v, with_lse: bool):
    _check(q, k, v)
    _check_cuda((q, k, v))
    b, n, d = q.shape
    m, c = v.shape[1], v.shape[2]
    # bf16 above 128: the cluster kernel, at any width
    cluster = q.dtype == torch.bfloat16 and (d > 128 or c > 128)
    if cluster and not _tma_ready((q, k, v), _CLUSTER_ATOM):
        # exact: zero columns of q and k leave the logits, and zero columns
        # of v the first C columns of the output, unchanged
        out, lse = _launch_forward(
            _pad(q, d, _CLUSTER_ATOM), _pad(k, d, _CLUSTER_ATOM),
            _pad(v, c, _CLUSTER_ATOM), with_lse)
        return out[..., :c].contiguous(), lse
    out = torch.empty((b, n, c), dtype=v.dtype, device=v.device)
    lse = (torch.empty((b, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _lib()
    lse_ptr = None if lse is None else _ptr(lse)
    with torch.cuda.device(q.device):  # the launch goes to the current device
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if cluster:
            split = forward_split(b, n, m, d, c)
            plan = (ctypes.c_int * len(_SPLIT_FIELDS))(
                *(int(split[f]) for f in _SPLIT_FIELDS))
            err = lib.flash_attention_cluster_launch(
                _ptr(q), _ptr(k), _ptr(v), _ptr(out), lse_ptr, b, n, m, d, c,
                plan, stream)
        else:
            err = lib.flash_attention_launch(
                0 if q.dtype == torch.float32 else 1, _ptr(q), _ptr(k),
                _ptr(v), _ptr(out), lse_ptr, b, n, m, d, c, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} (q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"{q.dtype})")
    flash_attention.launches += 1
    return out, lse


def padded_backward(backward, q, k, v, out, lse, dout):
    """``backward(q, k, v, out, lse, dout)`` on fresh contiguous copies of
    q, k, v, out and dout whose D and C are zero-padded to a multiple of 8,
    with the gradients cut back to D and C.

    Exact: zero columns of q and k leave the logits q kᵀ unchanged, and zero
    columns of v, out and dout leave D = rowsum(dO∘O) and dO vᵀ unchanged,
    so every gradient's first D (or C) columns are the unpadded ones."""
    d, c = q.shape[-1], v.shape[-1]
    dq, dk, dv = backward(_pad(q, d), _pad(k, d), _pad(v, c), _pad(out, c),
                          lse, _pad(dout, c))
    return (dq[..., :d].contiguous(), dk[..., :d].contiguous(),
            dv[..., :c].contiguous())


def _tma_ready(tensors, multiple=8) -> bool:
    """The bf16 kernels' TMA loads take widths that are multiples of 8 (the
    forward's cluster kernel: of 64) and 16-byte aligned data."""
    return all(t.shape[-1] % multiple == 0 and t.data_ptr() % 16 == 0
               for t in tensors)


def _launch_backward(q, k, v, out, lse, dout):
    b, n, d = q.shape
    m, c = v.shape[1], v.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dtype = 0 if q.dtype == torch.float32 else 1
    lib = _bwd_lib()
    # bf16 above 128: the cluster kernel on backward_split's plan, at any
    # width
    cluster = dtype == 1 and (d > 128 or c > 128)
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if cluster:
            split = backward_split(b, n, m, d, c)
            workspace = torch.empty(
                lib.flash_attention_backward_cluster_workspace(
                    b, n, split["cluster"], split["groups"],
                    split["queries"]),
                dtype=torch.uint8, device=q.device)
            plan = (ctypes.c_int * len(_BWD_PLAN_FIELDS))(
                *(int(split[f]) for f in _BWD_PLAN_FIELDS))
            err = lib.flash_attention_backward_cluster_launch(
                _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(dout), _ptr(lse),
                _ptr(dq), _ptr(dk), _ptr(dv), _ptr(workspace), b, n, m, d, c,
                plan, stream)
        else:
            workspace = torch.empty(
                lib.flash_attention_backward_workspace(dtype, b, n, d, c),
                dtype=torch.uint8, device=q.device)
            err = lib.flash_attention_backward_launch(
                dtype, _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(dout),
                _ptr(lse), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(workspace), b,
                n, m, d, c, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention backward kernel launch failed: CUDA error "
            f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, {q.dtype})")
    flash_attention_backward.launches += BACKWARD_LAUNCHES_PER_CALL
    return dq, dk, dv


def flash_attention_backward(q, k, v, out, lse, dout):
    """(dq, dk, dv) of ``flash_attention`` for the output gradient
    ``dout``, from its ``out`` and float32 ``lse`` (B, N).

    On CUDA tensors it launches the backward kernels (three launches); on
    CPU tensors it runs ``attention_backward``. In bfloat16 on CUDA, at
    any width (the one-pass kernel to 128, the cluster kernel above), dq
    is summed over key blocks by float32 bulk reduce-adds and may differ
    in its last bits from call to call; dk and dv are deterministic. In
    float32 all three are deterministic."""
    _check(q, k, v)
    b, n, _ = q.shape
    c = v.shape[2]
    if out.shape != (b, n, c) or dout.shape != (b, n, c) or \
            lse.shape != (b, n):
        raise ValueError("flash_attention_backward: out and dout must be "
                         f"{(b, n, c)} and lse {(b, n)}; got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype or \
            lse.dtype != torch.float32:
        raise TypeError("flash_attention_backward: out and dout in q's "
                        "dtype, lse float32")
    if q.device.type == "cpu":
        return attention_backward(q, k, v, out, lse, dout)
    _check_cuda((q, k, v, out, lse, dout))
    if q.dtype == torch.bfloat16 and not _tma_ready((q, k, v, out, dout)):
        return padded_backward(_launch_backward, q, k, v, out, lse, dout)
    return _launch_backward(q, k, v, out, lse, dout)


# The bf16 backward's cluster kernel (csrc/flash_attention_bwd.cu,
# cl_smem_bytes): keys a block, columns of D and of C a consumer warpgroup
# owns (two a block), the most blocks a cluster, query tiles (32, or 16
# where the slots of a cluster would not fit), ring stages (three where
# they fit, else two), extra stages where G > 1, rounds of a tile's
# exchange (S and dP at once, or S then dP where the slots of one would
# not fit); a stage holds the statistics (256 bytes), q and dO (the
# block's 256 columns, bf16), an extra stage a slice of k or v (64 x 256)
# and of q or dO (a tile's rows x 256)
_BWD_KEYS = 64
_BWD_SLICE = 128
_BWD_BLOCK_COLS = 2 * _BWD_SLICE
_BWD_MAX_CLUSTER = 8
_BWD_ROWS = (32, 16)
_BWD_STAGES = (3, 2)
_BWD_EXTRA_STAGES = 2
_BWD_PLAN_FIELDS = ("cluster", "groups", "queries", "stages", "extra_stages",
                    "rounds", "smem")


def backward_cluster_smem_bytes(cluster, rows, stages, extra_stages=0,
                                rounds=1) -> int:
    """Shared memory of one block of the backward's cluster kernel: k and
    v (64 keys x 256 columns, bf16), ``stages`` stages of the statistics
    (256 bytes), q and dO (``rows`` queries x 256 columns, bf16),
    ``extra_stages`` of a slice of k or v and of q or dO, dS (rows x 64,
    bf16), a float32 slot of the partial Sᵀ and dPᵀ (64 x rows each) for
    each block of the cluster over the ``rounds``, and 256 bytes of
    mbarriers: the kernel's own arithmetic."""
    kv = 2 * _BWD_KEYS * _BWD_BLOCK_COLS
    stage = 256 + 4 * rows * _BWD_BLOCK_COLS
    extra = kv + 2 * rows * _BWD_BLOCK_COLS
    return (2 * kv + stages * stage + extra_stages * extra
            + 2 * _BWD_KEYS * rows + cluster * 512 * rows // rounds
            + _BARRIER_BYTES)


def backward_cluster_split(b, n, m, d, c) -> dict:
    """The bf16 backward's cluster kernel's split of one call with D or C
    above 128, D and C rounded up to multiples of 8 as the wrapper pads
    them. Every D and C has one.

    The 256-column slices of D and C (S of them, the more of the two) go
    to ``groups`` (G) column groups of ``cluster`` (R) blocks over each 64
    ``keys`` of a clip: up to 2048 G = 1 and R the least power of two with
    256 R ≥ D and ≥ C, beyond G = ceil(S / 8) and R = ceil(S / G). Block r
    of group g owns slice g R + r, its two warpgroups 128 columns of D and
    of C each (``slices`` = 2 R G of them, ``width`` 256 a block); the R
    blocks of a group add their partial logits and dO vᵀ over all of D and
    C in rank order over distributed shared memory, block r computing
    them over slices r + R j (those j ≠ g stream through its extra ring).
    ``queries`` a tile (32, or 16 where the slots would not fit),
    ``stages`` of its ring (three where they fit, else two),
    ``extra_stages`` (two where G > 1), ``rounds`` of a tile's exchange
    (the fewest whose slots fit), ``smem`` a block's bytes, ``blocks`` the
    grid (``per_sm`` 1), ``logits`` the times the two logits products run
    (G), ``recompute`` the tensor-core work over the bound's, columns past
    D and C included (1.0 where they are multiples of 256 R G). The launch
    entry checks the plan against its own arithmetic and refuses another.
    Raises ValueError for a width below 1, which no kernel holds."""
    plan = _backward_plan(d, c)
    return dict(plan, blocks=plan["blocks"] * -(-m // _BWD_KEYS) * b)


@functools.lru_cache(maxsize=None)
def _backward_plan(d, c) -> dict:
    """backward_cluster_split's plan of widths D, C; its ``blocks`` those
    of one key block of one clip."""
    if d < 1 or c < 1:
        raise ValueError(f"flash_attention_backward: no bf16 cluster split "
                         f"for D {d}, C {c}")
    d, c = _ceil(d, 8), _ceil(c, 8)
    s_d, s_c = -(-d // _BWD_BLOCK_COLS), -(-c // _BWD_BLOCK_COLS)
    slices = max(s_d, s_c)
    if slices <= _BWD_MAX_CLUSTER:
        groups = 1
        cluster = next(r for r in (1, 2, 4, _BWD_MAX_CLUSTER)
                       if r >= slices)
    else:
        groups = -(-slices // _BWD_MAX_CLUSTER)
        cluster = -(-slices // groups)
    extra_stages = _BWD_EXTRA_STAGES if groups > 1 else 0
    # the logits' work in 256-column slices: each block its own slice
    # (zeros past D or C), and its extra slices r + R j, j != g, below D's
    # (C's) count
    extra = sum(1 for g in range(groups) for r in range(cluster)
                for j in range(groups) for count in (s_d, s_c)
                if j != g and r + cluster * j < count)
    for rounds in (1, 2):
        for rows in _BWD_ROWS:
            for stages in _BWD_STAGES:
                smem = backward_cluster_smem_bytes(cluster, rows, stages,
                                                   extra_stages, rounds)
                if smem <= _SMEM_LIMIT:
                    return dict(
                        kernel="cluster", cluster=cluster, groups=groups,
                        keys=_BWD_KEYS, queries=rows, stages=stages,
                        extra_stages=extra_stages, rounds=rounds, smem=smem,
                        width=_BWD_BLOCK_COLS, slices=2 * cluster * groups,
                        per_sm=1,
                        blocks=groups * cluster,
                        logits=groups,
                        recompute=(5 * groups * cluster + extra)
                        * _BWD_BLOCK_COLS / (3 * d + 2 * c))
    raise AssertionError(f"backward_cluster_split: no split fits D {d}, C "
                         f"{c}")


def backward_split(b, n, m, d, c) -> dict:
    """The bf16 backward kernel's split of one call (``kernel`` names it):
    D and C up to 128, the one-pass kernel's from the C library (keys a
    block, queries a tile, ring stages, blocks, shared memory bytes, the
    padded width, the blocks resident on an SM); above,
    ``backward_cluster_split``."""
    d8, c8 = _ceil(d, 8), _ceil(c, 8)
    if max(d8, c8) > 128:
        return backward_cluster_split(b, n, m, d8, c8)
    split = (ctypes.c_int * 8)()
    _bwd_lib().flash_attention_backward_plan(b, m, d8, c8, split)
    plan = dict(zip(("keys", "queries", "stages", "blocks", "smem", "width",
                     "per_sm", "slices"), split))
    return dict(plan, cluster=1, kernel="one-pass")


flash_attention_backward.launches = 0


class AttentionFunction(torch.autograd.Function):
    """softmax(q kᵀ) v with the log-sum-exp kept for the backward: the
    kernels' wrappers, or with ``plain`` the plain versions on any device
    (``chunked_attention_lse``, ``attention_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, plain):
        out, lse = (chunked_attention_lse(q, k, v) if plain
                    else _forward(q, k, v, with_lse=True))
        ctx.plain = plain
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        backward = (attention_backward if ctx.plain
                    else flash_attention_backward)
        grads = backward(q, k, v, out, lse, dout.contiguous())
        return (*grads, None)


def _records(q, k, v) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))


def flash_attention(q, k, v):
    """softmax(q kᵀ) v. q: (B, N, D), k: (B, M, D), v: (B, M, C), any D
    and C, float32 or bfloat16. Returns (B, N, C) in v's dtype.

    On a CUDA tensor it launches the kernel; on a CPU tensor it runs
    ``chunked_attention``. Where autograd records (grad enabled and an
    input that requires it) the output's ``grad_fn`` is
    ``AttentionFunction``'s, whose backward is ``flash_attention_backward``.
    """
    _check(q, k, v)
    if _records(q, k, v):
        return AttentionFunction.apply(q, k, v, False)
    return _forward(q, k, v, with_lse=False)[0]


flash_attention.launches = 0


def plain_attention(q, k, v):
    """The plain versions, forward and backward, on any device: the
    explicit opt-out from the kernels (``TPU.FLASH_ATTENTION False``). Its
    backward is ``attention_backward``, whose memory is O(N · chunk) where
    autograd through ``chunked_attention`` would keep all N·M
    probabilities; without autograd it is ``chunked_attention``."""
    _check(q, k, v)
    if _records(q, k, v):
        return AttentionFunction.apply(q, k, v, True)
    return chunked_attention(q, k, v)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if getattr(lib, "_esf_typed", False):  # typed once a library
        return lib
    f = lib.flash_attention_launch
    f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    f = lib.flash_attention_cluster_launch
    f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p] * 2)
    f.restype = ctypes.c_int
    f = lib.flash_attention_cluster_smem
    f.argtypes = [ctypes.c_int] * 7
    f.restype = ctypes.c_size_t
    f = lib.flash_attention_cluster_smem_attr
    f.argtypes = [ctypes.c_int] * 2
    f.restype = ctypes.c_int
    lib._esf_typed = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    if getattr(lib, "_esf_typed", False):
        return lib
    f = lib.flash_attention_backward_launch
    f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    f = lib.flash_attention_backward_workspace
    f.argtypes = [ctypes.c_int] * 5
    f.restype = ctypes.c_longlong
    f = lib.flash_attention_backward_plan
    f.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    f.restype = None
    f = lib.flash_attention_backward_cluster_launch
    f.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p] * 2)
    f.restype = ctypes.c_int
    f = lib.flash_attention_backward_cluster_workspace
    f.argtypes = [ctypes.c_int] * 5
    f.restype = ctypes.c_longlong
    f = lib.flash_attention_backward_cluster_smem
    f.argtypes = [ctypes.c_int] * 5
    f.restype = ctypes.c_int
    f = lib.flash_attention_backward_cluster_smem_attr
    f.argtypes = [ctypes.c_int] * 2
    f.restype = ctypes.c_int
    lib._esf_typed = True
    return lib
