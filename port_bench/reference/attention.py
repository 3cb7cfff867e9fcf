"""softmax(q kᵀ) v in float32, in blocks of queries, forward and backward.

The logits are unscaled, as the CMDA fusion's SpatialAttention writes
them. A whole logit matrix is 4.3 GB a clip at 32768 tokens, so neither
pass holds it: the forward keeps each row's log-sum-exp, and the backward
recomputes each block's probabilities from it. ``dense`` is the same
product through autograd, for shapes on the meta device, where the
operations are counted and nothing is allocated.
"""

from __future__ import annotations

import torch

# float32 elements of one block's logits: 1 GiB
_BLOCK_ELEMENTS = 1 << 28


def _rows(b: int, m: int) -> int:
    return max(16, min(4096, _BLOCK_ELEMENTS // max(b * m, 1)))


class BlockedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        b, n, _ = q.shape
        rows = _rows(b, k.shape[1])
        out = q.new_empty((b, n, v.shape[2]))
        lse = q.new_empty((b, n))
        kt = k.transpose(1, 2)
        for i in range(0, n, rows):
            s = torch.bmm(q[:, i:i + rows], kt)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            total = p.sum(-1, keepdim=True)
            out[:, i:i + rows] = torch.bmm(p, v) / total
            lse[:, i:i + rows] = (m + total.log()).squeeze(-1)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        b, n, _ = q.shape
        rows = _rows(b, k.shape[1])
        dout = dout.contiguous()
        delta = (dout * out).sum(-1, keepdim=True)
        dq = torch.empty_like(q)
        dk = torch.zeros_like(k)
        dv = torch.zeros_like(v)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        for i in range(0, n, rows):
            blk = slice(i, i + rows)
            p = torch.exp(torch.bmm(q[:, blk], kt) - lse[:, blk, None])
            do = dout[:, blk]
            dv += torch.bmm(p.transpose(1, 2), do)
            ds = p * (torch.bmm(do, vt) - delta[:, blk])
            dq[:, blk] = torch.bmm(ds, k)
            dk += torch.bmm(ds.transpose(1, 2), q[:, blk])
        return dq, dk, dv


def blocked(q, k, v):
    return BlockedAttention.apply(q, k, v)


def dense(q, k, v):
    return torch.softmax(q @ k.transpose(1, 2), dim=-1) @ v
