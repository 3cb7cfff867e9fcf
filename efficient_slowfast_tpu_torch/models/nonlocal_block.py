"""Non-local block (port of ``models/nonlocal_block.py:19-78``; reference:
slowfast/models/nonlocal_helper.py:10-148).

Takes an NCDHW tensor in ``channels_last_3d`` memory, so the (B, N, C')
token view of each projection is the same memory. θ, φ and g are 1x1x1
convs to ``dim_inner`` channels (φ and g after a max pool of ``pool_size``
with floor windows); the affinity of the N = T·H·W queries with the pooled
keys aggregates g; a 1x1x1 conv back to C and a norm (γ zero-initialised)
are added to the input, with no ReLU. The three branches are the JAX
package's, rounding where it rounds:

- ``softmax`` above ``flash_min_tokens`` queries: ``θ · dim_inner^-½``
  multiplied in θ's dtype (the scale rounded to it, as JAX's weakly typed
  scalar is), then ``flash_attention`` (the CUDA kernels on a CUDA tensor,
  forward and backward) or, with ``use_flash`` off, ``plain_attention``.
  In s3 of I3D-NLN-R50 that is D = C = 256 over 3136 queries at 224²;
  in the slow res5 of AVA's SlowFast-R50 (stride 1), D = C = 1024 over
  1568 (the forward's and the backward's cluster kernels: every width
  runs on a kernel).
- ``softmax`` at or below it: float32 logits, then the scale, the softmax,
  and the product with g in g's dtype, accumulated in float32.
- ``dot_product``: θ (φᵀ g) / M by associativity, the (D, D) product in
  float32 rounded to θ's dtype before the second.

Under ``TPU.SPATIAL_SHARD`` the queries are the rank's band's and φ and g
the space group's (``spatial.gather_tokens``); the branch is chosen by the
whole frame's query count.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Conv3d
from ..parallel import spatial
from ..ops.kernels.flash_attention import flash_attention, plain_attention
from ..ops.norm import BatchNorm3d
from ..ops.pool import max_pool3d


def scaled_queries(theta: torch.Tensor, dim_inner: int) -> torch.Tensor:
    """θ · dim_inner^-½ in θ's dtype, the scale rounded to that dtype first
    (JAX's ``theta * scale`` with a weakly typed scalar): in bfloat16,
    512^-½ is not a power of two and rounds."""
    return theta * torch.tensor(dim_inner ** -0.5, dtype=theta.dtype,
                                device=theta.device)


class Nonlocal(nn.Module):
    def __init__(self, dim: int, dim_inner: int,
                 pool_size: Optional[Sequence[int]] = None,
                 instantiation: str = "softmax",
                 zero_init_final_norm: bool = True,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 use_flash: bool = True, flash_min_tokens: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if instantiation not in ("softmax", "dot_product"):
            raise NotImplementedError(instantiation)
        self.dim_inner = dim_inner
        self.pool_size = (list(pool_size) if pool_size is not None
                          and any(s > 1 for s in pool_size) else None)
        self.instantiation = instantiation
        self.use_flash = use_flash
        self.flash_min_tokens = flash_min_tokens
        self.conv_theta = Conv3d(dim, dim_inner, 1, bias=True, dtype=dtype)
        self.conv_phi = Conv3d(dim, dim_inner, 1, bias=True, dtype=dtype)
        self.conv_g = Conv3d(dim, dim_inner, 1, bias=True, dtype=dtype)
        self.conv_out = Conv3d(dim_inner, dim, 1, bias=True, dtype=dtype)
        self.bn = norm(dim, zero_init_gamma=zero_init_final_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        identity = x

        def tokens(y):  # NCDHW → (B, N, C'), a view when channels-last
            return y.permute(0, 2, 3, 4, 1).reshape(b, -1, self.dim_inner)

        theta = tokens(self.conv_theta(x))
        n_q = spatial.global_count(theta, theta.shape[1])
        theta = spatial.plain(theta)
        if self.pool_size is not None:
            x = max_pool3d(x, self.pool_size, self.pool_size)
        # a split activation's keys and values are its space group's
        phi = spatial.gather_tokens(tokens(self.conv_phi(x)))
        g = spatial.gather_tokens(tokens(self.conv_g(x)))
        n_k = phi.shape[1]

        if self.instantiation == "dot_product":
            kv = torch.matmul(phi.float().transpose(1, 2), g.float())
            out = torch.matmul(theta.float(),
                               kv.to(theta.dtype).float()) / n_k
        elif n_q > self.flash_min_tokens:
            attend = flash_attention if self.use_flash else plain_attention
            out = attend(scaled_queries(theta, self.dim_inner),
                         phi.contiguous(), g.contiguous())
        else:
            logits = torch.matmul(theta.float(), phi.float().transpose(1, 2))
            aff = F.softmax(logits * self.dim_inner ** -0.5, dim=-1)
            out = torch.matmul(aff.to(g.dtype).float(), g.float())
        out = out.to(identity.dtype).reshape(b, t, h, w, self.dim_inner)
        out = self.conv_out(spatial.like(out.permute(0, 4, 1, 2, 3),
                                         identity))
        return identity + self.bn(out)
