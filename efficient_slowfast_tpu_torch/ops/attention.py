"""Attention modules of the CMDA fusion (port of ``ops/attention.py:26-86``).

Reference behaviour: slowfast/models/wdf_attention_helper.py
  - SpatialAttention (:13-54) — SAGAN/DANet QKV over the T·H·W tokens with a
    learned γ residual.
  - ECA (:57-91) — global average → Conv1d(k) over the channels → σ gate.

Both take NCDHW tensors in ``channels_last_3d`` memory, so the (B, N, C)
token view of an activation costs no copy. ChannelAttention, the non-local
blocks and ContextBlock3D come with a later slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .conv import Conv3d
from .kernels.flash_attention import flash_attention, plain_attention


class SpatialAttention(nn.Module):
    """Full spatio-temporal self-attention, ``gamma * attn(x) + x``.

    Tokens are ordered (T, H, W) as in the JAX package's reshape; the logits
    are unscaled and the softmax runs over the keys. Above
    ``flash_min_tokens`` tokens the streaming path runs: ``flash_attention``
    (the CUDA kernels on a CUDA tensor, forward and backward) when
    ``use_flash``, else ``plain_attention`` (the plain versions, forward
    and backward), an explicit opt-out as ``TPU.FLASH_ATTENTION False`` is
    in JAX. At or below it the dense path runs, as JAX writes it:
    f32 logits and softmax, the probabilities cast to v's dtype before the
    product with v.

    The JAX package's ``TPU.FLASH_MAX_KEYS`` (25088) bounds the Pallas
    kernel because the TPU compiler fails at 32768 keys (v5e); the CUDA
    kernel has no such limit and the port does not apply it. At the 256²
    test crop two fusions have 32768 keys: bounding the kernel there would
    put the plain version on the serving path.
    """

    def __init__(self, dim: int, reduction: int = 8, use_flash: bool = True,
                 flash_min_tokens: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = dim // reduction
        self.use_flash = use_flash
        self.flash_min_tokens = flash_min_tokens
        self.query_conv = Conv3d(dim, inner, 1, bias=True, dtype=dtype)
        self.key_conv = Conv3d(dim, inner, 1, bias=True, dtype=dtype)
        self.value_conv = Conv3d(dim, dim, 1, bias=True, dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        n = t * h * w

        def tokens(y):  # NCDHW → (B, N, C'), a view when channels-last
            return y.permute(0, 2, 3, 4, 1).reshape(b, n, -1)

        q = tokens(self.query_conv(x))
        k = tokens(self.key_conv(x))
        v = tokens(self.value_conv(x))
        if n > self.flash_min_tokens:
            attend = flash_attention if self.use_flash else plain_attention
            out = attend(q, k, v)
        else:
            logits = torch.matmul(q.float(), k.float().transpose(1, 2))
            attn = F.softmax(logits, dim=-1).to(v.dtype)
            out = torch.matmul(attn.float(), v.float())
        out = out.to(x.dtype).reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
        return self.gamma.to(x.dtype) * out + x


class ECA(nn.Module):
    """Efficient Channel Attention: a Conv1d over the channel profile gates
    the channels (f32 mean over (T, H, W), f32 conv, sigmoid)."""

    def __init__(self, k_size: int = 3):
        super().__init__()
        self.conv = nn.Conv1d(1, 1, k_size, padding=(k_size - 1) // 2,
                              bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float().mean(dim=(2, 3, 4))               # (B, C)
        y = self.conv(y[:, None, :])[:, 0]              # conv over C
        gate = torch.sigmoid(y).to(x.dtype)
        return x * gate[:, :, None, None, None]
