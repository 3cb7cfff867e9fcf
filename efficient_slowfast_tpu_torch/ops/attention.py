"""Attention modules (port of ``ops/attention.py``).

Reference behaviour: slowfast/models/wdf_attention_helper.py
  - SpatialAttention (:13-54) — SAGAN/DANet QKV over the T·H·W tokens with a
    learned γ residual; the CMDA fusion's, where the flash kernels serve.
  - ECA (:57-91) — global average → Conv1d(k) over the channels → σ gate.
  - ChannelAttention, NonLocalBlock, StripeNonLocalBlock and ContextBlock3D
    (JAX ``ops/attention.py:89-264``): library blocks that no model of
    either package builds. Their (N, N) products are dense, as in JAX, and
    run no kernel.

All take NCDHW tensors in ``channels_last_3d`` memory, so the (B, N, C)
token view of an activation costs no copy. Their convs carry biases, as the
JAX package's ``Conv3d`` does by default; the submodules take the names the
weight bridge (``utils/weights.py``) gives the JAX ones (θ, φ and g become
``conv_theta``, ``conv_phi``, ``conv_g``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import spatial
from .conv import Conv3d
from .kernels.flash_attention import flash_attention, plain_attention
from .norm import BatchNorm3d
from .pool import max_pool3d


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

    Under ``TPU.SPATIAL_SHARD`` a rank's queries are its band's tokens and
    the keys and values are the space group's (``spatial.gather_tokens``;
    the softmax over the keys does not depend on their order), so the
    kernel runs N/S queries against all N keys; the path is chosen by the
    whole frame's token count, as in one process.
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

        q = spatial.plain(tokens(self.query_conv(x)))
        k = spatial.gather_tokens(tokens(self.key_conv(x)))
        v = spatial.gather_tokens(tokens(self.value_conv(x)))
        if spatial.global_count(x, n) > self.flash_min_tokens:
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
        y = spatial.mean(x.float(), (2, 3, 4))          # (B, C)
        y = self.conv(y[:, None, :])[:, 0]              # conv over C
        gate = torch.sigmoid(y).to(x.dtype)
        return x * gate[:, :, None, None, None]


def _tokens(y: torch.Tensor) -> torch.Tensor:
    """NCDHW → (B, T·H·W, C), a view when channels-last."""
    return y.permute(0, 2, 3, 4, 1).reshape(y.shape[0], -1, y.shape[1])


def _zero_conv(dim_in: int, dim_out: int, dtype: torch.dtype) -> Conv3d:
    """A 1x1x1 conv with zero weight and bias: its block starts as the
    identity."""
    conv = Conv3d(dim_in, dim_out, 1, bias=True, dtype=dtype)
    nn.init.zeros_(conv.weight)
    return conv


def _affinity(theta, phi, g, instance: str) -> torch.Tensor:
    """softmax(θ φᵀ) g, or (θ φᵀ / N) g with N the query count, the
    products accumulated in float32 and the affinity cast to g's dtype
    before the second."""
    f = torch.matmul(theta.float(), phi.float().transpose(1, 2))
    f = F.softmax(f, dim=-1) if instance == "soft" else f / f.shape[1]
    return torch.matmul(f.to(g.dtype).float(), g.float())


class ChannelAttention(nn.Module):
    """SE-style channel gate with an extra residual (x·g + x)."""

    def __init__(self, dim: int, reduction: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = dim // reduction if dim // reduction != 0 else 2
        self.down = Conv3d(dim, inner, 1, bias=True, dtype=dtype)
        self.up = Conv3d(inner, dim, 1, bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float().mean(dim=(2, 3, 4), keepdim=True).to(x.dtype)
        gate = torch.sigmoid(self.up(F.relu(self.down(y))))
        return x * gate + x


class NonLocalBlock(nn.Module):
    """Generic embedded-gaussian non-local block ("soft") or its dot-product
    form ("dot"), with a zero-init output BN (``bn_layer``) or a zero-init
    output conv."""

    def __init__(self, dim: int, inter_channels: int | None = None,
                 sub_sample: bool = False, bn_layer: bool = True,
                 instance: str = "soft", bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = inter_channels or max(dim // 2, 1)
        self.inner, self.sub_sample, self.instance = inner, sub_sample, instance
        self.conv_g = Conv3d(dim, inner, 1, bias=True, dtype=dtype)
        self.conv_theta = Conv3d(dim, inner, 1, bias=True, dtype=dtype)
        self.conv_phi = Conv3d(dim, inner, 1, bias=True, dtype=dtype)
        if bn_layer:
            self.w = Conv3d(inner, dim, 1, bias=True, dtype=dtype)
            self.w_bn = BatchNorm3d(dim, eps=bn_eps, momentum=bn_momentum,
                                    zero_init_gamma=True)
        else:
            self.w_zero = _zero_conv(inner, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        g, theta, phi = self.conv_g(x), self.conv_theta(x), self.conv_phi(x)
        if self.sub_sample:
            g = max_pool3d(g, (1, 2, 2))
            phi = max_pool3d(phi, (1, 2, 2))
        y = _affinity(_tokens(theta), _tokens(phi), _tokens(g), self.instance)
        y = y.to(x.dtype).reshape(b, t, h, w, self.inner).permute(0, 4, 1, 2, 3)
        if hasattr(self, "w_zero"):
            return self.w_zero(y) + x
        return self.w_bn(self.w(y)) + x


class StripeNonLocalBlock(nn.Module):
    """Non-local attention over the T·``stripe`` horizontal stripes of a
    clip, each described by its mean, max or both (``pool_type``) over its
    rows and width; each stripe's output is added back over its whole
    footprint."""

    def __init__(self, dim: int, stripe: int,
                 inter_channels: int | None = None, pool_type: str = "mean",
                 instance: str = "soft", bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pool_type not in ("mean", "max", "meanmax"):
            raise NotImplementedError(pool_type)
        inner = inter_channels or max(dim // 2, 1)
        dim_d = 2 * dim if pool_type == "meanmax" else dim
        self.stripe, self.inner = stripe, inner
        self.pool_type, self.instance = pool_type, instance
        self.conv_g = Conv3d(dim_d, inner, 1, bias=True, dtype=dtype)
        self.conv_theta = Conv3d(dim_d, inner, 1, bias=True, dtype=dtype)
        self.conv_phi = Conv3d(dim_d, inner, 1, bias=True, dtype=dtype)
        self.w = Conv3d(inner, dim, 1, bias=True, dtype=dtype)
        self.w_bn = BatchNorm3d(dim, eps=bn_eps, momentum=bn_momentum,
                                zero_init_gamma=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        if h % self.stripe:
            raise ValueError(f"height {h} is not a multiple of the "
                             f"{self.stripe} stripes")
        hs = h // self.stripe
        xs = x.reshape(b, c, t, self.stripe, hs * w)
        mean, mx = xs.mean(-1), xs.amax(-1)
        d = {"mean": mean, "max": mx,
             "meanmax": torch.cat([mean, mx], dim=1)}[self.pool_type]
        d = d[..., None]  # (B, C', T, stripe, 1)
        y = _affinity(_tokens(self.conv_theta(d)), _tokens(self.conv_phi(d)),
                      _tokens(self.conv_g(d)), self.instance)
        y = y.to(x.dtype).reshape(b, t, self.stripe, 1, self.inner)
        wy = self.w_bn(self.w(y.permute(0, 4, 1, 2, 3)))  # (B, C, T, S, 1)
        wy = wy[:, :, :, :, None, :].expand(b, c, t, self.stripe, hs, w)
        return wy.reshape(b, c, t, h, w) + x


class ContextBlock3D(nn.Module):
    """GCNet global-context block: attention (``att``) or average pooling
    to one context vector, then a bottleneck with LayerNorm added to
    (``channel_add``) or gating (``channel_mul``) every position; the last
    conv of each branch starts at zero."""

    def __init__(self, dim: int, ratio: float = 1.0,
                 pooling_type: str = "att",
                 fusion_types=("channel_add",),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        planes = int(dim * ratio)
        self.pooling_type, self.fusion_types = pooling_type, tuple(fusion_types)
        if pooling_type == "att":
            self.conv_mask = Conv3d(dim, 1, 1, bias=True, dtype=dtype)
        for kind in ("mul", "add"):
            if f"channel_{kind}" in self.fusion_types:
                self.add_module(f"{kind}_down",
                                Conv3d(dim, planes, 1, bias=True, dtype=dtype))
                self.add_module(f"{kind}_ln", nn.LayerNorm(planes, eps=1e-6))
                self.add_module(f"{kind}_up", _zero_conv(planes, dim, dtype))

    def _branch(self, kind: str, ctx: torch.Tensor) -> torch.Tensor:
        y = getattr(self, f"{kind}_down")(ctx)
        y = getattr(self, f"{kind}_ln")(y.permute(0, 2, 3, 4, 1).float())
        y = F.relu(y).permute(0, 4, 1, 2, 3)
        return getattr(self, f"{kind}_up")(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        if self.pooling_type == "att":
            mask = F.softmax(self.conv_mask(x).reshape(b, -1).float(), dim=-1)
            ctx = torch.einsum("bn,bnc->bc", mask,
                               _tokens(x).float()).to(x.dtype)
        else:
            ctx = x.mean(dim=(2, 3, 4))
        ctx = ctx[:, :, None, None, None]
        out = x
        if "channel_mul" in self.fusion_types:
            out = out * torch.sigmoid(self._branch("mul", ctx))
        if "channel_add" in self.fusion_types:
            out = out + self._branch("add", ctx)
        return out
