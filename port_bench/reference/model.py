"""Plain float32 SlowFast-R50 and CMDA-R50, written from PySlowFast.

SlowFast: ``slowfast/models/video_model_builder.py`` (SlowFast, the
FuseFastToSlow lateral), ``resnet_helper.py`` (bottleneck ResBlocks),
``stem_helper.py`` and ``head_helper.py`` (softmax before the mean over
positions in eval). CMDA-R50 ("Efficient dual attention SlowFast networks
for video action recognition", weidafeng/Efficient-SlowFast,
``custom_video_model_builder.py`` and ``wdf_attention_helper.py``): the
same trunk whose laterals are FuseFastAndSlow — fast→slow a temporal max
pool, ECA (a 3-tap Conv1d over the channel means, a sigmoid gate), BN and
ReLU; slow→fast a 1x1x1 conv to C/β channels, SpatialAttention (unscaled
softmax(q kᵀ) v over all T·H·W tokens, γ times it plus the input), BN,
ReLU and a nearest temporal upsample; both concatenated, slow first.

The weights are a dict of float32 tensors under the port's state_dict
names, so one dict loads into the program and drives this reference. The
activations are NCDHW float32, and TF32 is off while it runs
(``float32_products``). ``rnd`` rounds every product's operands (convs, the
classifier, q, k and v): the identity here, a lower precision for the
control. Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .attention import blocked

# temporal kernels of the stem and of stages s2-s5, slow and fast
# (video_model_builder.py:_TEMPORAL_KERNEL_BASIS["slowfast"])
_TEMPORAL = [(1, 5), (1, 3), (1, 3), (3, 3), (3, 3)]
_DEPTHS = {50: (3, 4, 6, 3)}
_STRIDES = (1, 2, 2, 2)


@dataclass(frozen=True)
class Arch:
    model: str  # "SlowFast" or "SlowFastDualAttention"
    width: int
    beta_inv: int
    alpha: int
    fusion_ratio: int
    fusion_kernel: int
    depths: tuple
    num_classes: int
    num_frames: int
    crop: int  # the head's window is crop / 32 (DATA.CROP_SIZE)
    dropout: float
    bn_eps: float

    @property
    def cmda(self) -> bool:
        return self.model == "SlowFastDualAttention"


def _get(d: dict, key: str, default):
    for part in key.split("."):
        if not isinstance(d, dict) or part not in d:
            return default
        d = d[part]
    return d


def arch_from(cfg: dict) -> Arch:
    """The architecture a configuration's values give (PySlowFast's
    defaults where they are silent); what this reference does not
    implement raises."""
    depth = _get(cfg, "RESNET.DEPTH", 50)
    fixed = {"MODEL.ARCH": "slowfast", "RESNET.NUM_GROUPS": 1,
             "RESNET.TRANS_FUNC": "bottleneck_transform",
             "RESNET.STRIDE_1X1": False, "MODEL.HEAD_ACT": "softmax",
             "DETECTION.ENABLE": False, "DATA.MULTI_LABEL": False}
    for key, want in fixed.items():
        if _get(cfg, key, want) != want:
            raise NotImplementedError(f"{key} {_get(cfg, key, want)!r}")
    if any(loc for s in _get(cfg, "NONLOCAL.LOCATION", []) for loc in s):
        raise NotImplementedError("non-local blocks")
    if depth not in _DEPTHS:
        raise NotImplementedError(f"RESNET.DEPTH {depth}")
    name = _get(cfg, "MODEL.MODEL_NAME", "SlowFast")
    if name not in ("SlowFast", "SlowFastDualAttention"):
        raise NotImplementedError(name)
    return Arch(model=name,
                width=_get(cfg, "RESNET.WIDTH_PER_GROUP", 64),
                beta_inv=_get(cfg, "SLOWFAST.BETA_INV", 8),
                alpha=_get(cfg, "SLOWFAST.ALPHA", 8),
                fusion_ratio=_get(cfg, "SLOWFAST.FUSION_CONV_CHANNEL_RATIO", 2),
                fusion_kernel=_get(cfg, "SLOWFAST.FUSION_KERNEL_SZ", 5),
                depths=_DEPTHS[depth],
                num_classes=_get(cfg, "MODEL.NUM_CLASSES", 400),
                num_frames=_get(cfg, "DATA.NUM_FRAMES", 8),
                crop=_get(cfg, "DATA.CROP_SIZE", 224),
                dropout=_get(cfg, "MODEL.DROPOUT_RATE", 0.5),
                bn_eps=_get(cfg, "BN.EPSILON", 1e-5))


# ---------------------------------------------------------------------------
# parameters: name -> (shape, kind)

def _conv(spec, name, cout, cin, k, bias=False):
    spec[f"{name}.weight"] = ((cout, cin) + tuple(k), "conv")
    if bias:
        spec[f"{name}.bias"] = ((cout,), "bias")


def _bn(spec, name, c):
    for leaf, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                       ("running_mean", "bn_mean"), ("running_var", "bn_var")):
        spec[f"{name}.{leaf}"] = ((c,), kind)


def _slow_widths(arch):
    w = arch.width
    return [w, 4 * w, 8 * w, 16 * w]


def _stage_in(arch, idx):
    """Channels into stage s{idx + 2}, slow and fast, after the lateral."""
    ds = _slow_widths(arch)[idx]
    df = ds // arch.beta_inv
    if arch.cmda:
        return [ds + df, df + df]
    return [ds + df * arch.fusion_ratio, df]


def param_spec(arch: Arch) -> "OrderedDict[str, tuple]":
    """Every float32 entry of the model's state_dict, in a fixed order."""
    spec = OrderedDict()
    w, beta = arch.width, arch.beta_inv
    for p, c in enumerate((w, w // beta)):
        _conv(spec, f"s1.pathway{p}_stem.conv", c, 3,
              (_TEMPORAL[0][p], 7, 7))
        _bn(spec, f"s1.pathway{p}_stem.bn", c)
    for idx in range(4):
        ds = _slow_widths(arch)[idx]
        df = ds // beta
        fuse = f"s{idx + 1}_fuse"
        if arch.cmda:
            spec[f"{fuse}.attention_channel_f2s.conv.weight"] = ((1, 1, 3),
                                                                 "eca")
            _bn(spec, f"{fuse}.bn_f2s", df)
            _conv(spec, f"{fuse}.downsample_c_of_slow", df, ds, (1, 1, 1))
            att = f"{fuse}.attention_spatial_s2f"
            spec[f"{att}.gamma"] = ((1,), "gamma")
            for conv in ("query_conv", "key_conv", "value_conv"):
                _conv(spec, f"{att}.{conv}", df, df, (1, 1, 1), bias=True)
            _bn(spec, f"{fuse}.bn_s2f", df)
        else:
            _conv(spec, f"{fuse}.conv_f2s", df * arch.fusion_ratio, df,
                  (arch.fusion_kernel, 1, 1))
            _bn(spec, f"{fuse}.bn", df * arch.fusion_ratio)
        mult = 2 ** idx
        dim_in = _stage_in(arch, idx)
        for p in range(2):
            out = w * 4 * mult // (beta if p else 1)
            inner = w * mult // (beta if p else 1)
            tk = _TEMPORAL[idx + 1][p]
            for j in range(arch.depths[idx]):
                blk = f"s{idx + 2}.pathway{p}_res{j}"
                cin = dim_in[p] if j == 0 else out
                if j == 0:
                    _conv(spec, f"{blk}.branch1", out, cin, (1, 1, 1))
                    _bn(spec, f"{blk}.branch1_bn", out)
                _conv(spec, f"{blk}.branch2.a", inner, cin, (tk, 1, 1))
                _bn(spec, f"{blk}.branch2.a_bn", inner)
                _conv(spec, f"{blk}.branch2.b", inner, inner, (1, 3, 3))
                _bn(spec, f"{blk}.branch2.b_bn", inner)
                _conv(spec, f"{blk}.branch2.c", out, inner, (1, 1, 1))
                _bn(spec, f"{blk}.branch2.c_bn", out)
    feat = 32 * w + 32 * w // beta
    spec["head.projection.weight"] = ((arch.num_classes, feat), "fc")
    spec["head.projection.bias"] = ((arch.num_classes,), "bias")
    return spec


def trainable(spec) -> list:
    """The names of the parameters (all but the running statistics)."""
    return [n for n, (_, kind) in spec.items()
            if kind not in ("bn_mean", "bn_var")]


def is_bn(spec, name: str) -> bool:
    return spec[name][1] in ("bn_weight", "bn_bias")


@contextlib.contextmanager
def float32_products():
    """TF32 off for matmuls and cuDNN convs, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _identity(t):
    return t


class Net:
    """The forward over the weight dict ``w``.

    ``train`` normalises with each batch's statistics (biased variance, as
    both PySlowFast and the program do) and returns logits, dropping
    features with a mask drawn from ``dropout_gen``; eval returns the
    softmax scores averaged over the head's positions. ``attend`` is the
    attention (``blocked``, or ``dense`` on the meta device), ``rnd`` the
    rounding of every product's operands. ``on_attention(name, q, k)``, if
    given, returns a factor for q and k (the calibration of the recipe).
    """

    def __init__(self, arch: Arch, w: dict, *, train: bool = False,
                 rnd: Callable = _identity, attend: Callable = blocked,
                 dropout_gen: Optional[torch.Generator] = None,
                 on_attention: Optional[Callable] = None):
        self.arch, self.w, self.train = arch, w, train
        self.rnd, self.attend = rnd, attend
        self.dropout_gen, self.on_attention = dropout_gen, on_attention

    # -- layers ----------------------------------------------------------
    def conv(self, x, name, stride=(1, 1, 1), padding=(0, 0, 0)):
        bias = self.w.get(f"{name}.bias")
        return F.conv3d(self.rnd(x), self.rnd(self.w[f"{name}.weight"]), bias,
                        stride, padding)

    def bn(self, x, name):
        w = self.w
        if self.train:
            return F.batch_norm(x, None, None, w[f"{name}.weight"],
                                w[f"{name}.bias"], True, 0.0,
                                self.arch.bn_eps)
        return F.batch_norm(x, w[f"{name}.running_mean"],
                            w[f"{name}.running_var"], w[f"{name}.weight"],
                            w[f"{name}.bias"], False, 0.0, self.arch.bn_eps)

    def block(self, x, name, tk, stride):
        sc = x
        if f"{name}.branch1.weight" in self.w:
            sc = self.bn(self.conv(x, f"{name}.branch1", (1, stride, stride)),
                         f"{name}.branch1_bn")
        y = F.relu(self.bn(self.conv(x, f"{name}.branch2.a",
                                     padding=(tk // 2, 0, 0)),
                           f"{name}.branch2.a_bn"))
        y = F.relu(self.bn(self.conv(y, f"{name}.branch2.b", (1, stride, stride),
                                     (0, 1, 1)), f"{name}.branch2.b_bn"))
        y = self.bn(self.conv(y, f"{name}.branch2.c"), f"{name}.branch2.c_bn")
        return F.relu(sc + y)

    def stage(self, x, idx):
        out = []
        for p in range(2):
            y = x[p]
            for j in range(self.arch.depths[idx]):
                y = self.block(y, f"s{idx + 2}.pathway{p}_res{j}",
                               _TEMPORAL[idx + 1][p],
                               _STRIDES[idx] if j == 0 else 1)
            out.append(y)
        return out

    def stem(self, x, p):
        kt = _TEMPORAL[0][p]
        y = self.conv(x, f"s1.pathway{p}_stem.conv", (1, 2, 2), (kt // 2, 3, 3))
        y = F.relu(self.bn(y, f"s1.pathway{p}_stem.bn"))
        return F.max_pool3d(y, (1, 3, 3), (1, 2, 2), (0, 1, 1))

    def fuse_fast_to_slow(self, x, name):
        k = self.arch.fusion_kernel
        f = self.conv(x[1], f"{name}.conv_f2s", (self.arch.alpha, 1, 1),
                      (k // 2, 0, 0))
        f = F.relu(self.bn(f, f"{name}.bn"))
        return [torch.cat([x[0], f], 1), x[1]]

    def eca(self, x, name):
        y = x.mean(dim=(2, 3, 4))[:, None, :]
        y = F.conv1d(y, self.w[f"{name}.conv.weight"], padding=1)[:, 0]
        return x * torch.sigmoid(y)[:, :, None, None, None]

    def spatial_attention(self, x, name):
        b, c, t, h, w = x.shape
        n = t * h * w

        def tokens(conv):
            y = self.conv(x, f"{name}.{conv}")
            return y.permute(0, 2, 3, 4, 1).reshape(b, n, -1)

        q, k, v = tokens("query_conv"), tokens("key_conv"), tokens("value_conv")
        if self.on_attention is not None:
            f = self.on_attention(name, q, k)
            q, k = q * f, k * f
        out = self.attend(self.rnd(q), self.rnd(k), self.rnd(v))
        out = out.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
        return self.w[f"{name}.gamma"] * out + x

    def fuse_dual_attention(self, x, name):
        a = self.arch.alpha
        f2s = F.max_pool3d(x[1], (a, 1, 1), (a, 1, 1))
        f2s = F.relu(self.bn(self.eca(f2s, f"{name}.attention_channel_f2s"),
                             f"{name}.bn_f2s"))
        s2f = self.conv(x[0], f"{name}.downsample_c_of_slow")
        s2f = self.spatial_attention(s2f, f"{name}.attention_spatial_s2f")
        s2f = F.relu(self.bn(s2f, f"{name}.bn_s2f"))
        s2f = s2f.repeat_interleave(a, dim=2)
        return [torch.cat([x[0], f2s], 1), torch.cat([s2f, x[1]], 1)]

    def head(self, x):
        arch = self.arch
        win = arch.crop // 32
        frames = (arch.num_frames // arch.alpha, arch.num_frames)
        pools = [F.avg_pool3d(x[p], (frames[p], win, win), stride=1)
                 for p in range(2)]
        y = torch.cat(pools, 1).permute(0, 2, 3, 4, 1)
        if self.train and arch.dropout > 0:
            keep = torch.rand(y.shape, generator=self.dropout_gen,
                              device=y.device) < 1 - arch.dropout
            y = torch.where(keep, y / (1 - arch.dropout), torch.zeros_like(y))
        y = F.linear(self.rnd(y), self.rnd(self.w["head.projection.weight"]),
                     self.w["head.projection.bias"])
        if not self.train:
            y = torch.softmax(y, dim=-1).mean(dim=(1, 2, 3))
        return y.reshape(y.shape[0], -1)

    # -- the network -----------------------------------------------------
    def __call__(self, inputs):
        """``inputs``: [slow (B, T/α, H, W, 3), fast (B, T, H, W, 3)]
        channels-last, any float dtype."""
        x = [self.stem(t.float().permute(0, 4, 1, 2, 3).contiguous(), p)
             for p, t in enumerate(inputs)]
        fuse = (self.fuse_dual_attention if self.arch.cmda
                else self.fuse_fast_to_slow)
        for idx in range(4):
            x = fuse(x, f"s{idx + 1}_fuse")
            x = self.stage(x, idx)
        return self.head(x)


def cross_entropy(logits, labels):
    return F.cross_entropy(logits.float(), labels.long())


def sgd_step(params: dict, bufs: dict, grads: dict, lr: float,
             momentum: float, nesterov: bool, decay: dict) -> None:
    """One SGD step in place (torch.optim.SGD's rule, dampening 0, weight
    decay ``decay[name]`` added to the gradient before the momentum)."""
    with torch.no_grad():
        for name, p in params.items():
            d = grads[name] + decay[name] * p
            if name in bufs:
                bufs[name].mul_(momentum).add_(d)
            else:
                bufs[name] = d.clone()
            step = d + momentum * bufs[name] if nesterov else bufs[name]
            p.sub_(lr * step)
