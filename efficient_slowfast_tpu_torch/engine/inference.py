"""Fused eval forward for SlowFast trunks — the serving path.

Port of ``efficient_slowfast_tpu/engine/inference.py``. It reads the port's
``SlowFast`` module once, folds every eval-mode BN affine into its conv
(``ops/kernels/fused_bottleneck.fold_bn``), and runs the network on plain
tensors:

- every identity (stride-1) bottleneck block is ONE launch of the
  hand-written CUDA kernel ``fused_bottleneck`` (x read once, the output
  written once; a and b never reach device memory);
- strided block 0s, stems, lateral fusions and the head run as cuDNN
  convolutions and plain tensor ops.

The weights are folded when the forward is made: a forward made before the
module's weights change keeps the old ones. On a CPU model the kernel's
plain version runs (that is how the tests hold this engine against JAX);
on a CUDA model the kernel runs, and a block it cannot take raises.

Reference behaviour being reproduced: slowfast/models/video_model_builder.py
:153-416 (SlowFast forward) and head_helper.py:218-221 (eval
softmax-then-mean).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.build import get_compute_dtype
from ..models.slowfast import _MODEL_STAGE_DEPTH, _POOL1, to_ncdhw
from ..ops.kernels.fused_bottleneck import fold_bn, fused_bottleneck
from ..ops.pool import max_pool3d

STAGES = ("s2", "s3", "s4", "s5")


def supports(cfg) -> bool:
    """Whether the fused engine covers this config's eval forward."""
    try:
        return (
            cfg.MODEL.MODEL_NAME == "SlowFast"
            and not cfg.DETECTION.ENABLE
            and cfg.BN.NORM_TYPE == "batchnorm"
            and cfg.RESNET.TRANS_FUNC == "bottleneck_transform"
            and not cfg.RESNET.STRIDE_1X1
            and all(g == 1 for g in [cfg.RESNET.NUM_GROUPS])
            and all(not loc[p] for loc in cfg.NONLOCAL.LOCATION for p in (0, 1))
            and all(d == 1 for ds in cfg.RESNET.SPATIAL_DILATIONS for d in ds)
            and not cfg.MODEL.SLOW_PATHWAY_HEAD
            and not cfg.MULTIGRID.SHORT_CYCLE
            and cfg.RESNET.DEPTH in _MODEL_STAGE_DEPTH
            # the engine's head hardcodes softmax-then-mean
            and cfg.MODEL.HEAD_ACT == "softmax"
            and not cfg.DATA.MULTI_LABEL
        )
    except (AttributeError, KeyError, IndexError, TypeError):
        return False


def _folded(conv, bn):
    """Conv weight with BN folded in: (kernel DHWIO float32, bias float32)."""
    k = conv.weight.detach().float().permute(2, 3, 4, 1, 0)
    return fold_bn(k, bn.weight.detach().float(), bn.bias.detach().float(),
                   bn.running_mean.float(), bn.running_var.float(), bn.eps)


def _oidhw(k, dtype):
    """DHWIO kernel → cuDNN's OIDHW, in channels_last_3d like activations."""
    return k.permute(4, 3, 0, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last_3d)


def _fold_block(block, stride, dtype):
    """Folded weights of one ResBlock, in the layout its path needs."""
    br = block.branch2
    (wa, ba), (wb, bb), (wc, bc) = (_folded(br.a, br.a_bn),
                                    _folded(br.b, br.b_bn),
                                    _folded(br.c, br.c_bn))
    wp = bp = None
    if hasattr(block, "branch1"):
        wp, bp = _folded(block.branch1, block.branch1_bn)
    if stride == 1:  # the kernel's layout: channels-last matrices
        cast = lambda t: t.to(dtype).contiguous()
        return dict(
            stride=1, wa=cast(wa[:, 0, 0]), ba=ba, wb=cast(wb[0]), bb=bb,
            wc=cast(wc[0, 0, 0]), bc=bc,
            wp=cast(wp[0, 0, 0]) if wp is not None else None, bp=bp)
    cast = lambda t: t.to(dtype)
    return dict(
        stride=stride, wa=_oidhw(wa, dtype), ba=cast(ba), wb=_oidhw(wb, dtype),
        bb=cast(bb), wc=_oidhw(wc, dtype), bc=cast(bc),
        wp=_oidhw(wp, dtype) if wp is not None else None,
        bp=cast(bp) if bp is not None else None)


def _kernel_block(x, p):
    """Stride-1 block: one launch of the fused kernel on the NDHWC view."""
    b, c, t, h, w = x.shape
    xn = x.permute(0, 2, 3, 4, 1).reshape(b * t, h, w, c).contiguous()
    y = fused_bottleneck(xn, t, p["wa"], p["ba"], p["wb"], p["bb"],
                         p["wc"], p["bc"], p["wp"], p["bp"])
    return y.view(b, t, h, w, -1).permute(0, 4, 1, 2, 3)


def _cudnn_block(x, p):
    """Strided bottleneck block on cuDNN (block 0 of s3..s5)."""
    s, kt = p["stride"], p["wa"].shape[2]
    a = F.relu(F.conv3d(x, p["wa"], p["ba"], 1, (kt // 2, 0, 0)))
    b = F.relu(F.conv3d(a, p["wb"], p["bb"], (1, s, s), (0, 1, 1)))
    c = F.conv3d(b, p["wc"], p["bc"])
    res = x if p["wp"] is None else F.conv3d(x, p["wp"], p["bp"], (1, s, s))
    return F.relu(c + res)


def make_fused_eval_forward(cfg, model):
    """Fold ``model`` (a port ``SlowFast``) into fn([slow, fast]) → scores.

    Inputs are the channels-last pathway tensors of the model's public
    boundary, on the model's device; the scores are float32 (B, classes).
    """
    assert supports(cfg), "config outside the fused engine's envelope"
    dtype = get_compute_dtype(cfg)
    depths = _MODEL_STAGE_DEPTH[cfg.RESNET.DEPTH]
    alpha = cfg.SLOWFAST.ALPHA
    pool1 = _POOL1[cfg.MODEL.ARCH]
    strides = [s[0] for s in cfg.RESNET.SPATIAL_STRIDES]

    with torch.no_grad():
        stems = []
        for pw in range(2):
            stem = getattr(model.s1, f"pathway{pw}_stem")
            k, b = _folded(stem.conv, stem.bn)
            stems.append((_oidhw(k, dtype), b.to(dtype)))
        fuses = {}
        for name in ("s1_fuse", "s2_fuse", "s3_fuse", "s4_fuse"):
            fz = getattr(model, name)
            k, b = _folded(fz.conv_f2s, fz.bn)
            fuses[name] = (_oidhw(k, dtype), b.to(dtype))
        blocks = {
            (si, pw, i): _fold_block(
                getattr(getattr(model, stage), f"pathway{pw}_res{i}"),
                strides[si] if i == 0 else 1, dtype)
            for si, stage in enumerate(STAGES)
            for pw in range(2) for i in range(depths[si])}
        fc = model.head.projection
        fc_w = fc.weight.detach().t().to(dtype)
        fc_b = fc.bias.detach().float()

    crop, tdim = cfg.DATA.CROP_SIZE, cfg.DATA.NUM_FRAMES
    psz = [[tdim // alpha // pool1[0][0], crop // 32, crop // 32],
           [tdim // pool1[1][0], crop // 32, crop // 32]]

    def fuse(x, name):
        k, b = fuses[name]
        kf = k.shape[2]
        f = F.relu(F.conv3d(x[1], k, b, (alpha, 1, 1), (kf // 2, 0, 0)))
        cat = torch.cat([x[0], f], dim=1)
        return [cat.contiguous(memory_format=torch.channels_last_3d), x[1]]

    def forward(inputs):
        # ---- s1: per-pathway stem (conv+BN+ReLU+maxpool) -----------------
        x = []
        for pw in range(2):
            k, b = stems[pw]
            kt = k.shape[2]
            y = F.relu(F.conv3d(to_ncdhw(inputs[pw].to(dtype)), k, b,
                                (1, 2, 2), (kt // 2, 3, 3)))
            x.append(max_pool3d(y, (1, 3, 3), (1, 2, 2), (0, 1, 1)))
        x = fuse(x, "s1_fuse")

        # ---- stages: stride-1 blocks on the kernel, block 0s on cuDNN ----
        for si, stage in enumerate(STAGES):
            for pw in range(2):
                y = x[pw]
                for i in range(depths[si]):
                    p = blocks[(si, pw, i)]
                    y = _kernel_block(y, p) if p["stride"] == 1 \
                        else _cudnn_block(y, p)
                x[pw] = y
            if stage != "s5":
                x = fuse(x, f"{stage}_fuse")
            if stage == "s2" and any(v != 1 for pv in pool1 for v in pv):
                x = [max_pool3d(x[pw], pool1[pw], pool1[pw]) for pw in range(2)]

        # ---- head: avgpool → concat → linear → softmax → mean ------------
        pooled = [F.avg_pool3d(x[pw].float(), psz[pw], 1)
                  for pw in range(2)]
        y = torch.cat(pooled, dim=1).permute(0, 2, 3, 4, 1)
        y = (y.to(dtype) @ fc_w).float() + fc_b
        y = torch.softmax(y, dim=-1).mean(dim=(1, 2, 3))
        return y.reshape(y.shape[0], -1)

    return forward

