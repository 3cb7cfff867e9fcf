"""Weight bridge between the JAX package's variables and the port's modules.

The JAX package keeps its weights as a ``{"params", "batch_stats"}`` tree
whose module paths mirror the reference's attribute names, with one wrapper
segment per layer (``conv`` for Conv3d, ``bn`` for BatchNorm3d, ``fc`` for
Linear). The port's modules carry the reference's (PySlowFast's) state_dict
names, so the mapping is (naming as in
``efficient_slowfast_tpu/utils/torch_ckpt.py:439-459``):

  s1/pathway0_stem/conv/conv/kernel       ↔ s1.pathway0_stem.conv.weight
  s1/pathway0_stem/bn/bn/{scale,bias}     ↔ s1.pathway0_stem.bn.{weight,bias}
  batch_stats .../bn/bn/{mean,var}        ↔ ....bn.{running_mean,running_var}
  s2/pathway0_res0/branch2/a/conv/kernel  ↔ s2.pathway0_res0.branch2.a.weight
  s1_fuse/bn/bn/scale                     ↔ s1_fuse.bn.weight
  head/projection/fc/{kernel,bias}        ↔ head.projection.{weight,bias}

CMDA's fusion (``torch_ckpt.py:26-31,52-103``): an ``attention_*`` parent,
like a stem, keeps its ``conv`` child, and the SpatialAttention's
projections are renamed:

  s1_fuse/attention_channel_f2s/conv/kernel ↔ s1_fuse.attention_channel_f2s.conv.weight
  s1_fuse/attention_spatial_s2f/query/conv/{kernel,bias}
                                   ↔ s1_fuse.attention_spatial_s2f.query_conv.{weight,bias}
  (key → key_conv, value → value_conv)
  s1_fuse/attention_spatial_s2f/gamma      ↔ s1_fuse.attention_spatial_s2f.gamma
  s1_fuse/downsample_c_of_slow/conv/kernel ↔ s1_fuse.downsample_c_of_slow.weight

A non-local block's projections are renamed as the reference names them
(``torch_ckpt.py:13-24,66-67``):

  s3/pathway0_nonlocal1/theta/conv/{kernel,bias} ↔ s3.pathway0_nonlocal1.conv_theta.{weight,bias}
  (phi → conv_phi, g → conv_g, out → conv_out)
  s3/pathway0_nonlocal1/bn/bn/scale       ↔ s3.pathway0_nonlocal1.bn.weight

A split BN (``SubBatchNorm3d``) keeps JAX's four statistics under the
reference's names, and its splits as one vector (split-major):

  .../a_bn/bn/{mean,var}                  ↔ ....a_bn.bn.{running_mean,running_var}
  .../a_bn/bn/{split_mean,split_var} (k, C) ↔ ....a_bn.split_bn.{running_mean,running_var} (k·C)

The efficient families (``cfg`` given): the reference builds them from
``nn.Sequential`` chains, so their names carry indices and channel counts.
``efficient_prefix_table(cfg)`` (the port's copy of
``utils/torch_ckpt.py::efficient_prefix_table``, ``:115-250``) maps a JAX
layer (its path with the wrapper segment dropped) to the reference's layer,
and both directions consult it before the rules above:

  s2/pathway0_block0/banch2_pw/conv/conv/kernel ↔ s2.pathway0_channel_224.features.0.banch2.0.weight
  s2/pathway0_block0/banch2_pw/bn/bn/scale      ↔ s2.pathway0_channel_224.features.0.banch2.1.weight
  s1/pathway0_stem/conv/conv/kernel             ↔ s1.pathway0_stem.0.weight
  head/projection/fc/kernel                     ↔ head.classifier.1.weight

Their fusions follow the rules above (``s1_fuse.bn_f2s.weight``).

Kernels change layout on the way: 5-D DHWIO ↔ OIDHW, 3-D (k, in, out) ↔
(out, in, k) (ECA's Conv1d) and 2-D (in, out) ↔ (out, in). BN's
``num_batches_tracked`` has no JAX counterpart; it is 0 after conversion.

The int8 calibration (``TPU.INT8_EVAL``) is no part of either checkpoint:
JAX keeps it in its ``quant`` collection, the port in the non-persistent
``act_max`` buffer of each int8 conv (``ops/conv.py``), and
``jax_quant_to_port`` / ``port_quant_to_jax`` carry it across, by the
conv's kernel name:

  quant s2/pathway0_res0/branch2/a/conv/act_max ↔ s2.pathway0_res0.branch2.a.act_max
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "mean": "running_mean", "var": "running_var",
                  "gamma": "gamma"}
_WRAPPERS = ("conv", "bn", "fc")
_RENAMES = {"query": "query_conv", "key": "key_conv", "value": "value_conv",
            "theta": "conv_theta", "phi": "conv_phi", "g": "conv_g",
            "out": "conv_out"}
_UNRENAMES = {v: k for k, v in _RENAMES.items()}
# kernel layouts, JAX → torch (the inverse permutation goes back)
_KERNEL_PERM = {5: (4, 3, 0, 1, 2), 3: (2, 1, 0), 2: (1, 0)}


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[tuple, Any]:
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def efficient_prefix_table(cfg) -> Dict[str, str]:
    """JAX layer path (wrapper segment dropped) → the reference's layer
    name, for the efficient families; empty for the others."""
    from ..models import ghostnet, mobilenetv2, shufflenet, shufflenetv2

    name = cfg.MODEL.MODEL_NAME
    beta = cfg.SLOWFAST.BETA_INV
    wm = float(cfg.SLOWFAST.WIDTH_MULTI)
    t: Dict[str, str] = {}

    def layer(ours, theirs):  # a ConvBNAct: its conv and its BN
        t[f"{ours}/conv"], t[f"{ours}/bn"] = f"{theirs}.0", f"{theirs}.1"

    def renamed(ours, conv, bn):  # a conv and BN of their own names
        t[f"{ours}/conv"], t[f"{ours}/bn"] = conv, bn

    if name == "SlowFastShuffleNetV2":
        slow = shufflenetv2._STAGE_OUT_CHANNELS[wm]
        fast = [c // beta if c > 0 else c for c in slow]
        for p in (0, 1):
            layer(f"s1/pathway{p}_stem", f"s1.pathway{p}_stem")
            ch = slow if p == 0 else fast
            for si, sname in enumerate(("s2", "s3", "s4")):
                base = f"{sname}.pathway{p}_channel_{ch[si + 2]}.features"
                for i in range(shufflenetv2._STAGE_REPEATS[si]):
                    ours, tm = f"{sname}/pathway{p}_block{i}", f"{base}.{i}"
                    if i == 0:
                        layer(f"{ours}/banch1_dw", f"{tm}.banch1")
                        renamed(f"{ours}/banch1_pwl", f"{tm}.banch1.2",
                                f"{tm}.banch1.3")
                    layer(f"{ours}/banch2_pw", f"{tm}.banch2")
                    renamed(f"{ours}/banch2_dw", f"{tm}.banch2.3",
                            f"{tm}.banch2.4")
                    renamed(f"{ours}/banch2_pwl", f"{tm}.banch2.5",
                            f"{tm}.banch2.6")
            layer(f"head/pathway{p}_conv1x1x1", f"head.pathway{p}_conv1x1x1.0")
        t["head/projection"] = "head.classifier.1"

    elif name == "SlowFastShuffleNet":
        slow = [int(c * wm) for c in shufflenet._OUT_PLANES[
            cfg.SLOWFAST.GROUPS]]
        fast = [c // beta for c in slow]
        for p in (0, 1):
            layer(f"s1/pathway{p}_stem", f"s1.pathway{p}_stem")
            ch = slow if p == 0 else fast
            for si, sname in enumerate(("s2", "s3", "s4")):
                base = f"{sname}.pathway{p}_channel_{ch[si + 1]}.features"
                for i in range(shufflenet._NUM_BLOCKS[si]):
                    ours, tm = f"{sname}/pathway{p}_block{i}", f"{base}.{i}"
                    for j in (1, 2, 3):
                        renamed(f"{ours}/conv{j}", f"{tm}.conv{j}",
                                f"{tm}.bn{j}")
                    t[f"{ours}/shortcut_conv"] = f"{tm}.shortcut.0"
        t["head/projection"] = "head.classifier.1"

    elif name == "SlowFastMoibleNetV2":
        for p in (0, 1):
            layer(f"s1/pathway{p}_stem", f"s1.pathway{p}_stem.features")
            for sname, rows in mobilenetv2._LAYOUT.items():
                base = f"{sname}.pathway{p}_channel_{rows[0][1]}.features"
                j = 0
                for texp, _, n, _ in rows:
                    for _ in range(n):
                        ours, tm = f"{sname}/pathway{p}_block{j}", \
                            f"{base}.{j}.conv"
                        parts = ["dw", "pwl"] if texp == 1 else [
                            "pw", "dw", "pwl"]
                        for k, part in enumerate(parts):
                            renamed(f"{ours}/{part}", f"{tm}.{3 * k}",
                                    f"{tm}.{3 * k + 1}")
                        j += 1
            layer(f"head/pathway{p}_conv1x1x1", f"head.pathway{p}_conv1x1x1")
        t["head/projection"] = "head.classifier.1"

    elif name == "SlowFastGhostNet":
        for p in (0, 1):
            layer(f"s0/pathway{p}_stem", f"s0.pathway{p}_stem")
            for si, rows in enumerate(ghostnet._GHOST_STAGE_CFGS):
                c = rows[-1][2] * wm
                last_c = ghostnet.make_divisible(
                    c // beta if p == 1 else c, 4)
                base = f"s{si + 1}.pathway{p}_channel_{last_c}.features"
                for j in range(len(rows)):
                    ours, tm = f"s{si + 1}/pathway{p}_block{j}", f"{base}.{j}"
                    for g in ("ghost1", "ghost2"):
                        layer(f"{ours}/{g}/primary", f"{tm}.{g}.primary_conv")
                        layer(f"{ours}/{g}/cheap",
                              f"{tm}.{g}.cheap_operation")
                    renamed(f"{ours}/conv_dw", f"{tm}.conv_dw", f"{tm}.bn_dw")
                    t[f"{ours}/se/reduce"] = f"{tm}.se.conv_reduce"
                    t[f"{ours}/se/expand"] = f"{tm}.se.conv_expand"
                    layer(f"{ours}/shortcut_dw", f"{tm}.shortcut")
                    renamed(f"{ours}/shortcut_pw", f"{tm}.shortcut.2",
                            f"{tm}.shortcut.3")
            side = "slow" if p == 0 else "fast"
            renamed(f"head/stage5_conv_{p}", f"head.stage5_conv_{side}.conv",
                    f"head.stage5_conv_{side}.bn1")
            t[f"head/conv_head_{p}"] = f"head.conv_head_{side}"
        t["head/projection"] = "head.classifier.1"

    return t


def jax_module_to_torch(path: str, cfg=None) -> str:
    """The port's module name of the JAX package's slash-joined module
    path (``s4/pathway1_res3`` → ``s4.pathway1_res3``; with ``cfg``, an
    efficient family's ``s3/pathway1_block0`` → the ``nn.Sequential`` index
    of its ``efficient_prefix_table``: the longest common module prefix of
    the layers under it)."""
    table = efficient_prefix_table(cfg) if cfg is not None else {}
    hits = [v.split(".") for k, v in table.items()
            if k == path or k.startswith(path + "/")]
    if hits:
        common = hits[0]
        for h in hits[1:]:
            n = 0
            while n < min(len(common), len(h)) and common[n] == h[n]:
                n += 1
            common = common[:n]
        return ".".join(common)
    return ".".join(_RENAMES.get(m, m) for m in path.split("/"))


def _torch_name(path: Tuple[str, ...],
                table: Dict[str, str] | None = None) -> str | None:
    *mods, leaf = path
    if leaf not in _LEAF_TO_TORCH:
        return None
    if table:
        key = mods[:-1] if len(mods) >= 2 and mods[-1] in _WRAPPERS else mods
        hit = table.get("/".join(key))
        if hit is not None:
            return f"{hit}.{_LEAF_TO_TORCH[leaf]}"
    # drop the layer's wrapper segment; a stem or an attention block keeps
    # its own .conv/.bn child (s1/pathway0_stem/conv/conv →
    # s1.pathway0_stem.conv)
    if (len(mods) >= 2 and mods[-1] in _WRAPPERS
            and (mods[-2] in _WRAPPERS or not _keeps_child(mods[-2]))):
        mods = mods[:-1]
    return ".".join([_RENAMES.get(m, m) for m in mods]
                    + [_LEAF_TO_TORCH[leaf]])


def _keeps_child(seg: str) -> bool:
    return seg.endswith("_stem") or seg.startswith("attention_")


def _to_torch_layout(leaf: str, v: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return v
    if v.ndim not in _KERNEL_PERM:
        raise ValueError(f"no torch layout for a {v.ndim}-D kernel")
    return np.transpose(v, _KERNEL_PERM[v.ndim])


_SPLIT_LEAVES = {"mean": "bn.running_mean", "var": "bn.running_var",
                 "split_mean": "split_bn.running_mean",
                 "split_var": "split_bn.running_var"}


def jax_variables_to_state_dict(variables,
                                cfg=None) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree (numpy leaves) → state_dict;
    ``cfg`` names an efficient family's tree (``efficient_prefix_table``)."""
    table = efficient_prefix_table(cfg) if cfg is not None else {}
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        flat = _flatten(variables.get(coll, {}))
        split = {path[:-1] for path in flat if path[-1] == "split_mean"}
        for path, v in flat.items():
            v = np.array(v, np.float32)
            if path[:-1] in split:  # a split BN's statistics
                prefix = _torch_name(path[:-1] + ("mean",), table)[:-len(
                    "running_mean")]
                name = prefix + _SPLIT_LEAVES[path[-1]]
                v = v.reshape(-1)
            else:
                name = _torch_name(path, table)
                if name is None:
                    continue
                v = _to_torch_layout(path[-1], v)
            sd[name] = torch.from_numpy(np.ascontiguousarray(v))
            if name.endswith("running_mean"):
                prefix = name[:-len("running_mean")]
                sd[prefix + "num_batches_tracked"] = torch.tensor(0)
    return sd


def state_dict_to_jax_variables(state_dict, cfg=None) -> Dict[str, dict]:
    """The inverse: a port state_dict → JAX-layout numpy variables (an
    efficient family's where ``cfg`` names one)."""
    layers = {v: k for k, v in (efficient_prefix_table(cfg).items()
                                if cfg is not None else ())}
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    tail = ".split_bn.running_mean"
    split = {k[:-len(tail)] for k in state_dict if k.endswith(tail)}
    for name, t in state_dict.items():
        prefix, _, suffix = name.rpartition(".")
        if suffix == "num_batches_tracked":
            continue
        v = t.detach().float().cpu().numpy()
        owner, _, inner = prefix.rpartition(".")
        if owner in split and inner in ("bn", "split_bn"):
            # a split BN's statistics: (k·C) splits back to (k, C)
            prefix = owner
            leaf = {"running_mean": "mean", "running_var": "var"}[suffix]
            if inner == "split_bn":
                leaf = "split_" + leaf
                v = v.reshape(-1, state_dict[owner + ".weight"].numel())
        mods = (layers[prefix].split("/") if prefix in layers
                else [_UNRENAMES.get(m, m) for m in prefix.split(".")])
        coll = "params"
        if prefix in split:  # a split BN: its parameters or statistics
            wrap = ["bn"]
            if suffix in ("weight", "bias"):
                leaf = {"weight": "scale", "bias": "bias"}[suffix]
            else:
                coll = "batch_stats"
        elif suffix == "gamma":  # SpatialAttention's γ, a bare parameter
            wrap, leaf = [], "gamma"
        elif prefix + ".running_mean" in state_dict:  # a BatchNorm3d
            wrap, leaf = ["bn"], {"weight": "scale", "bias": "bias",
                                  "running_mean": "mean",
                                  "running_var": "var"}[suffix]
            if suffix.startswith("running_"):
                coll = "batch_stats"
        else:  # a Conv3d (5-D), ECA's Conv1d (3-D) or a Linear (2-D)
            ndim = state_dict[prefix + ".weight"].dim()
            # Conv1d is a bare flax nn.Conv: no wrapper segment
            wrap = {5: ["conv"], 3: [], 2: ["fc"]}[ndim]
            leaf = "kernel" if suffix == "weight" else "bias"
            if suffix == "weight":
                v = np.transpose(v, np.argsort(_KERNEL_PERM[ndim]))
        d = out[coll]
        for m in mods + wrap:
            d = d.setdefault(m, {})
        d[leaf] = np.ascontiguousarray(v)
    return out


def jax_quant_to_port(quant, cfg=None) -> Dict[str, torch.Tensor]:
    """JAX's ``quant`` collection (numpy leaves) → the port's quant state,
    {"<conv>.act_max": 0-d float32} (``engine/quantize.py``)."""
    table = efficient_prefix_table(cfg) if cfg is not None else {}
    out = {}
    for path, v in _flatten(quant).items():
        if path[-1] == "act_max":
            name = _torch_name(path[:-1] + ("kernel",), table)
            out[name[:-len("weight")] + "act_max"] = torch.tensor(
                np.float32(v))
    return out


def port_quant_to_jax(quant, cfg=None) -> Dict[str, Any]:
    """The inverse: the port's quant state → JAX's ``quant`` tree."""
    layers = {v: k for k, v in (efficient_prefix_table(cfg).items()
                                if cfg is not None else ())}
    out: Dict[str, Any] = {}
    for name, t in quant.items():
        prefix = name[:-len(".act_max")]
        mods = (layers[prefix].split("/") if prefix in layers
                else [_UNRENAMES.get(m, m) for m in prefix.split(".")])
        d = out
        for m in mods + ["conv"]:
            d = d.setdefault(m, {})
        d["act_max"] = np.asarray(float(t), np.float32)
    return out
