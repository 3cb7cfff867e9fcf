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

Kernels change layout on the way: 5-D DHWIO ↔ OIDHW, 3-D (k, in, out) ↔
(out, in, k) (ECA's Conv1d) and 2-D (in, out) ↔ (out, in). BN's
``num_batches_tracked`` has no JAX counterpart; it is 0 after conversion.
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


def _torch_name(path: Tuple[str, ...]) -> str | None:
    *mods, leaf = path
    if leaf not in _LEAF_TO_TORCH:
        return None
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


def jax_variables_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree (numpy leaves) → state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        flat = _flatten(variables.get(coll, {}))
        split = {path[:-1] for path in flat if path[-1] == "split_mean"}
        for path, v in flat.items():
            v = np.array(v, np.float32)
            if path[:-1] in split:  # a split BN's statistics
                prefix = _torch_name(path[:-1] + ("mean",))[:-len(
                    "running_mean")]
                name = prefix + _SPLIT_LEAVES[path[-1]]
                v = v.reshape(-1)
            else:
                name = _torch_name(path)
                if name is None:
                    continue
                v = _to_torch_layout(path[-1], v)
            sd[name] = torch.from_numpy(np.ascontiguousarray(v))
            if name.endswith("running_mean"):
                prefix = name[:-len("running_mean")]
                sd[prefix + "num_batches_tracked"] = torch.tensor(0)
    return sd


def state_dict_to_jax_variables(state_dict) -> Dict[str, dict]:
    """The inverse: a port state_dict → JAX-layout numpy variables."""
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
        mods = [_UNRENAMES.get(m, m) for m in prefix.split(".")]
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
