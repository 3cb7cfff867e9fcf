"""Checkpoints (port of ``utils/checkpoint.py``; reference:
slowfast/utils/checkpoint.py).

A checkpoint is ``OUTPUT_DIR/checkpoints/checkpoint_epoch_{epoch:05d}.pyth``
in the reference's layout, ``{"epoch", "model_state", "optimizer_state",
"cfg"}``, written by the master process. Under ``TPU.CHECKPOINT_BACKEND
orbax`` (the JAX package's async sharded backend) it is the directory
``checkpoint_epoch_{epoch:05d}.dcp``, the same payload written by
``torch.distributed.checkpoint.async_save`` from every rank while the next
epoch runs (``wait_for_saves`` drains it; at most one save is in flight),
and the master writes the cfg beside it as ``cfg_epoch_{epoch:05d}.yaml``,
as JAX's does. The model's BN statistics are
stored in the plain form (split BNs aggregated, as the reference saves
them), so any build of the model reads the file with ``strict=True``, the
JAX package's ``utils/torch_ckpt.py::load_torch_checkpoint`` among them;
loading converts them back to the form of the model they go into. The
optimizer's moments keep the dtype they were stored in
(``TPU.OPTIMIZER_STATE_DTYPE``).

External weights (``TRAIN/TEST.CHECKPOINT_FILE_PATH``): a ``.pyth`` of the
reference layout, loaded strict; the JAX package's msgpack ``.jaxckpt``,
read without flax (``utils/flax_msgpack.py``) and mapped by
``utils/weights.py``; and, by the JAX package's ``_load_external`` rules
(``utils/torch_ckpt.py::load_torch_checkpoint``), a Caffe2 model-zoo
pickle (``CHECKPOINT_TYPE caffe2``, its blob names translated by
``c2_name_to_torch``) or a ``.pyth`` under ``TRAIN.CHECKPOINT_INFLATE``
(2-D ImageNet weights inflated to 3-D): every tensor of the model whose
name the file holds in a shape that fits is loaded, the others keep the
model's values. The JAX package's ``.orbax`` directories are read through
``tensorstore`` (imported at the first such read; the port never imports
orbax): ``_METADATA`` names every leaf by its tuple of keys, each leaf a
zarr array in the directory's OCDBT store; they give the model its
weights as a ``.jaxckpt`` does, and not the optimizer its state. Across
processes the master writes (every rank, for ``.dcp``) and every rank
reads.
"""

from __future__ import annotations

import json
import os
import pickle
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import yaml

from ..ops.norm import adapt_bn_stats_to, sub_to_normal_bn
from .flax_msgpack import msgpack_restore
from .logging import get_logger, is_master
from .weights import jax_variables_to_state_dict

logger = get_logger(__name__)

# the port's checkpoints, and the JAX package's in a run directory of its
_CKPT_RE = re.compile(r"checkpoint_epoch_(\d+)\.(pyth|dcp|jaxckpt|orbax)$")

_pending = None  # the in-flight async save (a Future), if any


def get_checkpoint_dir(path_to_job: str) -> str:
    return os.path.join(path_to_job, "checkpoints")


def make_checkpoint_dir(path_to_job: str) -> str:
    d = get_checkpoint_dir(path_to_job)
    if is_master():
        os.makedirs(d, exist_ok=True)
    return d


def get_path_to_checkpoint(path_to_job: str, epoch: int,
                           backend: str = "msgpack") -> str:
    """The file (the directory, for the ``orbax`` backend) of the
    checkpoint taken after ``epoch`` epochs."""
    suffix = "dcp" if backend == "orbax" else "pyth"
    return os.path.join(get_checkpoint_dir(path_to_job),
                        f"checkpoint_epoch_{epoch:05d}.{suffix}")


def get_last_checkpoint(path_to_job: str) -> Optional[str]:
    d = get_checkpoint_dir(path_to_job)
    if not os.path.isdir(d):
        return None
    names = sorted(n for n in os.listdir(d) if _CKPT_RE.search(n))
    return os.path.join(d, names[-1]) if names else None


def has_checkpoint(path_to_job: str) -> bool:
    return get_last_checkpoint(path_to_job) is not None


def is_checkpoint_epoch(cfg, cur_epoch: int, multigrid_schedule=None) -> bool:
    """Checkpoint cadence, multigrid-aware (reference: :84-104)."""
    if multigrid_schedule is not None:
        prev_epoch = 0
        for s in multigrid_schedule:
            if cur_epoch < s[-1]:
                period = max(
                    (s[-1] - prev_epoch) // cfg.MULTIGRID.EVAL_FREQ + 1, 1
                )
                return (s[-1] - 1 - cur_epoch) % period == 0
            prev_epoch = s[-1]
    return (cur_epoch + 1) % cfg.TRAIN.CHECKPOINT_PERIOD == 0


def _to_cpu(obj):
    """A host copy of a tree of tensors (a copy on the host too: a payload
    keeps what the state held when it was taken)."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_cpu(v) for v in obj]
    return obj


def checkpoint_payload(state, epoch: int, cfg) -> dict:
    """What ``save_checkpoint`` writes for ``state`` after ``epoch``
    (0-based), on the host."""
    if cfg.TPU.CHECKPOINT_BACKEND not in ("msgpack", "orbax"):
        raise ValueError(f"TPU.CHECKPOINT_BACKEND "
                         f"{cfg.TPU.CHECKPOINT_BACKEND}: msgpack or orbax")
    return {
        "epoch": epoch,
        "model_state": _to_cpu(sub_to_normal_bn(state.model.state_dict())),
        "optimizer_state": _to_cpu(state.optimizer.state_dict()),
        "cfg": yaml.safe_dump(cfg.to_dict()),
    }


def save_checkpoint(path_to_job: str, state, epoch: int, cfg) -> Optional[str]:
    """Save the train state after ``epoch`` (reference: :107-136); the
    master process writes, the others return None. The ``orbax`` backend
    saves asynchronously from every rank (``_save_dcp``)."""
    if cfg.TPU.CHECKPOINT_BACKEND == "orbax":
        return _save_dcp(path_to_job, state, epoch, cfg)
    if not is_master():
        return None
    make_checkpoint_dir(path_to_job)
    path = get_path_to_checkpoint(path_to_job, epoch + 1)
    torch.save(checkpoint_payload(state, epoch, cfg), path)
    logger.info("Saved checkpoint to %s", path)
    return path


def _save_dcp(path_to_job: str, state, epoch: int, cfg) -> str:
    """``checkpoint_payload`` into ``checkpoint_epoch_{e:05d}.dcp`` by
    ``torch.distributed.checkpoint.async_save``: every rank takes part
    (over a gloo group of its own in a process group, as its collectives
    run on a thread beside the caller's), the files are written while the
    caller goes on, and a save still in flight is waited for first.
    The optimizer state's keys are strings there and its param groups a
    JSON string (``load_dcp_payload`` turns them back)."""
    import torch.distributed.checkpoint as dcp

    from ..parallel import distributed

    global _pending
    wait_for_saves()
    d = get_checkpoint_dir(path_to_job)
    os.makedirs(d, exist_ok=True)
    path = get_path_to_checkpoint(path_to_job, epoch + 1, backend="orbax")
    payload = checkpoint_payload(state, epoch, cfg)
    opt = payload["optimizer_state"]
    payload["optimizer_state"] = {
        "state": {str(k): v for k, v in opt["state"].items()},
        "param_groups": json.dumps(opt["param_groups"])}
    _pending = dcp.async_save(payload, checkpoint_id=path,
                              process_group=distributed.checkpoint_group())
    if is_master():
        with open(os.path.join(d, f"cfg_epoch_{epoch + 1:05d}.yaml"),
                  "w") as f:
            f.write(payload["cfg"])
    logger.info("Async-saving checkpoint to %s", path)
    return path


def wait_for_saves() -> None:
    """Block until the in-flight async checkpoint (if any) is written
    (JAX: ``utils/checkpoint.py::wait_for_saves``)."""
    global _pending
    if _pending is not None:
        fut, _pending = _pending, None
        fut.result()


def load_dcp_payload(path: str) -> dict:
    """A ``.dcp`` checkpoint's payload, as ``checkpoint_payload`` made it
    (the optimizer state's keys back to ints), on the host."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    from ..parallel import distributed

    wait_for_saves()
    meta = dcp.FileSystemReader(path).read_metadata()
    payload: dict = {}
    for fqn, keys in meta.planner_data.items():
        info = meta.state_dict_metadata[fqn]
        node = payload
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = (
            torch.empty(tuple(info.size), dtype=info.properties.dtype)
            if isinstance(info, TensorStorageMetadata) else None)
    group = distributed.gloo_group() if distributed.initialized() else None
    dcp.load(payload, checkpoint_id=path, process_group=group,
             no_dist=group is None)
    opt = payload["optimizer_state"]
    payload["optimizer_state"] = {
        "state": {int(k): v for k, v in opt.get("state", {}).items()},
        "param_groups": json.loads(opt["param_groups"])}
    return payload


def load_optimizer_state(optimizer: torch.optim.Optimizer, state_dict):
    """``optimizer.load_state_dict``, each state tensor then kept in the
    dtype it was stored in (torch casts it to its parameter's: a bfloat16
    moment would come back as float32)."""
    optimizer.load_state_dict(state_dict)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for idx, saved in state_dict["state"].items():
        live = optimizer.state[params[idx]]
        for key, val in saved.items():
            if torch.is_tensor(val) and key in live:
                live[key] = live[key].to(val.dtype)


def _load_model(model: torch.nn.Module, state) -> None:
    """``state`` into ``model`` with ``strict=True``, its BN statistics in
    the model's form; BN step counters the file lacks (the JAX package's
    exports have none) keep the model's."""
    state = {k[len("module."):] if k.startswith("module.") else k:
             torch.as_tensor(v) for k, v in state.items()}
    target = model.state_dict()
    state = dict(adapt_bn_stats_to(target, state))
    for k, v in target.items():
        if k.endswith("num_batches_tracked"):
            state.setdefault(k, v)
    model.load_state_dict(state, strict=True)


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    cfg=None) -> int:
    """Restore ``model`` (and ``optimizer`` where given) from the run's
    checkpoint ``path`` (a ``.pyth`` or a ``.dcp``); returns the epoch it
    was taken after (0-based; -1 where the file has none). A JAX package's
    ``.jaxckpt`` or ``.orbax`` gives the model its weights (mapped with
    ``cfg``'s name table where it is an efficient family), not the
    optimizer its state (optax's layout is not torch's)."""
    if path.endswith(".jaxckpt"):
        payload = load_jax_checkpoint(path)
        _load_model(model, _jax_state_dict(payload, cfg))
        if optimizer is not None:
            logger.warning("%s: the optimizer state of a JAX checkpoint is "
                           "not restored", path)
        return int(payload.get("epoch", -1))
    if _is_orbax(path):
        payload = load_orbax_checkpoint(path)
        _load_model(model, _jax_state_dict(payload, cfg))
        if optimizer is not None:
            logger.warning("%s: the optimizer state of a JAX checkpoint is "
                           "not restored", path)
        return int(payload.get("epoch", -1))
    if path.endswith(".dcp"):
        payload = load_dcp_payload(path)
    else:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    _load_model(model, payload["model_state"])
    if optimizer is not None and "optimizer_state" in payload:
        try:
            load_optimizer_state(optimizer, payload["optimizer_state"])
        except ValueError as e:  # another optimizer than the file's
            logger.warning("Could not restore optimizer state: %s", e)
    epoch = int(payload.get("epoch", -1))
    logger.info("Loaded checkpoint %s (epoch %d)", path, epoch)
    return epoch


def load_train_checkpoint(cfg, state) -> Tuple[object, int]:
    """Auto-resume from the run's last checkpoint, else
    ``TRAIN.CHECKPOINT_FILE_PATH`` (reference: :430-455); returns (state,
    start epoch)."""
    if cfg.TRAIN.AUTO_RESUME and has_checkpoint(cfg.OUTPUT_DIR):
        path = get_last_checkpoint(cfg.OUTPUT_DIR)
        epoch = load_checkpoint(path, state.model, state.optimizer, cfg)
        return state, epoch + 1
    if cfg.TRAIN.CHECKPOINT_FILE_PATH:
        _load_external(state.model, cfg.TRAIN.CHECKPOINT_FILE_PATH,
                       cfg.TRAIN.CHECKPOINT_TYPE,
                       inflate=cfg.TRAIN.CHECKPOINT_INFLATE, cfg=cfg)
    return state, 0


def load_test_checkpoint(cfg, model: torch.nn.Module) -> None:
    """Test-time weights, in the reference's order (:392-427):
    TEST.CHECKPOINT_FILE_PATH, then the run's last checkpoint, then
    TRAIN.CHECKPOINT_FILE_PATH, else the seeded random init."""
    if cfg.TEST.CHECKPOINT_FILE_PATH:
        _load_external(model, cfg.TEST.CHECKPOINT_FILE_PATH,
                       cfg.TEST.CHECKPOINT_TYPE, cfg=cfg)
    elif has_checkpoint(cfg.OUTPUT_DIR):
        load_checkpoint(get_last_checkpoint(cfg.OUTPUT_DIR), model, cfg=cfg)
    elif cfg.TRAIN.CHECKPOINT_FILE_PATH:
        _load_external(model, cfg.TRAIN.CHECKPOINT_FILE_PATH,
                       cfg.TRAIN.CHECKPOINT_TYPE, cfg=cfg)
    else:
        logger.info("Testing with random initialization. Only for debugging.")


def load_jax_checkpoint(path: str):
    """The JAX package's ``.jaxckpt`` payload: {"epoch", "params",
    "batch_stats", "opt_state", "cfg"} with numpy leaves."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _is_orbax(path: str) -> bool:
    """A JAX package's orbax directory (not the port's ``.dcp``)."""
    return path.endswith(".orbax") or (os.path.isdir(path)
                                       and not path.endswith(".dcp"))


def _leaf_array(a) -> np.ndarray:
    """A tensorstore read as numpy torch takes: a bfloat16 leaf
    (``ml_dtypes``, which ``torch.from_numpy`` refuses) widened to float32,
    which is exact."""
    if a.dtype.name == "bfloat16":
        return np.asarray(a, dtype=np.float32)
    return np.asarray(a)


def load_orbax_checkpoint(path: str) -> dict:
    """The JAX package's orbax directory as a tree of numpy leaves,
    {"epoch", "params", "batch_stats", "opt_state"}: the leaves that
    ``_METADATA``'s ``tree_metadata`` names by their tuples of keys, each
    the zarr array at the keys joined by "." in the directory's OCDBT
    store, read through ``tensorstore``; leaves saved as None are left
    out. A directory without ``_METADATA`` raises FileNotFoundError."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(
            f"{path}: not an orbax checkpoint, it has no _METADATA file")
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"{path}: reading an orbax checkpoint needs the tensorstore "
            "package") from e
    with open(meta_path) as f:
        meta = json.load(f)
    zarr = "zarr3" if meta.get("use_zarr3") else "zarr"
    base = {"driver": "ocdbt", "base": "file://" + os.path.abspath(path)
            + "/"} if meta.get("use_ocdbt", True) else {
        "driver": "file", "path": os.path.abspath(path)}
    leaves = []  # (keys, scalar, the open's future), every open in flight
    for entry in meta["tree_metadata"].values():
        value = entry["value_metadata"]
        if value.get("skip_deserialize") or value["value_type"] == "None":
            continue
        keys = [k["key"] for k in entry["key_metadata"]]
        leaves.append((keys, value["value_type"] == "scalar", ts.open(
            {"driver": zarr, "kvstore": base, "path": ".".join(keys)},
            open=True)))
    reads = [(keys, scalar, opened.result().read())
             for keys, scalar, opened in leaves]
    tree: dict = {}
    for keys, scalar, read in reads:
        leaf = _leaf_array(read.result())
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf.item() if scalar else leaf
    return tree


def _jax_state_dict(payload, cfg=None) -> dict:
    return jax_variables_to_state_dict(
        {"params": payload["params"],
         "batch_stats": payload.get("batch_stats", {})}, cfg)


def _load_external(model: torch.nn.Module, path: str, ckpt_type: str,
                   inflate: bool = False, cfg=None) -> None:
    """Weights from another run into ``model``: a ``.pyth`` (``model_state``
    or ``state_dict``, as the reference and the JAX package read it) or,
    as type ``jax`` or by its suffix, a ``.jaxckpt``; as type ``caffe2`` a
    Caffe2 pickle, and with ``inflate`` a ``.pyth`` whose 2-D weights are
    inflated, both loaded where names and shapes fit
    (``load_matching``). ``cfg`` maps an efficient family's ``.jaxckpt``
    (``utils/weights.py::efficient_prefix_table``). A JAX package's
    ``.orbax`` directory loads as a ``.jaxckpt`` does, a ``.dcp`` as a
    ``.pyth``."""
    if _is_orbax(path):
        _load_model(model, _jax_state_dict(load_orbax_checkpoint(path), cfg))
        logger.info("Loaded the JAX orbax checkpoint %s", path)
        return
    if path.endswith(".dcp"):
        _load_model(model, load_dcp_payload(path)["model_state"])
        return
    if ckpt_type == "jax" or path.endswith(".jaxckpt"):
        _load_model(model, _jax_state_dict(load_jax_checkpoint(path), cfg))
        logger.info("Loaded the JAX checkpoint %s", path)
        return
    if ckpt_type == "caffe2":
        load_matching(model, load_caffe2_state_dict(path), path)
        return
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "model_state" in payload:
        payload = payload["model_state"]
    elif isinstance(payload, dict) and "state_dict" in payload:
        payload = payload["state_dict"]
    if inflate:
        load_matching(model, payload, path, inflate=True)
        return
    _load_model(model, payload)


def load_matching(model: torch.nn.Module, state, path: str = "",
                  inflate: bool = False) -> None:
    """Every tensor of ``model``'s state_dict that ``state`` (torch names,
    a ``module.`` prefix dropped) holds in the same shape, and with
    ``inflate`` every 5-D conv weight that it holds 2-D (O, I, kH, kW),
    repeated over the model's kT and divided by kT (reference:
    checkpoint.py:139-175); the rest keep their values. The JAX package's
    ``load_torch_checkpoint`` rules."""
    state = {re.sub(r"^module\.", "", k): v for k, v in state.items()}
    target = {k: v for k, v in model.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    new = {}
    for name, ours in target.items():
        if name not in state:
            continue
        theirs = state[name]
        if torch.is_tensor(theirs):
            theirs = theirs.detach().cpu()
        w = np.asarray(theirs, dtype=np.float32)
        if inflate and w.ndim == 4 and ours.dim() == 5:
            kt = ours.shape[2]
            w = np.repeat(w[:, :, None], kt, axis=2) / float(kt)
        if tuple(w.shape) != tuple(ours.shape):
            logger.warning("shape mismatch for %s: ours %s theirs %s", name,
                           tuple(ours.shape), w.shape)
            continue
        new[name] = torch.from_numpy(np.ascontiguousarray(w))
    model.load_state_dict(new, strict=False)
    logger.info("%s: loaded %d/%d tensors", path, len(new), len(target))


def c2_name_to_torch(name: str) -> str:
    """A Caffe2 model-zoo blob name → the reference's torch name (the
    regex rules of the reference's utils/c2_model_loading.py:9-112, as the
    JAX package's ``torch_ckpt.py::c2_name_to_torch`` has them); other
    names are returned as they are."""
    bn = {"s": "weight", "b": "bias", "rm": "running_mean",
          "riv": "running_var"}
    rules = [
        (r"^conv1_w$", lambda m: "s1.pathway0_stem.conv.weight"),
        (r"^res_conv1_bn_(s|b|rm|riv)$",
         lambda m: f"s1.pathway0_stem.bn.{bn[m.group(1)]}"),
        (r"^nonlocal_conv([0-9]+)_([0-9]+)_(theta|phi|g|out)_(w|b)$",
         lambda m: f"s{int(m.group(1))}.pathway0_nonlocal{int(m.group(2))}"
                   f".conv_{m.group(3)}."
                   f"{'weight' if m.group(4) == 'w' else 'bias'}"),
        (r"^nonlocal_conv([0-9]+)_([0-9]+)_bn_(s|b|rm|riv)$",
         lambda m: f"s{int(m.group(1))}.pathway0_nonlocal{int(m.group(2))}"
                   f".bn.{bn[m.group(3)]}"),
        (r"^res([0-9]+)_([0-9]+)_branch([0-9])([a-c])_w$",
         lambda m: f"s{int(m.group(1))}.pathway0_res{int(m.group(2))}"
                   f".branch{m.group(3)}.{m.group(4)}.weight"),
        (r"^res([0-9]+)_([0-9]+)_branch([0-9])([a-c])_bn_(s|b|rm|riv)$",
         lambda m: f"s{int(m.group(1))}.pathway0_res{int(m.group(2))}"
                   f".branch{m.group(3)}.{m.group(4)}_bn.{bn[m.group(5)]}"),
        (r"^res([0-9]+)_([0-9]+)_branch1_w$",
         lambda m: f"s{int(m.group(1))}.pathway0_res{int(m.group(2))}"
                   ".branch1.weight"),
        (r"^res([0-9]+)_([0-9]+)_branch1_bn_(s|b|rm|riv)$",
         lambda m: f"s{int(m.group(1))}.pathway0_res{int(m.group(2))}"
                   f".branch1_bn.{bn[m.group(3)]}"),
        (r"^pred_w$", lambda m: "head.projection.weight"),
        (r"^pred_b$", lambda m: "head.projection.bias"),
    ]
    for pattern, rename in rules:
        m = re.match(pattern, name)
        if m:
            return rename(m)
    return name


def load_caffe2_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A Caffe2 pickle's blobs (``{"blobs": {...}}`` or the blobs alone)
    under their torch names, momentum blobs and ``__``-names dropped."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    blobs = data.get("blobs", data)
    return {c2_name_to_torch(k): np.asarray(v) for k, v in blobs.items()
            if "momentum" not in k and not k.startswith("__")}
