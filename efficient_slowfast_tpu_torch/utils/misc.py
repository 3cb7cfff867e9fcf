"""Misc utilities (port of ``utils/misc.py``; reference: slowfast/utils/misc.py).

``launch_job`` runs a job as the reference does: one process per GPU,
``NUM_GPUS`` of them on each of ``NUM_SHARDS`` machines, joined into one
process group (``parallel/distributed.py``). ``NUM_GPUS`` counts processes
on a machine here, where the JAX package counts the devices of its one
process.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..parallel import distributed
from .logging import get_logger

logger = get_logger(__name__)


def _rank_device(device, local_rank: int) -> torch.device:
    """The device of local rank ``local_rank``: ``cuda:local_rank`` where
    ``device`` is the GPU with no index, else ``device`` itself (two ranks
    given ``cuda:0`` share that GPU, over gloo)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank)
    return device


def _run(local_rank: int, cfg, init_method: str, func: Callable, device):
    """``func`` as local rank ``local_rank`` of the job: in a process group
    where the job has more than one process, which it leaves when ``func``
    returns or raises."""
    if device is None:  # a host job: func(cfg), its processes on the CPU
        dev, call = torch.device("cpu"), lambda: func(cfg)
    else:
        dev = _rank_device(device, local_rank)
        call = lambda: func(cfg, device=dev)  # noqa: E731
    if distributed.job_size(cfg) == 1:
        return call()
    distributed.init_distributed(cfg, local_rank, dev, init_method)
    try:
        return call()
    finally:
        distributed.destroy_distributed()


def launch_job(cfg, init_method: str, func: Callable, device=None):
    """Run ``func(cfg, device=...)`` (``func(cfg)`` where ``device`` is
    None: a job of the host alone) as this machine's ``NUM_GPUS``
    processes of the job (reference :275-303): with ``NUM_GPUS`` > 1 it
    spawns them (``torch.multiprocessing``) and returns None; otherwise it
    runs here, joining the job's group where ``NUM_SHARDS`` > 1, and
    returns what ``func`` returns.

    The job is the JAX package's ``(data, space)`` mesh
    (``distributed.job_size``): on one machine whose ``NUM_GPUS`` exceed
    ``TPU.DATA_AXIS x TPU.SPATIAL_SHARD`` it starts only that many, as JAX
    leaves those devices out of its mesh; a job of several machines must
    match it, and a world that the space axis does not divide raises."""
    n = distributed.job_size(cfg)
    n = n if cfg.NUM_SHARDS == 1 else cfg.NUM_GPUS
    if n > 1:
        torch.multiprocessing.spawn(
            _run, nprocs=n, args=(cfg, init_method, func, device),
            daemon=False)
        return None
    return _run(0, cfg, init_method, func, device)


def check_nan_losses(loss: float):
    """reference: misc.py:26-33."""
    if math.isnan(loss):
        raise RuntimeError("ERROR: Got NaN losses")


def params_count(model: torch.nn.Module) -> int:
    """The number of parameters (reference: misc.py:36-42)."""
    return sum(p.numel() for p in model.parameters())


def gpu_mem_usage() -> float:
    """The most memory the card has held for tensors, in GiB (reference:
    misc.py:45-54); 0 without a card."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / 1024 ** 3


def cpu_mem_usage():
    """(used, total) host memory in GiB (reference: misc.py:57-68); zeros
    where ``psutil`` is missing."""
    try:
        import psutil
    except ImportError:
        return 0.0, 0.0
    vram = psutil.virtual_memory()
    return (vram.total - vram.available) / 1024 ** 3, vram.total / 1024 ** 3


def register_kernel_flops() -> None:
    """Give ``torch.utils.flop_counter`` the FLOPs of the port's kernel ops
    (K1 ``esf_torch::fused_bottleneck``, K2 ``esf_torch::flash_attention``,
    K3 ``esf_torch::int8_conv``), each what its
    plain version's products count: the counter sees an op, not the ops
    inside its CPU version, so without these it would count none of that
    work on either device."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    from ..ops.kernels import fused_bottleneck as k1
    from ..ops.kernels import flash_attention as k2
    from ..ops.kernels import int8_conv as k3

    ops = torch.ops.esf_torch
    if ops.fused_bottleneck in flop_registry:
        return

    @register_flop_formula(ops.fused_bottleneck)
    def _k1(x_shape, t_len, wa_shape, ba_shape, wb_shape, bb_shape,
            wc_shape, bc_shape, wp_shape, bp_shape, out_shape=None, **kw):
        n, h, w, cin = x_shape
        kt, _, ci = wa_shape
        return k1.flops(n, h, w, cin, ci, wc_shape[-1], kt,
                        wp_shape is not None)

    @register_flop_formula(ops.flash_attention)
    def _k2(q_shape, k_shape, v_shape, with_lse, out_shape=None, **kw):
        b, n, d = q_shape
        return k2.flops(b, n, k_shape[1], d, v_shape[2])

    @register_flop_formula(ops.int8_conv)
    def _k3(x_shape, codes_shape, scale_shape, act_shape, bias_shape, kernel,
            stride, padding, out_dtype, accumulate, out_shape=None, **kw):
        return k3.conv_flops(x_shape, codes_shape[0], kernel, stride, padding)


def _forward_under(modes, model, example_inputs, bboxes):
    """One eval forward of ``model`` with every dispatch mode of ``modes``
    (a counter each) watching it."""
    import contextlib

    was_training = model.training
    model.eval()
    with torch.no_grad(), contextlib.ExitStack() as stack:
        for mode in modes:
            stack.enter_context(mode)
        if bboxes is None:
            model(example_inputs)
        else:
            model(example_inputs, bboxes)
    model.train(was_training)


def _flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    register_kernel_flops()
    return FlopCounterMode(display=False)


def _activation_counter():
    """A dispatch mode that adds up the elements that convolutions and
    matrix products produce: the activation count (fvcore's ActivationCountAnalysis, which the
    reference logs, misc.py:109-150; JAX's ``get_activation_stats`` counts
    its conv_general_dilated and dot_general outputs, misc.py:60-113
    there), each kernel op's output counted as one product's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    counted = {aten.convolution.default, aten._convolution.default,
               aten.mm.default, aten.bmm.default, aten.addmm.default,
               aten.baddbmm.default}
    kernels = {"esf_torch::fused_bottleneck", "esf_torch::flash_attention",
               "esf_torch::int8_conv"}

    class ActivationCount(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in counted or func._schema.name in kernels:
                first = out[0] if isinstance(out, (tuple, list)) else out
                self.total += first.numel()
            return out

    return ActivationCount()


def get_flop_stats(model: torch.nn.Module, example_inputs,
                   bboxes=None) -> float:
    """FLOPs of one eval forward on ``example_inputs``, counted by
    ``torch.utils.flop_counter`` (reference: fvcore's flop_count,
    misc.py:109-150). The JAX package reads XLA's cost analysis of the
    compiled program instead; the counter here counts the aten matmuls and
    convolutions as torch dispatches them, and the port's kernel ops by
    their formulas (``register_kernel_flops``), so a CPU and a CUDA run
    count the same. A detection model takes ``bboxes``, its RoIs."""
    counter = _flop_counter()
    _forward_under([counter], model, example_inputs, bboxes)
    return float(counter.get_total_flops())


def flops_table(counter) -> str:
    """The per-module FLOPs of a ``FlopCounterMode`` that watched a
    forward as a table (the port's counterpart of JAX's ``nn.tabulate``
    table, misc.py:116-136 there; reference: ptflops' per-layer dump,
    misc.py:153-162): every module that did counted work, by its path,
    with its share of the total."""
    counts = counter.get_flop_counts()
    total = sum(counts.get("Global", {}).values()) or 1
    rows = sorted((name, sum(ops.values())) for name, ops in counts.items()
                  if name != "Global")
    width = max(len(name) for name, _ in rows)
    lines = [f"{'module':{width}s}  {'GFLOPs':>10s}  {'share':>7s}"]
    lines += [f"{name:{width}s}  {flops / 1e9:10.4f}  "
              f"{100 * flops / total:6.2f}%" for name, flops in rows]
    return "\n".join(lines)


def get_class_names(path, parent_path=None, subset_path=None):
    """(names, parents, subset): the class names in index order from a
    json {name: index}, the parent-category json at ``parent_path`` and the
    subset list at ``subset_path`` (one name a line), each None where not
    given (reference: misc.py:306-375)."""
    import json

    with open(path, "r") as f:
        class2idx = json.load(f)
    names = [None] * (max(class2idx.values()) + 1)
    for k, i in class2idx.items():
        names[i] = k
    parent, subset = None, None
    if parent_path:
        with open(parent_path, "r") as f:
            parent = json.load(f)
    if subset_path:
        with open(subset_path, "r") as f:
            subset = [line.strip() for line in f]
    return names, parent, subset


def load_demo_labels(path):
    """The class names of DEMO.LABEL_FILE_PATH, by class index: an
    ``id,name`` CSV (Kinetics, Jester: names in row order, as the
    reference's ``pd.read_csv(...)["name"].values``, so Jester's 1-based
    ids still give class k row k) or one name a line (AVA's ``.names``)
    (reference: tools/demo_net.py:141-150)."""
    with open(path) as f:
        lines = [line.rstrip("\n") for line in f if line.strip()]
    if not lines:
        return []
    header = [c.strip().lower() for c in lines[0].split(",")]
    if "name" in header and len(header) > 1:
        col = header.index("name")
        return [line.split(",", len(header) - 1)[col].strip()
                for line in lines[1:]]
    return [line.strip() for line in lines]


def flops_per_layer_table(model: torch.nn.Module, example_inputs,
                          bboxes=None) -> str:
    """``flops_table`` of one eval forward on ``example_inputs`` (JAX:
    ``flops_per_layer_table``, misc.py:116-136 there; reference: ptflops'
    per-layer dump, misc.py:153-162)."""
    counter = _flop_counter()
    _forward_under([counter], model, example_inputs, bboxes)
    return flops_table(counter)


def log_model_info(model: torch.nn.Module, cfg, example_inputs):
    """Parameters, memory, FLOPs and activations, and with
    ``TPU.LOG_FLOPS_PER_LAYER`` the per-module FLOPs table (reference:
    misc.py:165-190; JAX: misc.py:160-178), all from one forward."""
    logger.info("Model:\n%s", type(model).__name__)
    logger.info("Params: %s", f"{params_count(model):,}")
    logger.info("Mem: %.2f GB", gpu_mem_usage())
    bboxes = None
    if cfg.DETECTION.ENABLE:  # one RoI over the first clip's whole crop
        s = float(example_inputs[0].shape[2])
        bboxes = torch.tensor([[0.0, 0.0, 0.0, s, s]],
                              device=example_inputs[0].device)
    flops, acts = _flop_counter(), _activation_counter()
    _forward_under([flops, acts], model, example_inputs, bboxes)
    logger.info("Flops: %.2f G", flops.get_total_flops() / 1e9)
    logger.info("Activations: %.2f M", acts.total / 1e6)
    if cfg.TPU.LOG_FLOPS_PER_LAYER:
        logger.info("\n%s", flops_table(flops))
    used, total = cpu_mem_usage()
    logger.info("CPU mem: %.2f / %.2f GB", used, total)
