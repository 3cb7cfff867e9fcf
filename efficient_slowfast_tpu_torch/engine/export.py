"""Serving export: the serving forward as a ``torch.export`` artifact
(port of ``engine/export.py``).

``export_serving`` traces the eval forward of a model, its weights (and,
under ``TPU.FUSED_EVAL``, the fused engine's BN-folded tensors, and under
``TPU.INT8_EVAL`` the calibrated ranges and the weight codes) baked in as
the artifact's constants, with a symbolic batch, and saves it with
``torch.export.save``. The graph holds the port's kernels as the
``torch.library`` ops ``esf_torch::fused_bottleneck`` (K1),
``esf_torch::flash_attention`` (K2) and ``esf_torch::int8_conv`` (K3); the
artifact carries the graph and the weights, not the kernels' code, so
``load_serving`` imports the port's kernel modules, which register the ops,
before it loads one. Each op runs its kernel on a CUDA tensor and its plain
version on a CPU tensor, so where the artifact runs decides which.

The contract is ``make_forward``'s: pathway inputs ``[slow (b, T/α, S, S,
3), fast (b, T, S, S, 3)]`` (one pathway for the single-pathway ResNets)
to scores (b, classes); with ``DETECTION.ENABLE`` it also takes canvas
boxes (b, max_boxes, 4) and returns per-box scores (b·max_boxes,
classes), ``make_detection_forward``'s (padded boxes score rows the caller
drops). The inputs may be of any float dtype: the graph casts them to the
compute dtype. ``torch.export`` specializes a dimension of size 1, so the
batch is traced at 2 with a symbolic size of at least 2, and
``ServingModel`` serves a 1-clip request by repeating the clip and keeping
the first row(s): BN is frozen, so the clips of a batch do not meet.
"""

from __future__ import annotations

import os
import time

import torch

from ..models.build import get_compute_dtype, resolve_device
from ..parallel import distributed, spatial
from ..utils.logging import get_logger

logger = get_logger(__name__)

SUFFIX = ".pt2"


class _Classifier(torch.nn.Module):
    def __init__(self, fwd, dtype):
        super().__init__()
        self.fwd, self.dtype = fwd, dtype

    def forward(self, inputs):
        return self.fwd([x.to(self.dtype) for x in inputs])


class _Detector(torch.nn.Module):
    def __init__(self, model, dtype):
        super().__init__()
        self.model, self.dtype = model, dtype

    def forward(self, inputs, boxes):
        from .state import flatten_rois

        return self.model([x.to(self.dtype) for x in inputs],
                          flatten_rois(boxes.to(torch.float32)))


def _serving_int8(cfg, model, quant):
    """Give an int8 model its ranges (``quant``, else its own, else the
    persisted calibration) and its weight codes; refuse without a
    calibration, as ``engine/export.py:66-80`` there."""
    from ..ops.conv import int8_convs, quant_is_calibrated
    from .quantize import calibration_path, load_calibration, load_quant_state

    if quant is None and not quant_is_calibrated(model):
        quant = load_calibration(cfg, model)
    if quant is not None:
        load_quant_state(model, quant)
    assert quant_is_calibrated(model), (
        "TPU.INT8_EVAL export needs a calibrated model: run "
        "engine.quantize.calibrate_int8 and pass its state as quant=, or "
        "serve once with TPU.INT8_EVAL so the calibration persists at "
        f"{calibration_path(cfg)} (a persisted file is also rejected when "
        "its fingerprint does not match this checkpoint/config)")
    for conv in int8_convs(model).values():
        conv.weight_codes()  # the codes the graph bakes in


def _unsplit(cfg, model, dev):
    """(cfg, model) as one process serves them: ``cfg`` with
    ``TPU.SPATIAL_SHARD`` 0, and a model built from it (``build_model``
    splits every forward of a model under the split) on ``dev`` holding
    ``model``'s state dict and, where calibrated, its int8 ranges."""
    from ..models import build_model
    from ..ops.conv import quant_is_calibrated
    from .quantize import load_quant_state, quant_state

    cfg = cfg.clone()
    cfg.TPU.SPATIAL_SHARD = 0
    twin = build_model(cfg, dev)
    twin.load_state_dict(model.state_dict(), strict=True)
    if quant_is_calibrated(model):
        load_quant_state(twin, quant_state(model))
    return cfg, twin


def export_serving(cfg, model, out_path: str, quant=None,
                   max_boxes: int = 32, device=None) -> str:
    """Export the serving forward of ``model`` to ``out_path`` (``.pt2``
    appended if missing); returns the path written.

    ``device``: where the artifact is traced and its constants live (the
    GPU by default, JAX's ``platforms=``). ``quant``: the ranges of a
    ``TPU.INT8_EVAL`` model (``engine/quantize.py``'s quant state); without
    it the model's own ranges, else the persisted calibration
    (fingerprint-checked), else the export refuses. ``max_boxes``:
    detection only, the static box slots a clip.

    Under ``TPU.SPATIAL_SHARD`` the artifact is the one-device serving
    graph, as JAX's (its ``ShapeDtypeStruct`` specs carry no sharding):
    the master traces a model built without the split (``_unsplit``) that
    holds the same state and ranges (the space group's, after a split
    calibration), and every other rank of the job waits for the file at a
    barrier.
    """
    dev = resolve_device(device)
    if spatial.spatial_shard(cfg) > 1:
        if distributed.is_master():
            cfg, model = _unsplit(cfg, model, dev)
            out_path = export_serving(cfg, model, out_path, quant,
                                      max_boxes, dev)
        distributed.host_barrier("serving export")
        return out_path if out_path.endswith(SUFFIX) else out_path + SUFFIX
    dtype = get_compute_dtype(cfg)
    model = model.to(dev).eval()
    if cfg.TPU.INT8_EVAL:
        _serving_int8(cfg, model, quant)
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    frames = [t]
    if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH:
        frames = [t // cfg.SLOWFAST.ALPHA, t]
    example = [torch.zeros((2, f, s, s, 3), device=dev) for f in frames]
    batch = torch.export.Dim("b", min=2)
    paths = [{0: batch} for _ in example]
    if cfg.DETECTION.ENABLE:
        module = _Detector(model, dtype)
        edge = torch.linspace(0, s / 2, max_boxes, device=dev)
        boxes = torch.stack([edge, edge, edge + s / 2, edge + s / 2], -1)
        args, dynamic = (example, boxes.expand(2, -1, -1).contiguous()), (
            paths, {0: batch})
    else:
        fwd = model
        if cfg.TPU.FUSED_EVAL:
            assert not cfg.TPU.INT8_EVAL, (
                "TPU.FUSED_EVAL and TPU.INT8_EVAL are mutually exclusive")
            from .inference import make_fused_eval_forward, supports

            if supports(cfg):
                fwd = make_fused_eval_forward(cfg, model)
        module = _Classifier(fwd, dtype)
        args, dynamic = (example,), (paths,)
    t0 = time.perf_counter()
    with torch.no_grad():
        # a guard that the symbolic reasoning cannot prove for every batch
        # (torch 2.11 cannot show min(16 b, 112 b) == 16 b inside the RoI
        # head's products) becomes an assert checked at run time
        program = torch.export.export(
            module, args, dynamic_shapes=dynamic,
            prefer_deferred_runtime_asserts_over_guards=True)
    program.example_inputs = None  # zeros: not worth the artifact's bytes
    if not out_path.endswith(SUFFIX):
        out_path += SUFFIX
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(program, out_path)
    logger.info(
        "Exported %s serving forward (%s, %s, %d classes, %.1f MB, %.1f s) "
        "to %s", "detection" if cfg.DETECTION.ENABLE else "classification",
        "int8" if cfg.TPU.INT8_EVAL else str(dtype).replace("torch.", ""),
        dev, cfg.MODEL.NUM_CLASSES, os.path.getsize(out_path) / 1e6,
        time.perf_counter() - t0, out_path)
    return out_path


def _register_ops() -> None:
    """Import the kernel modules: each registers its ``esf_torch`` op."""
    from ..ops.kernels import (flash_attention, fused_bottleneck,  # noqa: F401
                               int8_conv)


class ServingModel:
    """A loaded serving artifact: ``scores = serving(pathways)`` (and the
    boxes for a detection artifact), host numpy out, as JAX's.

    ``device``: where it runs (default: where it was exported); a program
    exported on one device is moved to another by
    ``torch.export.passes.move_to_device_pass``. Inputs (numpy or tensors)
    are moved there as float32; a batch of 1 is served as 2 (see the
    module's docstring). ``program`` is the loaded ``ExportedProgram``.
    """

    def __init__(self, path: str, device=None):
        _register_ops()
        program = torch.export.load(path)
        consts = list(program.state_dict.values()) + list(
            program.constants.values())
        here = next(c.device for c in consts if isinstance(c, torch.Tensor))
        if device is not None and torch.device(device) != here:
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, torch.device(device))
            here = torch.device(device)
        self.device = here
        self.program = program
        self._module = program.module()

    def __call__(self, inputs, *rest):
        def put(x):
            return torch.as_tensor(x).to(self.device, torch.float32)

        inputs, rest = [put(x) for x in inputs], [put(r) for r in rest]
        b = inputs[0].shape[0]
        if b == 1:  # the artifact's batch is at least 2
            inputs = [torch.cat([x, x]) for x in inputs]
            rest = [torch.cat([r, r]) for r in rest]
        with torch.inference_mode():
            out = self._module(inputs, *rest)
        if b == 1:
            out = out[:out.shape[0] // 2]
        return out.float().cpu().numpy()


def load_serving(path: str, device=None) -> ServingModel:
    return ServingModel(path, device)
