"""Post-training int8 calibration for ``TPU.INT8_EVAL`` serving (port of
``engine/quantize.py``).

A model built with ``TPU.INT8_EVAL`` serves its int8 convs
(``ops/conv.py``) from a static per-layer activation range, ``act_max``, a
non-persistent buffer of each conv. Calibration runs the float path over a
few batches with every int8 conv in ``calibrating`` mode, each raising its
``act_max`` to the largest |x| it sees; the serving engines calibrate once
and persist the ranges beside the checkpoints, keyed by a fingerprint of
the weights, so that later runs load them.

The port's quant state is a dict {"<conv>.act_max": 0-d float32 tensor},
by the conv's state-dict name (``utils/weights.py::jax_quant_to_port``
carries JAX's ``quant`` collection to it and back).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict

import numpy as np
import torch

from ..ops.conv import int8_convs, quant_is_calibrated
from ..utils.flax_msgpack import msgpack_restore, msgpack_serialize

def quant_state(model) -> Dict[str, torch.Tensor]:
    """{"<conv>.act_max": range} of every int8 conv of ``model``."""
    return {f"{name}.act_max": m.act_max.detach().clone()
            for name, m in int8_convs(model).items()}


def load_quant_state(model, quant: Dict[str, torch.Tensor]) -> None:
    """Set each int8 conv's range from ``quant``, which must name every
    int8 conv of ``model`` and nothing else."""
    convs = int8_convs(model)
    want = {f"{name}.act_max" for name in convs}
    if set(quant) != want:
        raise KeyError(f"quant state names {sorted(set(quant) ^ want)[:4]} "
                       "do not match the model's int8 convs")
    with torch.no_grad():
        for name, m in convs.items():
            m.act_max.copy_(torch.as_tensor(quant[f"{name}.act_max"],
                                            dtype=torch.float32))


def calibrate_int8(model, batches) -> Dict[str, torch.Tensor]:
    """Record each int8 conv's activation range over ``batches``: each a
    [slow, fast] pathway list, or an (inputs, rois) tuple for detection
    models, on the model's device in the compute dtype. The ranges start
    from 0. Returns the quant state; raises if there was no batch or no
    int8 conv recorded a range (a model built without TPU.INT8_EVAL)."""
    convs = int8_convs(model).values()
    if not convs:
        raise ValueError("calibration recorded no activation ranges: was the "
                         "model built with cfg.TPU.INT8_EVAL=True?")
    was_training = model.training
    model.eval()
    n = 0
    try:
        with torch.no_grad():
            for m in convs:
                m.act_max.zero_()
                m.calibrating = True
            for inputs in batches:
                model(*(inputs if isinstance(inputs, tuple) else (inputs,)))
                n += 1
    finally:
        for m in convs:
            m.calibrating = False
        model.train(was_training)
    if n == 0:
        raise ValueError("calibrate_int8 needs at least one batch")
    if not quant_is_calibrated(model):
        raise ValueError("calibration left an int8 conv with a zero range")
    return quant_state(model)


def calibration_path(cfg) -> str:
    """Where the serving engines persist the ranges; beside the JAX
    package's ``int8_calibration.msgpack``, under its own name, so the two
    packages may share an OUTPUT_DIR."""
    return os.path.join(cfg.OUTPUT_DIR, "checkpoints",
                        "int8_calibration.torch.msgpack")


def _fingerprint(cfg, model) -> str:
    """Identity of the quantized model: its state-dict names, a digest of
    every tensor's values (float64 sums on the host, which do not depend on
    the device the model sits on), and the knobs that change the quant
    layout or the input distribution. A mismatch means recalibrate."""
    sd = model.state_dict()
    h = hashlib.sha1("|".join(sd).encode())
    sums = np.array([t.detach().double().cpu().sum().item()
                     for t in sd.values()], np.float64)
    h.update(sums.tobytes())
    h.update((f"|spatial={bool(cfg.TPU.INT8_SPATIAL)}"
              f"|frames={cfg.DATA.NUM_FRAMES}"
              f"|crop={cfg.DATA.TEST_CROP_SIZE}").encode())
    return h.hexdigest()


def load_calibration(cfg, model):
    """The persisted quant state, or None if absent, unreadable,
    uncalibrated, or written for another model or config (fingerprint)."""
    path = calibration_path(cfg)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            payload = msgpack_restore(f.read())
        if payload.get("fingerprint") != _fingerprint(cfg, model):
            return None
        quant = {k: torch.tensor(np.float32(v))
                 for k, v in payload["quant"].items()}
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return None  # a corrupt file: recalibrate rather than crash
    if not quant or any(float(v) <= 0.0 for v in quant.values()):
        return None
    return quant


def save_calibration(cfg, model, quant) -> str:
    path = calibration_path(cfg)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"fingerprint": _fingerprint(cfg, model),
               "quant": {k: np.asarray(float(v), np.float32)
                         for k, v in quant.items()}}
    with open(path, "wb") as f:
        f.write(msgpack_serialize(payload))
    return path


def calibrate_for_test(cfg, model, device):
    """The serving engines' calibration: the ranges over the first
    ``TPU.INT8_CALIB_BATCHES`` batches of a fresh test loader, preprocessed
    as the test preprocesses them (read, not scored: the test runs its own
    loader from the start). Returns the quant state."""
    from ..data.loader import construct_loader, prefetch_to_device
    from ..data.preprocess import (make_detection_preprocess,
                                   make_test_preprocess)
    from ..models.build import get_compute_dtype
    from .state import flatten_rois

    n = max(1, int(cfg.TPU.INT8_CALIB_BATCHES))
    dtype = get_compute_dtype(cfg)
    loader = construct_loader(cfg, "test")
    detection = cfg.DETECTION.ENABLE
    preprocess = (make_detection_preprocess if detection
                  else make_test_preprocess)(cfg, dtype)

    def batches():
        it = prefetch_to_device(loader, device, depth=1)
        try:
            for i, batch in enumerate(it):
                if detection:
                    rois = flatten_rois(batch["boxes"].to(
                        device, torch.float32))
                    yield (preprocess(batch["frames"]), rois)
                else:
                    yield preprocess(batch["frames"], batch["width"],
                                     batch["spatial_idx"], batch["portrait"])
                if i + 1 == n:
                    return
        finally:
            it.close()

    return calibrate_int8(model, batches())
