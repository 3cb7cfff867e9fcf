"""Model registry + build (reference: slowfast/models/build.py:9-44).

``build_model(cfg, device)`` returns the ``nn.Module`` on ``device``. The
device defaults to the GPU; where there is none, the CPU has to be asked
for by name, so that a run meant for the card never goes on silently
without it.

Under ``TPU.SPATIAL_SHARD`` the model splits the pathways it is given
(``parallel/spatial.py::constrain``) before its forward: whatever calls it,
it never runs unsplit.
"""

from __future__ import annotations

import torch

from ..ops.conv import enable_int8
from ..parallel import spatial
from ..utils.registry import Registry

MODEL_REGISTRY = Registry("MODEL")


def get_compute_dtype(cfg) -> torch.dtype:
    name = cfg.TPU.COMPUTE_DTYPE
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the GPU, which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def build_model(cfg, device=None) -> torch.nn.Module:
    dev = resolve_device(device)
    model = enable_int8(MODEL_REGISTRY.get(cfg.MODEL.MODEL_NAME)(
        cfg.static()), cfg)
    if spatial.spatial_shard(cfg) > 1:
        model.register_forward_pre_hook(
            lambda m, args: (spatial.constrain(cfg, args[0]),) + args[1:])
    return model.to(dev, memory_format=torch.channels_last_3d)
