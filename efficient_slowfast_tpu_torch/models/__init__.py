from .build import MODEL_REGISTRY, build_model, get_compute_dtype  # noqa: F401
from . import slowfast  # noqa: F401  (registers SlowFast)
from . import cmda  # noqa: F401  (registers SlowFastDualAttention)
