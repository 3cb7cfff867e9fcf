from .build import MODEL_REGISTRY, build_model, get_compute_dtype  # noqa: F401
from . import slowfast  # noqa: F401  (registers SlowFast, ResNet)
from . import cmda  # noqa: F401  (registers SlowFastDualAttention)
from . import shufflenetv2  # noqa: F401  (registers SlowFastShuffleNetV2)
from . import shufflenet  # noqa: F401  (registers SlowFastShuffleNet)
from . import mobilenetv2  # noqa: F401  (registers SlowFastMoibleNetV2)
from . import ghostnet  # noqa: F401  (registers SlowFastGhostNet)
