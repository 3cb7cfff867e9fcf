from .build import DATASET_REGISTRY, build_dataset  # noqa: F401
from . import datasets  # noqa: F401  (registers Kinetics, Synthetic)
from .loader import construct_loader, shuffle_dataset  # noqa: F401
