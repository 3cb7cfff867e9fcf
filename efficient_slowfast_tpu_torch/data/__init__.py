from .build import DATASET_REGISTRY, build_dataset  # noqa: F401
from . import ava_dataset, datasets  # noqa: F401  (register Ava, Kinetics, Synthetic)
from .loader import construct_loader, shuffle_dataset  # noqa: F401
