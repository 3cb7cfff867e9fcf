from .build import DATASET_REGISTRY, build_dataset  # noqa: F401
# register Ava; Kinetics, Jester, Synthetic and the frame folders; Ssv2, Charades
from . import ava_dataset, datasets, frame_datasets  # noqa: F401
from .loader import construct_loader, shuffle_dataset  # noqa: F401
