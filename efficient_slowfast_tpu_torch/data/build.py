"""Dataset registry (port of ``data/build.py``; reference:
slowfast/datasets/build.py:6-31)."""

from __future__ import annotations

from ..utils.registry import Registry

DATASET_REGISTRY = Registry("DATASET")


def build_dataset(dataset_name: str, cfg, split: str):
    """name.capitalize() lookup → Dataset(cfg, split)."""
    name = dataset_name.capitalize()
    return DATASET_REGISTRY.get(name)(cfg, split)
