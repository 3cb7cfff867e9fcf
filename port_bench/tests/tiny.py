"""Tiny versions of the benchmark's configurations for the CPU tests:
width 16, 8 frames, 64x64, 12 classes, float32 (or bf16) and the
attention on its streaming path from 64 tokens."""

from __future__ import annotations

import copy

from port_bench import manifest


def config(name: str, dtype: str = "float32") -> dict:
    cfg = copy.deepcopy(manifest.read_json(
        f"{manifest.HERE}/configs/{name}.json"))
    c = cfg["cfg"]
    c["RESNET"]["WIDTH_PER_GROUP"] = 16
    c["DATA"].update(NUM_FRAMES=8, TRAIN_CROP_SIZE=64, TEST_CROP_SIZE=64,
                     CROP_SIZE=64)
    c["MODEL"]["NUM_CLASSES"] = 12
    cfg["overrides"] = dict(cfg["overrides"], **{
        "TPU.COMPUTE_DTYPE": dtype, "TPU.FLASH_MIN_TOKENS": 64})
    return cfg


def mix(name: str, **changes) -> dict:
    m = manifest.read_json(f"{manifest.HERE}/traffic/{name}.json")
    m.update(batch=2 if m["kind"] != "train_step" else 4, pool=3,
             sample_clips=4)
    m.update(changes)
    return m


def driver(config_name: str, mix_name: str, seed: int = 7, limits=None,
           dtype: str = "float32", **changes):
    m = mix(mix_name, **changes)
    cell = {"config": config_name, "traffic": mix_name, "chips": 1,
            "limits": limits or {}}
    return manifest.driver_class(m["kind"])(cell, m, config(config_name,
                                                            dtype),
                                            seed, "cpu")
