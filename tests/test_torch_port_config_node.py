"""The port's config node (``config/node.py``) against the JAX package's:
freezing and thawing, the sorted-key YAML dump byte for byte, the dump's
round trip, and ``merge_from_file``'s ``allow_unsafe`` flag."""

import pytest
import yaml

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu_torch.config import get_cfg, load_cfg

AVA_DEMO = "demo/AVA/SLOWFAST_32x2_R101_50_50.yaml"


def test_freeze_defrost_and_assignment():
    cfg = get_cfg()
    assert not cfg.is_frozen() and not cfg.TRAIN.is_frozen()
    cfg.freeze()
    assert cfg.is_frozen() and cfg.TRAIN.is_frozen()
    with pytest.raises(AttributeError):
        cfg.TRAIN.BATCH_SIZE = 1
    with pytest.raises(AttributeError):
        del cfg.TRAIN.BATCH_SIZE
    cfg.defrost()
    assert not cfg.is_frozen() and not cfg.DEMO.is_frozen()
    cfg.TRAIN.BATCH_SIZE = 1
    assert cfg.TRAIN.BATCH_SIZE == 1


@pytest.mark.parametrize("path", [None, AVA_DEMO])
def test_dump_is_jax_dump_byte_for_byte(path):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    if path:
        cfg.merge_from_file(path)
        jcfg.merge_from_file(path)
    text = cfg.dump()
    assert text == jcfg.dump()
    assert yaml.safe_load(text) == cfg.to_dict()
    lines = [line for line in text.splitlines() if not line.startswith(" ")]
    assert lines == sorted(lines)  # top-level keys in order


def test_dump_round_trips_through_a_file(tmp_path):
    cfg = load_cfg(AVA_DEMO, ["DEMO.DATA_SOURCE", "clip.mp4"])
    path = tmp_path / "dumped.yaml"
    path.write_text(cfg.dump())
    again = get_cfg()
    again.merge_from_file(str(path), allow_unsafe=True)
    assert again.to_dict() == cfg.to_dict()
    assert again.DEMO.DATA_SOURCE == "clip.mp4"
    assert again.DETECTION.ENABLE and again.RESNET.DEPTH == 101
