"""The port's video-file datasets (Kinetics, Jester) against the JAX
package's on fixture videos written here: items byte for byte in test mode
through the union decode and through per-view decodes, and in train and
val mode with JAX handed the port's draws (``random`` patched as JAX's
datasets and decoder see it, as tests/test_torch_port_frame_datasets.py
does for the frame datasets). Also the JAX package's fault that the port
repairs: a transient union failure must not mark the video as one the
union cannot serve."""

import numpy as np
import pytest

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.data import datasets as jax_datasets
from efficient_slowfast_tpu.data import decoder as jax_decoder
from efficient_slowfast_tpu.data.build import build_dataset as jax_build
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.data import datasets, decoder
from efficient_slowfast_tpu_torch.data.build import build_dataset
from test_torch_port_frame_datasets import Recorder, Replay, assert_items_equal

# (frames, height, width): landscape, portrait, wider than 2:1, and one
# whose 3 test views lie too far apart for the union (-16)
SHAPES = [(24, 45, 80), (24, 80, 40), (24, 30, 90), (120, 30, 40)]
LISTS = {"kinetics": ("train.csv", "val.csv", "test.csv"),
         "jester": ("trainlist.txt", "vallist.txt")}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    lines = []
    for i, (n, h, w) in enumerate(SHAPES):
        frames = np.random.RandomState(i).randint(0, 255, (n, h, w, 3),
                                                  np.uint8)
        path = str(root / f"v{i}.mp4")
        decoder.write_test_video(path, frames, fps=30, gop=8)
        lines.append(f"{path} {i}")
    for names in LISTS.values():
        for name in names:
            (root / name).write_text("\n".join(lines) + "\n")
    return root


def cfg_of(get, root, long_cycle=0):
    cfg = get()
    cfg.DATA.PATH_TO_DATA_DIR = str(root)
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.SAMPLING_RATE = 2
    cfg.DATA.TRAIN_JITTER_SCALES = [20, 26]
    cfg.DATA.TEST_CROP_SIZE = 20
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 3
    cfg.TEST.NUM_SPATIAL_CROPS = 3
    cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE = long_cycle
    return cfg


@pytest.mark.parametrize("name", ["kinetics", "jester"])
def test_test_items_match_jax_through_the_union(root, name):
    port = build_dataset(name, cfg_of(get_cfg, root), "test")
    jax = jax_build(name, cfg_of(jax_get_cfg, root), "test")
    assert len(port) == len(jax) == len(SHAPES) * 9
    for i in range(len(port)):
        assert_items_equal(port[i], jax[i])
    # both declined the sparse video for good, and only it
    assert port._union_unsupported == jax._union_unsupported == {
        port._path_to_videos[-1]}
    assert port._decode_width_cache == jax._decode_width_cache


def test_test_items_match_jax_through_per_view_decodes(root, monkeypatch):
    def declined(path, *args, **kwargs):
        raise decoder.UnionUnsupported(path, -14)

    monkeypatch.setattr(decoder, "decode_views", declined)
    monkeypatch.setattr(jax_decoder, "decode_views", lambda *a, **k: None)
    port = build_dataset("kinetics", cfg_of(get_cfg, root), "test")
    jax = jax_build("kinetics", cfg_of(jax_get_cfg, root), "test")
    for i in range(len(port)):
        assert_items_equal(port[i], jax[i])
    keys = list(port._test_decode_memo._entries)
    assert keys and all(isinstance(k, tuple) for k in keys)


@pytest.mark.parametrize("name, mode, long_cycle", [
    ("kinetics", "train", 0), ("kinetics", "train", 4), ("kinetics", "val", 0),
    ("jester", "train", 0), ("jester", "val", 0)])
def test_train_and_val_items_match_jax_given_the_draws(
        root, monkeypatch, name, mode, long_cycle):
    log = []
    orig = datasets.CanvasDataset._rng
    monkeypatch.setattr(datasets.CanvasDataset, "_rng",
                        lambda self, index: Recorder(orig(self, index), log))
    port = build_dataset(name, cfg_of(get_cfg, root, long_cycle), mode)
    jax = jax_build(name, cfg_of(jax_get_cfg, root, long_cycle), mode)
    for epoch in range(2):
        port.set_epoch(epoch)
        for i in range(len(port)):
            log.clear()
            got = port[i]
            replay = Replay(log)
            with monkeypatch.context() as m:
                m.setattr(jax_datasets, "random", replay)
                m.setattr(jax_decoder, "random", replay)
                want = jax[i]
            assert not replay.log
            # the long cycle's rate, the window, the crop's position
            assert [k for k, _, _ in log] == (
                ["randint"] if long_cycle else []) + ["random", "random"]
            assert_items_equal(got, want)
            assert got["frames"].shape == (4, 26, 52, 3)


def test_a_transient_union_failure_leaves_the_union_to_retry(root,
                                                             monkeypatch):
    """One failed union decode (None: a read that may succeed next time)
    falls through to the per-view decodes and the next item tries the
    union again; JAX marks the video as one the union cannot serve."""
    calls = {"port": 0, "jax": 0}

    def flaky(real, who):
        def decode(*args, **kwargs):
            calls[who] += 1
            return None if calls[who] == 1 else real(*args, **kwargs)
        return decode

    monkeypatch.setattr(decoder, "decode_views",
                        flaky(decoder.decode_views, "port"))
    monkeypatch.setattr(jax_decoder, "decode_views",
                        flaky(jax_decoder.decode_views, "jax"))
    port = build_dataset("kinetics", cfg_of(get_cfg, root), "test")
    jax = jax_build("kinetics", cfg_of(jax_get_cfg, root), "test")
    for i in range(9):  # the nine views of the first video
        assert_items_equal(port[i], jax[i])
    path = port._path_to_videos[0]
    assert path in jax._union_unsupported and calls["jax"] == 1
    assert path not in port._union_unsupported and calls["port"] == 2
    assert path in port._test_decode_memo._entries  # the union serves it


def test_a_missing_video_retries_then_raises(root, tmp_path):
    (tmp_path / "test.csv").write_text(f"{tmp_path}/none.mp4 0\n")
    cfg = cfg_of(get_cfg, root)
    cfg.DATA.PATH_TO_DATA_DIR = str(tmp_path)
    with pytest.raises(RuntimeError, match="after 10 retries"):
        build_dataset("kinetics", cfg, "test")[0]
