"""The port's frame datasets against the JAX package's on fixtures of JPEG
frames written with PIL (as tests/test_frame_datasets.py writes them): the
frame-list helpers, Ssv2 and Charades, the frame folders (Framefolder,
Wheel, Tired, Wheel_gray) with DATA.HALF_FACE and DATA.GRAY_STYLE, the
host transforms, the loader's preallocated path, and the Smoke yaml's
frame-folder reads.

Items must be byte-identical. Test mode draws nothing and is compared as
it is. Train and val modes draw: the port from its per-item
``np.random.Generator``, JAX from the global ``random`` and ``np.random``.
There the port's draws are recorded and handed to JAX in the same order
(``random`` and ``np.random`` patched as JAX's modules see them), each
checked to be the same kind of draw over the same range."""

import json
import os
from collections import deque

import numpy as np
import pytest

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.data import datasets as jax_datasets
from efficient_slowfast_tpu.data import frame_datasets as jax_fd
from efficient_slowfast_tpu.data import host_transforms as jax_ht
from efficient_slowfast_tpu.data.build import build_dataset as jax_build
from efficient_slowfast_tpu_torch.config import get_cfg, load_cfg
from efficient_slowfast_tpu_torch.data import datasets, frame_datasets
from efficient_slowfast_tpu_torch.data import host_transforms as ht
from efficient_slowfast_tpu_torch.data.build import build_dataset
from efficient_slowfast_tpu_torch.data.loader import ClipLoader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_YAML = os.path.join(
    ROOT, "configs", "Smoke", "SLOWFAST_SHUFFLENET_8x8_R50_stepwise_multigrid.yaml")


# -- the draws ---------------------------------------------------------------
class Recorder:
    """A port item's generator, logging each draw as (kind, range, value)
    in the terms JAX draws it in."""

    def __init__(self, rng, log):
        self._rng, self._log = rng, log

    def uniform(self, a, b):
        v = self._rng.uniform(a, b)
        self._log.append(("uniform", (a, b), v))
        return v

    def random(self):
        v = self._rng.random()
        self._log.append(("random", (), v))
        return v

    def integers(self, lo, hi, size=None, endpoint=False):
        v = self._rng.integers(lo, hi, size, endpoint=endpoint)
        if size is None:  # random.randint(lo, hi), both ends included
            self._log.append(("randint", (lo, hi if endpoint else hi - 1), v))
        else:  # np.random.randint(lo, hi, size)
            self._log.append(("np.randint", (lo, hi, tuple(size)), v))
        return v


class Replay:
    """JAX's ``random`` (and ``np.random``), serving the port's draws."""

    def __init__(self, log):
        self.log = deque(log)

    def _next(self, kind, args):
        got = self.log.popleft()
        assert got[:2] == (kind, args), (got[:2], (kind, args))
        return got[2]

    def uniform(self, a, b):
        return self._next("uniform", (a, b))

    def random(self):
        return self._next("random", ())

    def randint(self, lo, hi, size=None):
        if size is None:
            return int(self._next("randint", (lo, hi)))
        return self._next("np.randint", (lo, hi, tuple(size)))


class NumpyWithRandom:
    """numpy with its ``random`` replaced (for SaltImage's np.random)."""

    def __init__(self, random):
        self.random = random

    def __getattr__(self, name):
        return getattr(np, name)


@pytest.fixture()
def draws(monkeypatch):
    """``run(port_fn, jax_fn)``: the port's result and JAX's, JAX given
    the port's draws. The port's datasets draw from ``CanvasDataset._rng``;
    host transforms are handed a Recorder directly."""
    log = []
    orig = datasets.CanvasDataset._rng
    monkeypatch.setattr(datasets.CanvasDataset, "_rng",
                        lambda self, index: Recorder(orig(self, index), log))

    def run(port_fn, jax_fn):
        log.clear()
        got = port_fn(Recorder(np.random.default_rng(7), log))
        replay = Replay(log)
        with monkeypatch.context() as m:
            for mod in (jax_datasets, jax_fd, jax_ht):
                m.setattr(mod, "random", replay)
            m.setattr(jax_ht, "np", NumpyWithRandom(replay))
            want = jax_fn()
        assert not replay.log, f"JAX left {len(replay.log)} draws unused"
        return got, want, len(log)
    return run


def assert_items_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


# -- fixtures ----------------------------------------------------------------
def frame(h, w, seed):
    """Seeded content: a gradient with noise, so crops and resizes show."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([y * 255 // h, x * 255 // w, (x + y) * 127 // (h + w)], -1)
    return np.clip(base + rs.randint(-30, 30, (h, w, 3)), 0, 255).astype(
        np.uint8)


@pytest.fixture(scope="module")
def frame_lists(tmp_path_factory):
    """Two videos of 40 JPEG frames (48 x 64) in fvcore frame lists, v0's
    frames with labels, v1's without; Charades' train/val lists and SSv2's
    lists and label jsons."""
    from PIL import Image

    root = tmp_path_factory.mktemp("frames")
    rows = ["original_vido_id video_id frame_id path labels"]
    for v, name in enumerate(["v0", "v1"]):
        (root / name).mkdir()
        for i in range(40):
            rel = f"{name}/{i:05d}.jpg"
            Image.fromarray(frame(48, 64, 100 * v + i)).save(root / rel)
            lbl = f'"{(i % 3)},{(i % 5)}"' if name == "v0" else '""'
            rows.append(f"{name} {v} {i} {rel} {lbl}")
    text = "\n".join(rows) + "\n"
    charades = root / "charades"
    charades.mkdir()
    ssv2 = root / "ssv2"
    ssv2.mkdir()
    for d in (charades, ssv2):
        (d / "train.csv").write_text(text)
        (d / "val.csv").write_text(text)
    (ssv2 / "something-something-v2-labels.json").write_text(
        json.dumps({"Doing a thing": "0", "Doing another": "1"}))
    videos = [{"id": "v0", "template": "Doing a [thing]"},
              {"id": "v1", "template": "Doing another"},
              {"id": "v9", "template": "Doing another"}]  # not in the list
    for split in ("train", "validation"):
        (ssv2 / f"something-something-v2-{split}.json").write_text(
            json.dumps(videos))
    return root


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Three frame folders (12, 20 and 40 frames at 40 x 56; one of PNGs)
    and their list files two ways: train.txt/val.txt in a data dir, and
    explicit lists elsewhere."""
    from PIL import Image

    root = tmp_path_factory.mktemp("folders")
    lines = []
    for k, n in enumerate((12, 20, 40)):
        d = root / f"vid{k}"
        d.mkdir()
        ext = "png" if k == 1 else "jpg"
        for i in range(n):
            Image.fromarray(frame(40, 56, 1000 * k + i)).save(
                d / f"{i:05d}.{ext}")
        lines.append(f"vid{k} {k % 3}")
    data_dir = root / "lists"
    data_dir.mkdir()
    text = "\n".join(lines) + "\n"
    (data_dir / "train.txt").write_text(text)
    (data_dir / "val.txt").write_text(text)
    (root / "explicit_train.txt").write_text(
        "\n".join(f"{root}/{line}" for line in lines) + "\n")
    (root / "explicit_val.txt").write_text(
        "\n".join(f"{root}/{line}" for line in reversed(lines)) + "\n")
    return root


def frame_list_cfgs(root, name):
    """(port cfg, JAX cfg) of the frame-list dataset ``name`` at a tiny
    size: 4 frames at rate 2, canvases of short side 36/45, 2 x 3 test
    views."""
    out = []
    for get in (get_cfg, jax_get_cfg):
        cfg = get()
        cfg.DATA.PATH_TO_DATA_DIR = str(root / name)
        cfg.DATA.PATH_PREFIX = str(root)
        cfg.DATA.NUM_FRAMES = 4 if name == "charades" else 8
        cfg.DATA.SAMPLING_RATE = 2
        cfg.DATA.TRAIN_JITTER_SCALES = [36, 45]
        cfg.DATA.TEST_CROP_SIZE = 36
        cfg.DATA.MULTI_LABEL = name == "charades"
        cfg.MODEL.NUM_CLASSES = 5 if name == "charades" else 2
        cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
        cfg.TEST.NUM_SPATIAL_CROPS = 3
        cfg.RNG_SEED = 3
        out.append(cfg)
    return out


def folder_cfgs(root, route, half_face, gray):
    out = []
    for get in (get_cfg, jax_get_cfg):
        cfg = get()
        if route == "explicit":
            cfg.DATA.PATH_TO_TRAIN_DATA_TXT = str(root / "explicit_train.txt")
            cfg.DATA.PATH_TO_VAL_DATA_TXT = str(root / "explicit_val.txt")
        else:
            cfg.DATA.PATH_TO_DATA_DIR = str(root / "lists")
            cfg.DATA.PATH_PREFIX = str(root)
        cfg.DATA.NUM_FRAMES = 4
        cfg.DATA.SAMPLING_RATE = 2
        cfg.DATA.TRAIN_JITTER_SCALES = [24, 30]
        cfg.DATA.TEST_CROP_SIZE = 28
        cfg.DATA.HALF_FACE = half_face
        cfg.DATA.GRAY_STYLE = gray
        cfg.MODEL.NUM_CLASSES = 3
        cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
        cfg.TEST.NUM_SPATIAL_CROPS = 3
        cfg.RNG_SEED = 5
        out.append(cfg)
    return out


def compare_split(draws, name, pcfg, jcfg, mode, epoch=0):
    """Every item of the split through both packages; returns the draws
    the port made."""
    port = build_dataset(name, pcfg, mode)
    jax_ds = jax_build(name, jcfg, mode)
    port.set_epoch(epoch)
    assert len(port) == len(jax_ds) > 0
    made = 0
    for i in range(len(port)):
        if mode == "test":  # no draws, nothing patched
            assert_items_equal(port[i], jax_ds[i])
            continue
        got, want, n = draws(lambda _: port[i], lambda: jax_ds[i])
        assert_items_equal(got, want)
        made += n
    return port, made


# -- the helpers -------------------------------------------------------------
def test_load_image_lists_both_forms_and_header(frame_lists, tmp_path):
    path = str(frame_lists / "charades" / "train.csv")
    for return_list in (False, True):
        got = frame_datasets.load_image_lists(path, "pre", return_list)
        want = jax_fd.load_image_lists(path, "pre", return_list)
        assert got == want
    paths, labels = frame_datasets.load_image_lists(path)
    assert list(paths) == ["v0", "v1"] and len(paths["v0"]) == 40
    assert labels["v0"][7] == [1, 2] and labels["v1"][7] == []
    bad = tmp_path / "bad.csv"
    bad.write_text("video frame\nv0 0 0 a.jpg \"\"\n")
    for fn in (frame_datasets.load_image_lists, jax_fd.load_image_lists):
        with pytest.raises(AssertionError):
            fn(str(bad))


def test_retry_load_images_reads_rgb_and_raises(frame_lists, tmp_path):
    from PIL import Image

    paths = [str(frame_lists / "v0" / f"{i:05d}.jpg") for i in (0, 5, 39)]
    gray = tmp_path / "gray.png"
    Image.fromarray(frame(48, 64, 1)[..., 0]).save(gray)
    paths.append(str(gray))
    got = frame_datasets.retry_load_images(paths, 2)
    assert got.dtype == np.uint8 and got.shape == (4, 48, 64, 3)
    np.testing.assert_array_equal(got, jax_fd.retry_load_images(paths, 2))
    with pytest.raises(RuntimeError, match="Failed to load images"):
        frame_datasets.retry_load_images([str(tmp_path / "none.jpg")], 3)


def test_aggregate_labels_and_binary_vector():
    frames = [[3, 1], [], [1, 4], [0]]
    assert frame_datasets.aggregate_labels(frames) == \
        jax_fd.aggregate_labels(frames) == [0, 1, 3, 4]
    got = frame_datasets.as_binary_vector([0, 3, 3], 5)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_fd.as_binary_vector([0, 3, 3], 5))


# -- Ssv2 and Charades ---------------------------------------------------------
@pytest.mark.parametrize("mode", ["train", "val", "test"])
@pytest.mark.parametrize("name", ["ssv2", "charades"])
def test_frame_list_items_match_jax(frame_lists, draws, name, mode):
    pcfg, jcfg = frame_list_cfgs(frame_lists, name)
    port, made = compare_split(draws, name, pcfg, jcfg, mode, epoch=2)
    views = 6 if mode == "test" else 1
    assert len(port) == 2 * views  # SSv2's v9 is not in the frame list
    if mode == "train":
        assert made > 2  # a crop draw an item, and the temporal draws
    item = port[0]
    if name == "charades":
        assert item["label"].dtype == np.float32 and item["label"].shape == (5,)
        assert item["label"].sum() >= 1 and port[len(port) - 1]["label"].sum() == 0
    else:
        assert item["label"].dtype == np.int64


def test_frame_list_test_views_share_one_read(frame_lists, monkeypatch):
    pcfg, _ = frame_list_cfgs(frame_lists, "charades")
    calls = []
    real = frame_datasets.retry_load_images
    monkeypatch.setattr(frame_datasets, "retry_load_images",
                        lambda paths, r: calls.append(1) or real(paths, r))
    ds = build_dataset("charades", pcfg, "test")
    items = [ds[i] for i in range(len(ds))]
    assert len(calls) == 2 * 2  # one read per (video, view), not per crop
    ds._test_decode_memo = None
    for i, item in enumerate(items):
        assert_items_equal(item, ds[i])


def test_frame_list_epochs_draw_anew(frame_lists):
    pcfg, _ = frame_list_cfgs(frame_lists, "charades")
    ds = build_dataset("charades", pcfg, "train")
    a = ds[0]
    assert_items_equal(a, ds[0])  # the same epoch and index: the same item
    ds.set_epoch(1)
    assert float(ds[0]["crop_u"]) != float(a["crop_u"])


# -- the frame folders ---------------------------------------------------------
@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("style", ["plain", "half_face", "gray", "gray_half"])
@pytest.mark.parametrize("route", ["data_dir", "explicit"])
@pytest.mark.parametrize("name", ["framefolder", "wheel", "tired",
                                  "wheel_gray"])
def test_frame_folder_items_match_jax(folders, draws, name, route, style,
                                      mode):
    pcfg, jcfg = folder_cfgs(folders, route, "half" in style,
                             "gray" in style)
    port, made = compare_split(draws, name, pcfg, jcfg, mode, epoch=1)
    assert len(port) == 3 * (6 if mode == "test" else 1)
    gray = "gray" in style or name == "wheel_gray"
    item = port[0]
    if gray:  # three equal channels, square content at the short side
        f = item["frames"]
        assert (f[..., 0] == f[..., 1]).all() and (f[..., 1] == f[..., 2]).all()
        assert int(item["width"]) == f.shape[1]
    if mode == "train":
        # the window start and the crop; gray style: the corner crop, the
        # half-face ratio, the rotation and the salt noise
        assert made >= 3 * (2 + (4 if gray else 0))


def test_frame_folder_without_frames_retries_then_raises(folders, tmp_path):
    (tmp_path / "empty").mkdir()
    (tmp_path / "val.txt").write_text("empty 0\n")
    cfg = get_cfg()
    cfg.DATA.PATH_TO_DATA_DIR = str(tmp_path)
    cfg.DATA.PATH_PREFIX = str(tmp_path)
    ds = build_dataset("framefolder", cfg, "val")
    with pytest.raises(RuntimeError, match="after 10 retries"):
        ds[0]


def test_video_files_decode_with_part_b(tmp_path):
    """Jester's video files decode (part B has come; its items against
    JAX's in tests/test_torch_port_video_datasets.py)."""
    from efficient_slowfast_tpu_torch.data import decoder

    for name in ("a", "b"):
        decoder.write_test_video(str(tmp_path / f"{name}.mp4"),
                                 np.full((20, 24, 32, 3), 60, np.uint8))
    (tmp_path / "trainlist.txt").write_text("a.mp4 0\nb.mp4 1\n")
    cfg = get_cfg()
    cfg.DATA.PATH_TO_DATA_DIR = str(tmp_path)
    ds = build_dataset("jester", cfg, "train")  # the list is read
    assert ds._path_to_videos == ["a.mp4", "b.mp4"] and ds._labels == [0, 1]
    cfg.DATA.PATH_PREFIX = str(tmp_path)
    cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_JITTER_SCALES = 4, [16, 20]
    item = build_dataset("jester", cfg, "train")[1]
    assert item["frames"].shape == (4, 20, 40, 3) and int(item["label"]) == 1
    assert int(item["width"]) == 27


def test_fork_list_names_and_separator(tmp_path):
    (tmp_path / "kinetics_p3d_val_byvideo_128.lst").write_text(
        "x/a.mp4,3\nx/b.mp4,1\n")
    for get, build in ((get_cfg, build_dataset), (jax_get_cfg, jax_build)):
        cfg = get()
        cfg.DATA.PATH_TO_DATA_DIR = str(tmp_path)
        cfg.DATA.PATH_LABEL_SEPARATOR = ","
        cfg.DATA.PATH_PREFIX = "/videos"
        cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = 1, 2
        ds = build("kinetics", cfg, "test")
        assert ds._path_to_videos == ["/videos/x/a.mp4"] * 2 + [
            "/videos/x/b.mp4"] * 2
        assert ds._labels == [3, 3, 1, 1]
        assert ds._spatial_temporal_idx == [0, 1, 0, 1]


# -- the host transforms -------------------------------------------------------
CLIP = np.stack([frame(20, 28, s) for s in range(6)])


@pytest.mark.parametrize("make", [
    lambda m: m.Compose([m.RandomRotate(), m.SaltImage(prob=1.0)]),
    lambda m: m.Scale(14), lambda m: m.Scale(30),
    lambda m: m.RandomResize(), lambda m: m.RandomRotate(25.0),
    lambda m: m.GaussianBlur(prob=1.0), lambda m: m.GaussianBlur(prob=0.0),
    lambda m: m.SaltImage(ratio=7, prob=1.0), lambda m: m.SaltImage(prob=0.0),
    lambda m: m.TemporalCenterCrop(4), lambda m: m.TemporalCenterCrop(9),
    lambda m: m.TemporalRandomCrop(4), lambda m: m.TemporalRandomCrop(8),
    lambda m: m.TemporalBeginCrop(4), lambda m: m.TemporalBeginCrop(9),
], ids=["compose", "scale_down", "scale_up",
        "random_resize", "random_rotate", "blur", "no_blur", "salt",
        "no_salt", "center", "center_pad", "random_crop", "random_pad",
        "begin", "begin_pad"])
def test_host_transform_matches_jax(draws, make):
    for clip in (CLIP, CLIP[:, :, :12].copy()):
        got, want, _ = draws(lambda rng: make(ht)(clip, rng),
                             lambda: make(jax_ht)(clip))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


# -- the loader's preallocated path --------------------------------------------
@pytest.mark.parametrize("name,mode", [
    ("charades", "train"), ("ssv2", "test"), ("wheel_gray", "train"),
    ("tired", "test")])
def test_getitem_into_equals_getitem(frame_lists, folders, name, mode):
    if name in ("charades", "ssv2"):
        cfg, _ = frame_list_cfgs(frame_lists, name)
    else:
        cfg, _ = folder_cfgs(folders, "data_dir", True, False)
    ds = build_dataset(name, cfg, mode)
    loader = ClipLoader(ds, batch_size=4, pad_to_full=True, num_workers=2)
    assert loader._fill() is not None  # the preallocated path, not collate
    for i in range(len(ds)):
        out = np.full(ds.frames_shape(), 7, np.uint8)
        scalars = ds.getitem_into(i, out)
        item = ds[i]
        np.testing.assert_array_equal(out, item.pop("frames"))
        assert_items_equal(scalars, item)
    batches = list(loader)
    assert sum(int(b["_valid"].sum()) for b in batches) == len(ds)
    labels = np.concatenate([b["label"][b["_valid"] > 0] for b in batches])
    np.testing.assert_array_equal(
        labels, np.stack([ds[i]["label"] for i in range(len(ds))]))


# -- the Smoke yaml's frame-folder reads ----------------------------------------
@pytest.mark.parametrize("mode", ["train", "test"])
def test_smoke_yaml_framefolder_reads(folders, draws, mode):
    opts = ["DATA.PATH_TO_DATA_DIR", str(folders / "lists"),
            "DATA.PATH_PREFIX", str(folders), "TEST.NUM_ENSEMBLE_VIEWS", 2]
    pcfg = load_cfg(SMOKE_YAML, opts)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(SMOKE_YAML)
    jcfg.merge_from_list(opts)
    assert pcfg.TRAIN.DATASET == "framefolder" and pcfg.DATA.GRAY_STYLE
    port = build_dataset(pcfg.TRAIN.DATASET, pcfg, mode)
    jax_ds = jax_build(jcfg.TRAIN.DATASET, jcfg, mode)
    short = 160 if mode == "train" else 112  # the yaml's jitter top, crop
    assert port.frames_shape() == (16, short, 2 * short, 3)
    for i in (0, len(port) - 1):
        if mode == "test":
            assert_items_equal(port[i], jax_ds[i])
        else:
            got, want, _ = draws(lambda _: port[i], lambda: jax_ds[i])
            assert_items_equal(got, want)
