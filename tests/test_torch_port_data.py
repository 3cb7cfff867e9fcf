"""The port's data path — pathways, transforms, preprocess, synthetic
datasets, loader, shard and shuffle orders — and its meters and LR policy,
held against the JAX package's on the same inputs made from a seed, on the
CPU: f32 arrays at rtol = atol = 1e-5, host bytes and orders exactly."""

import glob
import os
import threading
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.data import datasets as jds
from efficient_slowfast_tpu.data import loader as jloader
from efficient_slowfast_tpu.data import pathways as jpath
from efficient_slowfast_tpu.data import preprocess as jpre
from efficient_slowfast_tpu.data import transform as jT
from efficient_slowfast_tpu.utils import lr_policy as jlr
from efficient_slowfast_tpu.utils import meters as jmeters
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.data import datasets, loader, pathways
from efficient_slowfast_tpu_torch.data import preprocess, transform as T
from efficient_slowfast_tpu_torch.utils import lr_policy, meters

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def data_cfg(get, frames=4, short=16, crop=16):
    """SlowFast's data keys at a tiny size: ``frames`` frames, canvases of
    short side ``short`` (test crop and the train jitter's top), a
    ``crop`` train crop, 5 classes, the synthetic backend."""
    cfg = get()
    cfg.MODEL.ARCH = "slowfast"
    cfg.MODEL.NUM_CLASSES = 5
    cfg.SLOWFAST.ALPHA = 2
    cfg.DATA.NUM_FRAMES = frames
    cfg.DATA.TEST_CROP_SIZE = short
    cfg.DATA.TRAIN_JITTER_SCALES = [short, short]
    cfg.DATA.TRAIN_CROP_SIZE = crop
    cfg.DATA.DECODING_BACKEND = "synthetic"
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "synthetic"
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    cfg.TRAIN.BATCH_SIZE = 6
    cfg.TEST.BATCH_SIZE = 5
    cfg.DATA_LOADER.NUM_WORKERS = 3
    cfg.TPU.DATA_AXIS = 1  # one process, one batch divisor: the port's
    return cfg


def canvases(batch, t, h, w, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (batch, t, h, w, 3)).astype(np.uint8)


def np_of(x):
    return [np.asarray(a) for a in x] if isinstance(x, list) else np.asarray(x)


# --- pathways ---------------------------------------------------------------
def _zoo_frames_and_alphas():
    out = set()
    for path in glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                          recursive=True):
        with open(path) as f:
            cfg = yaml.safe_load(f) or {}
        data, sf = cfg.get("DATA") or {}, cfg.get("SLOWFAST") or {}
        out.add((data.get("NUM_FRAMES", 8), sf.get("ALPHA", 8)))
    return sorted(out)


def test_slow_pathway_indices_match_jax():
    """Equal wherever linspace's position is not half-way between two
    frames, and for every (NUM_FRAMES, ALPHA) of the config zoo; at exact
    halves the port rounds to even (float64), where the JAX package's
    float32 linspace lands an ulp to either side."""
    zoo = _zoo_frames_and_alphas()
    assert (32, 4) in zoo and len(zoo) > 3
    grid = [(t, a) for t in (4, 6, 8, 10, 11, 14, 16, 22, 32, 48, 64)
            for a in (1, 2, 3, 4, 8)]
    for t, alpha in zoo + grid:
        n = t // alpha
        if not n:
            continue
        ours = pathways.slow_pathway_indices(t, alpha).numpy()
        theirs = np.asarray(jpath.slow_pathway_indices(t, alpha))
        halves = [Fraction((t - 1) * i, max(n - 1, 1)).denominator == 2
                  for i in range(n)]
        if (t, alpha) in zoo:
            assert not any(halves), (t, alpha)
        keep = ~np.asarray(halves)
        np.testing.assert_array_equal(ours[keep], theirs[keep])
        np.testing.assert_array_equal(
            ours, [round(Fraction((t - 1) * i, max(n - 1, 1)))
                   for i in range(n)])


@pytest.mark.parametrize("middle", [False, True])
def test_pack_pathway_output_matches_jax(middle):
    x = np.random.RandomState(1).rand(2, 8, 3, 3, 3).astype(np.float32)
    out = []
    for get, pack, arr in ((get_cfg, pathways.pack_pathway_output,
                            torch.from_numpy(x)),
                           (jax_get_cfg, jpath.pack_pathway_output,
                            jnp.asarray(x))):
        cfg = get()
        cfg.MODEL.ARCH = "slowfast"
        cfg.SLOWFAST.ALPHA = 4
        cfg.DATA.SLOW_PATHWAY_MIDDLE = middle
        out.append(np_of(pack(cfg, arr)))
    ours, theirs = out
    assert [a.shape for a in ours] == [a.shape for a in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


# --- transforms -------------------------------------------------------------
@pytest.mark.parametrize("spatial_idx", [0, 1, 2])
def test_uniform_crop_boxes_match_jax(spatial_idx):
    h = 24
    widths = np.array([48, 30, 24, 17, 11, 40], np.int32)  # wide and tall
    sidx = np.full(len(widths), spatial_idx, np.int32)
    for scale, crop in ((24, 24), (32, 24), (24, 16)):
        ours = T.uniform_crop_boxes(h, torch.from_numpy(widths), scale, crop,
                                    torch.from_numpy(sidx)).numpy()
        theirs = np.asarray(jT.uniform_crop_boxes(
            h, jnp.asarray(widths), scale, crop, jnp.asarray(sidx)))
        np.testing.assert_allclose(ours, theirs, **TOL)


def test_crop_and_resize_matches_jax_on_given_boxes():
    x = canvases(5, 3, 20, 40, seed=2)
    boxes = np.array([[0, 0, 20, 20],          # integral, exact crop
                      [2.5, 7.25, 17.5, 33.0],  # fractional
                      [0, 26.0, 20, 40],        # touching the right border
                      [-0.75, -1.5, 21.0, 41.0],  # past every border
                      [4.2, 3.9, 9.1, 8.3]],    # upsampling a small box
                     np.float32)
    for out_size in (12, 20):
        ours = T.crop_and_resize(torch.from_numpy(x), torch.from_numpy(boxes),
                                 out_size).numpy()
        theirs = np.asarray(jT.crop_and_resize(
            jnp.asarray(x, jnp.float32), jnp.asarray(boxes), out_size))
        assert ours.dtype == np.float32
        np.testing.assert_allclose(ours, theirs, **TOL)
        # float frames take the same path
        ours_f = T.crop_and_resize(torch.from_numpy(x).float(),
                                   torch.from_numpy(boxes), out_size).numpy()
        np.testing.assert_allclose(ours_f, theirs, **TOL)


def test_crop_and_resize_of_pixel_boxes_is_a_gather(monkeypatch):
    """Integral boxes of the output's size on the host (the test crops)
    take one gather: the general path's pixels, and JAX's within 1e-5 at
    sizes whose sample centres float32 does not hit exactly."""
    x = canvases(4, 2, 30, 50, seed=8)
    for out_size in (16, 24):
        boxes = torch.tensor([[0, 0, 1, 1], [0, 20, 1, 1], [-2, -3, 1, 1],
                              [4, 26, 1, 1]], dtype=torch.float32)
        boxes[:, 2:] = boxes[:, :2] + out_size
        assert T._pixel_crop(boxes, out_size)
        fast = T.crop_and_resize(torch.from_numpy(x), boxes, out_size)
        with monkeypatch.context() as m:
            m.setattr(T, "_pixel_crop", lambda *a: False)
            general = T.crop_and_resize(torch.from_numpy(x), boxes, out_size)
        theirs = np.asarray(jT.crop_and_resize(
            jnp.asarray(x, jnp.float32), jnp.asarray(boxes.numpy()), out_size))
        np.testing.assert_allclose(fast.numpy(), general.numpy(), **TOL)
        np.testing.assert_allclose(fast.numpy(), theirs, **TOL)
        np.testing.assert_array_equal(  # the first box is a plain slice
            fast[0].numpy(), x[0, :, :out_size, :out_size].astype(np.float32))


def test_random_scale_crop_boxes_stay_inside_the_canvas():
    h = 32
    widths = np.array([64, 42, 32, 20, 57], np.int32)
    for seed in range(20):
        for inv, (lo, hi) in ((False, (32, 64)), (True, (40, 80)),
                              (False, (16, 32))):
            gen = torch.Generator().manual_seed(seed)
            b = T.random_scale_crop_boxes(gen, len(widths), h,
                                          torch.from_numpy(widths), lo, hi, 24,
                                          inverse_uniform=inv).numpy()
            short = np.minimum(h, widths)
            win = b[:, 2] - b[:, 0]
            assert np.all(win > 0)
            np.testing.assert_allclose(b[:, 3] - b[:, 1], win, rtol=1e-6)
            np.testing.assert_array_less(24 * short / hi - 1e-4, win)
            np.testing.assert_array_less(win, 24 * short / lo + 1e-4)
            inside = np.minimum(win, short)  # a window past the short side
            assert np.all(b[:, :2] >= 0)     # starts at 0 and spills over
            assert np.all(b[:, 0] + inside <= h + 1e-4)
            assert np.all(b[:, 1] + inside <= widths + 1e-4)


def test_random_scale_crop_boxes_follow_the_host_crop_u():
    widths = torch.tensor([40, 30, 16])
    u = torch.tensor([0.0, 0.37, 1.0])
    b = T.random_scale_crop_boxes(torch.Generator().manual_seed(0), 3, 16,
                                  widths, 16, 16, 16, u_x=u).numpy()
    np.testing.assert_allclose(b[:, 1], u.numpy() * (widths.numpy() - 16),
                               rtol=1e-6)
    np.testing.assert_allclose(b[:, 0], 0.0)  # scale = short: no room in y


def test_normalize_flip_and_portrait_match_jax():
    x = canvases(4, 2, 6, 6, seed=3)
    mean, std = (0.45, 0.4, 0.5), (0.225, 0.25, 0.2)
    np.testing.assert_allclose(
        T.tensor_normalize(torch.from_numpy(x), mean, std).numpy(),
        np.asarray(jT.tensor_normalize(jnp.asarray(x), mean, std)), **TOL)
    xf = x.astype(np.float32) / 255
    portrait = np.array([1, 0, 1, 0], np.int32)
    np.testing.assert_array_equal(
        T.transpose_portrait(torch.from_numpy(xf), portrait).numpy(),
        np.asarray(jT.transpose_portrait(jnp.asarray(xf),
                                         jnp.asarray(portrait))))
    np.testing.assert_array_equal(
        T.transpose_portrait(torch.from_numpy(xf), np.zeros(4)).numpy(), xf)
    for prob in (0.0, 1.0):  # the draw decides nothing at these
        np.testing.assert_array_equal(
            T.horizontal_flip(torch.Generator(), torch.from_numpy(xf),
                              prob).numpy(),
            np.asarray(jT.horizontal_flip(jax.random.PRNGKey(0),
                                          jnp.asarray(xf), prob)))


def _jitter_reference(x, f, widths):
    """pil_color_jitter with every factor ``f``, the contrast mean taken
    over each clip's content columns, in float64."""
    w = np.array([0.299, 0.587, 0.114])
    xb = x.astype(np.float64) * f
    luma = (xb * w).sum(-1)
    mean = np.array([luma[i, :, :, :widths[i]].mean()
                     for i in range(len(x))])[:, None, None, None, None]
    xc = f * xb + (1 - f) * mean
    return f * xc + (1 - f) * (xc * w).sum(-1, keepdims=True)


def test_pil_color_jitter_matches_jax_and_masks_the_padding():
    x = canvases(3, 2, 4, 8, seed=4).astype(np.float32) / 255
    f = 0.8  # lo = hi: every factor drawn is f on both sides
    ours = T.pil_color_jitter(torch.Generator(), torch.from_numpy(x), f, f)
    theirs = jT.pil_color_jitter(jax.random.PRNGKey(0), jnp.asarray(x), f, f)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
    widths = np.array([8, 5, 2])
    ours = T.pil_color_jitter(torch.Generator(), torch.from_numpy(x), f, f,
                              widths=torch.from_numpy(widths)).numpy()
    ref = _jitter_reference(x, f, widths)
    np.testing.assert_allclose(ours, ref, **TOL)
    # the JAX package divides the content's luma sum over T·H·width by the
    # width alone (transform.py:253-256): the fault the port's copy fixes
    theirs = np.asarray(jT.pil_color_jitter(
        jax.random.PRNGKey(0), jnp.asarray(x), f, f,
        widths=jnp.asarray(widths)))
    assert np.abs(theirs - ref).max() > 0.1


# --- preprocess -------------------------------------------------------------
def test_make_test_preprocess_matches_jax():
    t, s = 4, 16
    x = canvases(6, t, s, 2 * s, seed=5)
    widths = np.array([32, 21, 16, 27, 32, 16], np.int32)
    sidx = np.array([0, 1, 2, 2, 1, 0], np.int32)
    portrait = np.array([0, 1, 0, 1, 0, 0], np.int32)
    ours = preprocess.make_test_preprocess(data_cfg(get_cfg, t, s))(
        torch.from_numpy(x), torch.from_numpy(widths), torch.from_numpy(sidx),
        torch.from_numpy(portrait))
    theirs = jpre.make_test_preprocess(data_cfg(jax_get_cfg, t, s))(
        jnp.asarray(x), jnp.asarray(widths), jnp.asarray(sidx),
        jnp.asarray(portrait))
    assert [tuple(a.shape) for a in ours] == [(6, 2, s, s, 3), (6, t, s, s, 3)]
    for a, b in zip(ours, theirs):
        assert a.is_contiguous() and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("jitter", [False, True])
def test_make_train_preprocess_matches_jax(jitter):
    """Scale jitter [S, S] with a crop of S leaves no draw in y, RANDOM_FLIP
    is off and crop_u is given, so both sides crop the same boxes. With the
    colour jitter (lo = hi) the canvases are full width, where the JAX
    package's mean is right without ``widths``: its preprocess is composed
    from its own transforms."""
    t, s, crop = 4, 16, 16
    x = canvases(5, t, s, 2 * s, seed=6)
    widths = np.full(5, 2 * s, np.int32) if jitter else \
        np.array([32, 21, 16, 27, 32], np.int32)
    portrait = np.array([0, 1, 0, 0, 1], np.int32)
    crop_u = np.array([0.0, 0.25, 0.5, 0.9, 1.0], np.float32)
    cfgs = [data_cfg(g, t, s, crop) for g in (get_cfg, jax_get_cfg)]
    for cfg in cfgs:
        cfg.DATA.RANDOM_FLIP = False
        cfg.DATA.TRAIN_COLOR_JITTER = [0.7, 0.7] if jitter else []
    ours = preprocess.make_train_preprocess(cfgs[0])(
        torch.Generator().manual_seed(0), torch.from_numpy(x),
        torch.from_numpy(widths), torch.from_numpy(portrait),
        torch.from_numpy(crop_u))
    key = jax.random.PRNGKey(0)
    if not jitter:
        theirs = jpre.make_train_preprocess(cfgs[1])(
            key, jnp.asarray(x), jnp.asarray(widths), jnp.asarray(portrait),
            jnp.asarray(crop_u))
    else:
        xj = jT.pil_color_jitter(key, jnp.asarray(x, jnp.float32) / 255.0,
                                 0.7, 0.7)
        xj = jT.color_normalization(xj, tuple(cfgs[1].DATA.MEAN),
                                    tuple(cfgs[1].DATA.STD))
        boxes = jT.random_scale_crop_boxes(key, 5, s, jnp.asarray(widths), s,
                                           s, crop, u_x=jnp.asarray(crop_u))
        xj = jT.transpose_portrait(jT.crop_and_resize(xj, boxes, crop),
                                   jnp.asarray(portrait))
        theirs = jpath.pack_pathway_output(cfgs[1], xj)
    for a, b in zip(ours, theirs):
        assert a.is_contiguous() and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_preprocess_returns_the_compute_dtype():
    x = torch.from_numpy(canvases(2, 4, 16, 32, seed=7))
    w = torch.tensor([32, 20])
    out = preprocess.make_test_preprocess(data_cfg(get_cfg), torch.bfloat16)(
        x, w, torch.tensor([0, 2]))
    ref = preprocess.make_test_preprocess(data_cfg(get_cfg))(
        x, w, torch.tensor([0, 2]))
    for a, b in zip(out, ref):
        assert a.dtype == torch.bfloat16 and a.is_contiguous()
        torch.testing.assert_close(a.float(), b, rtol=1e-2, atol=1e-2)


# --- synthetic datasets and the loader ---------------------------------------
SPLITS = ["train", "val", "test"]


@pytest.mark.parametrize("split", SPLITS)
def test_synthetic_items_are_the_jax_packages_bytes(split):
    ours = datasets.Synthetic(data_cfg(get_cfg), split)
    theirs = jds.Synthetic(data_cfg(jax_get_cfg), split)
    assert len(ours) == len(theirs) == (64 if split != "test" else 48)
    assert ours.frames_shape() == theirs.frames_shape()
    for i in list(range(0, len(ours), 7)) + [len(ours) - 1]:
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        for k in a:
            if k != "crop_u":  # drawn by (RNG_SEED, epoch, index) here
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")
        out = np.zeros(ours.frames_shape(), np.uint8)
        scalars = ours.getitem_into(i, out)
        np.testing.assert_array_equal(out, b["frames"])
        assert scalars["width"] == b["width"]


def test_clip_windows_and_canvases_match_jax():
    for args in ((300, 64, 0, 10), (300, 64, 9, 10), (40, 64, 3, 10),
                 (101, 16, 2, 3)):
        assert datasets.get_start_end_idx(*args) == \
            jds.get_start_end_idx(*args)
    start, end = datasets.get_start_end_idx(300, 64, -1, 10,
                                            np.random.default_rng(0))
    assert 0 <= start <= 236 and end == start + 63
    frames = canvases(1, 50, 6, 10, seed=9)[0]
    np.testing.assert_array_equal(
        datasets.temporal_sample_np(frames, 3.5, 40.2, 8),
        jds.temporal_sample_np(frames, 3.5, 40.2, 8))
    # wide (past 2:1, per view), tall (stored transposed) and small content
    for shape, view, u in (((4, 10, 45, 3), 0, None), ((4, 10, 45, 3), 1, None),
                           ((4, 10, 45, 3), 2, None), ((4, 10, 45, 3), -1, 0.3),
                           ((4, 30, 12, 3), 1, None), ((4, 16, 24, 3), -1, None)):
        frames = canvases(1, *shape[:3], seed=10)[0]
        ours = datasets.fit_canvas(frames, 16, True, view, u)
        theirs = jds.fit_canvas(frames, 16, True, view, u)
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1:] == theirs[1:]


def test_crop_u_is_drawn_per_epoch_and_index_whatever_the_order():
    ds = datasets.Synthetic(data_cfg(get_cfg), "train")
    first = [float(ds._fetch(i)[1]["crop_u"]) for i in range(10)]
    again = [float(ds._fetch(i)[1]["crop_u"]) for i in reversed(range(10))]
    assert first == again[::-1] and len(set(first)) == 10
    ds.set_epoch(1)
    assert [float(ds._fetch(i)[1]["crop_u"]) for i in range(10)] != first


def _batches(ld, epoch):
    ld.set_epoch(epoch)
    return list(ld)


@pytest.mark.parametrize("split", SPLITS)
def test_loader_batches_are_the_jax_packages_bytes(split):
    ours = loader.construct_loader(data_cfg(get_cfg), split)
    theirs = jloader.construct_loader(data_cfg(jax_get_cfg), split)
    assert len(ours) == len(theirs) and ours.batch_size == theirs.batch_size
    a, b = _batches(ours, 1), _batches(theirs, 1)
    assert len(a) == len(b) == len(ours)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            if k != "crop_u":
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    if split != "train":  # the tail is padded and masked
        assert a[-1]["_valid"].sum() < len(a[-1]["_valid"])
        assert sum(x["_valid"].sum() for x in a) == len(ours.dataset)


def test_shard_and_shuffle_orders_match_jax():
    idx = np.random.RandomState(0).permutation(23)
    for pc in (1, 2, 3, 4, 8, 30):
        for pi in range(pc):
            ours, n_ours = loader.shard_indices(idx, pc, pi)
            theirs, n_theirs = jloader.shard_indices(idx, pc, pi)
            np.testing.assert_array_equal(ours, theirs)
            assert n_ours == n_theirs
    for weighted in (False, True):
        cfgs = [data_cfg(g) for g in (get_cfg, jax_get_cfg)]
        for cfg in cfgs:
            cfg.MODEL.WEIGHTED_RANDOM_SAMPLER = weighted
        ours = loader.construct_loader(cfgs[0], "train")
        theirs = jloader.construct_loader(cfgs[1], "train")
        for epoch in (0, 3):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            np.testing.assert_array_equal(ours._indices()[0],
                                          theirs._indices()[0])


def test_loader_shards_by_the_torch_rank(monkeypatch):
    monkeypatch.setattr(loader, "process_rank_and_count", lambda: (1, 3))
    ld = loader.construct_loader(data_cfg(get_cfg), "test")
    idx, n_valid = ld._indices()
    np.testing.assert_array_equal(idx, np.arange(1, 48, 3))
    assert n_valid == 16 and ld.batch_size == 2 and len(ld) == 8
    with pytest.raises(ValueError, match="world size"):
        cfg = data_cfg(get_cfg)
        cfg.TRAIN.BATCH_SIZE = 4
        loader.construct_loader(cfg, "train")


def test_short_cycle_schedule_and_refusal():
    ds = datasets.Synthetic(data_cfg(get_cfg), "val")
    ld = loader.ClipLoader(ds, 4, batch_size_schedule=[4, 2, 1],
                           drop_last=True, num_workers=2)
    got = list(ld)
    assert [len(b["label"]) for b in got] == [4, 2, 1] * 9  # 64 = 9·7 + 1
    assert [int(b["_phase"]) for b in got[:4]] == [0, 1, 2, 0]
    assert len(ld) == len(got)
    # the train loader of a short cycle takes the multigrid schedule: B
    # times the reference's integer factors of the crop ratios
    cfg = data_cfg(get_cfg)
    cfg.MULTIGRID.SHORT_CYCLE = True
    cfg.MULTIGRID.DEFAULT_S = cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.TRAIN.BATCH_SIZE = 2
    ld = loader.construct_loader(cfg, "train")
    assert ld.batch_size_schedule == [8, 4, 2] and ld.max_batch_size == 8
    assert loader.construct_loader(cfg, "val").batch_size_schedule is None


def test_decoding_a_file_names_its_roadmap_item(tmp_path):
    """ROADMAP item 2b part B has come: a listed video file decodes (its
    clip byte for byte JAX's, tests/test_torch_port_video_datasets.py), and
    a missing one is retried, then raises."""
    from efficient_slowfast_tpu_torch.data import decoder

    decoder.write_test_video(str(tmp_path / "a.mp4"), np.random.RandomState(
        0).randint(0, 255, (12, 24, 32, 3), np.uint8))
    (tmp_path / "test.csv").write_text("a.mp4 0\nmissing.mp4 1\n")
    cfg = data_cfg(get_cfg)
    cfg.DATA.DECODING_BACKEND = "ffmpeg"
    cfg.DATA.PATH_TO_DATA_DIR = cfg.DATA.PATH_PREFIX = str(tmp_path)
    ds = datasets.Kinetics(cfg, "test")  # the list is read for any backend
    item = ds[0]
    assert item["frames"].shape == (4, 16, 32, 3)
    assert int(item["width"]) == 21 and int(item["label"]) == 0
    with pytest.raises(RuntimeError, match="after 10 retries"):
        ds[len(ds) - 1]


def test_pinned_ring_and_early_exit_on_the_host(monkeypatch):
    """The ring's slot protocol, driven by the loader's threads with the
    page-locking left out (no card here): the batches filled into slots
    are the plain loader's, a consumer that stops after one batch leaves
    no thread behind, and the ring serves a second epoch."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k:
                        empty(*a, **k))
    ld = loader.construct_loader(data_cfg(get_cfg), "test")
    ring = loader.PinnedRing((ld.batch_size,) + ld.dataset.frames_shape(),
                             ld.prefetch + 2)
    plain = list(ld)
    before = threading.active_count()
    for _ in range(2):
        ring.reset()
        it = ld.batches(ring.acquire)
        first = next(it)
        np.testing.assert_array_equal(first["frames"], plain[0]["frames"])
        ring.release(first.pop("_slot"), None)
        it.close()
    assert threading.active_count() == before
    ring.reset()
    for got, ref in zip(ld.batches(ring.acquire), plain):
        slot = got.pop("_slot")
        assert sorted(got) == sorted(ref)
        for k in got:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        ring.release(slot, None)


def test_prefetch_on_the_cpu_wraps_the_batches():
    ld = loader.construct_loader(data_cfg(get_cfg), "val")
    times = meters.StageTimes()
    got = list(loader.prefetch_to_device(ld, "cpu", times=times))
    ref = list(ld)
    assert len(got) == len(ref) and len(times.summary()["wait"]) == len(ref) + 1
    for a, b in zip(got, ref):
        for k in b:
            assert isinstance(a[k], torch.Tensor)
            np.testing.assert_array_equal(a[k].numpy(), b[k], err_msg=k)


@pytest.mark.parametrize("kwargs", [{}, {"batch_size_schedule": [4, 2]}])
def test_prefetch_to_the_card_refuses_a_loader_without_the_ring(kwargs):
    """A ragged tail (of fixed or short-cycle batches) has no pinned ring
    to copy from: the card's prefetch raises before it touches the card."""
    ds = datasets.Synthetic(data_cfg(get_cfg), "val")
    ld = loader.ClipLoader(ds, 5, num_workers=1, **kwargs)
    with pytest.raises(ValueError, match="full batches"):
        next(loader.prefetch_to_device(ld, "cuda"))


# --- LR and meters ------------------------------------------------------------
@pytest.mark.parametrize("policy", ["cosine", "steps_with_relative_lrs"])
def test_lr_at_epoch_matches_jax(policy):
    values = []
    for get, fn in ((get_cfg, lr_policy.get_lr_at_epoch),
                    (jax_get_cfg, jlr.get_lr_at_epoch)):
        cfg = get()
        cfg.SOLVER.LR_POLICY = policy
        cfg.SOLVER.BASE_LR = 0.1
        cfg.SOLVER.MAX_EPOCH = 196
        cfg.SOLVER.WARMUP_EPOCHS = 34.0
        cfg.SOLVER.WARMUP_START_LR = 0.01
        cfg.SOLVER.STEPS = [0, 94, 154]
        cfg.SOLVER.LRS = [1, 0.1, 0.01]
        values.append([fn(cfg, e) for e in np.linspace(0, 196, 1571)])
    np.testing.assert_allclose(values[0], values[1], rtol=1e-12, atol=1e-12)
    assert values[0][0] == pytest.approx(0.01)


def _test_meters(make, method):
    rs = np.random.RandomState(0)
    num_videos, num_clips, num_cls = 5, 6, 7
    m = make(num_videos, num_clips, num_cls, 3, ensemble_method=method,
             topk=3)
    clip_ids = rs.permutation(num_videos * num_clips)
    labels = (clip_ids // num_clips) % num_cls
    preds = rs.rand(len(clip_ids), num_cls).astype(np.float32)
    for part in np.array_split(np.arange(len(clip_ids)), 4):
        m.update_stats(preds[part], labels[part], clip_ids[part])
    return m, m.finalize_metrics(ks=(1, 3))


@pytest.mark.parametrize("method", ["sum", "max"])
def test_test_meter_matches_jax(method):
    ours, stats = _test_meters(meters.TestMeter, method)
    theirs, jstats = _test_meters(jmeters.TestMeter, method)
    np.testing.assert_array_equal(ours.video_preds, theirs.video_preds)
    np.testing.assert_array_equal(ours.video_labels, theirs.video_labels)
    assert stats == jstats and stats["_type"] == "test_final"


def test_test_meter_raises_on_a_missing_view():
    m = meters.TestMeter(2, 3, 4, 1)
    m.update_stats(np.ones((5, 4)), np.zeros(5, np.int64), np.arange(5))
    with pytest.raises(RuntimeError, match="incomplete"):
        m.finalize_metrics()


def test_train_and_val_meters_match_jax():
    out = []
    for mod, get in ((meters, get_cfg), (jmeters, jax_get_cfg)):
        cfg = get()
        cfg.LOG_PERIOD = 2
        tm, vm = mod.TrainMeter(4, cfg), mod.ValMeter(3, cfg)
        for i in range(4):
            tm.update_stats(10.0 * i, 20.0 + i, 1.5 - 0.1 * i, 0.01, 8)
        for i in range(3):
            vm.update_stats(50.0 - i, 10.0 + i, 8 if i < 2 else 3)
        out.append((tm.loss_total, tm.num_top1_mis, tm.loss.get_win_median(),
                    vm.log_epoch_stats(0), vm.min_top_k_err))
    assert out[0] == out[1]
