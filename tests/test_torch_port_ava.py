"""The port's AVA data path, evaluation and multi-label mAP against the JAX
package's, on the CPU, on the two-video fixture that ``tests/test_ava.py``
writes (JPEG frames, frame lists, box CSVs, a label map):

- ``Ava`` items byte for byte (train, val and test splits, ``AVA.BGR``,
  ``AVA.TEST_FORCE_FLIP``, ``AVA.FULL_TEST_ON_VAL``) and through the
  loader, with ``_valid`` on a padded eval batch;
- the PASCAL evaluator and ``evaluate_ava`` on perfect, shuffled and
  partial predictions;
- ``get_map`` (numpy) against JAX's, which is sklearn's, to 1e-12;
- the TestMeter's multi-label mAP;
- the deterministic pieces of the detection preprocess, with JAX's draws
  given, at 1e-5;
- ``train()`` then ``test()`` end to end from the same bridged weights
  (dropout 0, no colour augmentation): the frame mAP within 1e-4 of JAX's.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.data import transform as JT
from efficient_slowfast_tpu.data.build import build_dataset as jax_build_dataset
from efficient_slowfast_tpu.data.preprocess import \
    make_detection_preprocess as jax_detection_preprocess
from efficient_slowfast_tpu.ops.options import configure
from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.utils import ava_eval_helper as jax_eval
from efficient_slowfast_tpu.utils import ava_evaluation as jax_evaluation
from efficient_slowfast_tpu.utils.meters import TestMeter as JaxTestMeter
from efficient_slowfast_tpu.utils.meters import get_map as jax_get_map
from efficient_slowfast_tpu.utils.torch_ckpt import export_torch_state_dict
from efficient_slowfast_tpu_torch.data import transform as T
from efficient_slowfast_tpu_torch.data.build import build_dataset
from efficient_slowfast_tpu_torch.data.loader import (construct_loader,
                                                      prefetch_to_device)
from efficient_slowfast_tpu_torch.data.preprocess import \
    make_detection_preprocess
from efficient_slowfast_tpu_torch.engine.test import detection_box_mask
from efficient_slowfast_tpu_torch.engine.test import test as run_test
from efficient_slowfast_tpu_torch.engine.train import train
from efficient_slowfast_tpu_torch.utils import ava_eval_helper as port_eval
from efficient_slowfast_tpu_torch.utils import ava_evaluation as port_evaluation
from efficient_slowfast_tpu_torch.utils.meters import TestMeter as PortTestMeter
from efficient_slowfast_tpu_torch.utils.meters import get_map
from test_ava import ava_cfg, detection_engine_cfg, make_ava_fixture
from test_torch_port_detection import to_port
from torch_port_helpers import seeded_variables

jax_test_engine = importlib.import_module("efficient_slowfast_tpu.engine.test")
jax_train_engine = importlib.import_module(
    "efficient_slowfast_tpu.engine.train")


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return make_ava_fixture(tmp_path_factory.mktemp("ava"))


@pytest.fixture(autouse=True, scope="module")
def _restore_jax_options():
    yield
    configure(jax_get_cfg())  # JAX keeps its kernel options process-wide


def assert_items_equal(ours, theirs):
    assert set(ours) == set(theirs)
    for k in theirs:
        a, b = np.asarray(ours[k]), np.asarray(theirs[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("split, option", [
    ("train", None), ("test", None), ("val", "AVA.FULL_TEST_ON_VAL"),
    ("test", "AVA.BGR"), ("test", "AVA.TEST_FORCE_FLIP"),
    ("train", "AVA.BGR")])
def test_ava_items_are_jax_items_byte_for_byte(fx, split, option):
    jcfg = ava_cfg(fx)
    if option:
        section, key = option.split(".")
        setattr(getattr(jcfg, section), key, True)
    ours = build_dataset("ava", to_port(jcfg), split)
    theirs = jax_build_dataset("ava", jcfg, split)
    assert len(ours) == len(theirs) == 2
    assert ours._video_idx_to_name == theirs._video_idx_to_name
    for i in range(len(theirs)):
        assert_items_equal(ours[i], theirs[i])
    item = ours[0]
    assert item["frames"].shape == ours.frames_shape()
    assert item["box_mask"].sum() == 2 and item["box_labels"][0, 4] == 1.0


def test_val_keyframes_are_every_fourth_second_unless_full(fx):
    """The fixture's keyframes are at second 902: val drops them (902 % 4
    != 0) unless AVA.FULL_TEST_ON_VAL, in both packages."""
    jcfg = ava_cfg(fx)
    assert len(build_dataset("ava", to_port(jcfg), "val")) == len(
        jax_build_dataset("ava", jcfg, "val")) == 0


def test_ava_batches_through_the_loader_with_the_pad_mask(fx):
    """An eval batch of 3 holds the 2 keyframes and one padding clip
    (``_valid`` 0), filled through the dataset's ``getitem_into`` (the
    path of the pinned ring); its boxes drop out of the mask."""
    cfg = to_port(ava_cfg(fx))
    cfg.TEST.DATASET = "ava"
    cfg.TEST.BATCH_SIZE = 3
    cfg.DATA_LOADER.NUM_WORKERS = 2
    loader = construct_loader(cfg, "test")
    assert loader._fill() == loader.dataset.getitem_into
    (batch,) = list(prefetch_to_device(loader, "cpu"))
    ds = loader.dataset
    for k in ("frames", "width", "boxes", "ori_boxes", "box_labels",
              "box_mask", "metadata", "index", "label", "spatial_idx",
              "temporal_idx"):
        want = np.stack([np.asarray(ds[i][k]) for i in (0, 1, 1)])
        np.testing.assert_array_equal(batch[k].numpy(), want, err_msg=k)
    np.testing.assert_array_equal(batch["_valid"].numpy(), [1, 1, 0])
    mask = detection_box_mask(batch).reshape(3, -1)
    np.testing.assert_array_equal(mask.sum(1), [2, 1, 0])
    np.testing.assert_array_equal(
        mask.reshape(-1), jax_test_engine.detection_box_mask(
            {k: np.asarray(v) for k, v in batch.items()}))


def eval_cases():
    """(GT, detections) dicts keyed by image: perfect, shuffled scores and
    partial (half the detections dropped, boxes jittered)."""
    rs = np.random.RandomState(0)
    gt, det = {}, {}
    for img in range(6):
        n = rs.randint(1, 5)
        xy = rs.rand(n, 2) * 0.6
        boxes = np.concatenate([xy, xy + 0.1 + rs.rand(n, 2) * 0.3], 1)
        classes = rs.randint(1, 4, n)
        gt[f"img{img}"] = (boxes, classes)
        det[f"img{img}"] = (boxes.copy(), classes.copy(), rs.rand(n) + 0.5)
    perm = np.random.RandomState(1).permutation
    shuffled = {k: (b[perm(len(b))], c, perm(s)) for k, (b, c, s) in det.items()}
    partial = {}
    for k, (b, c, s) in det.items():
        keep = np.arange(len(b)) % 2 == 0
        jitter = np.random.RandomState(2).rand(*b.shape) * 0.08
        partial[k] = (b[keep] + jitter[keep], c[keep], s[keep])
    return gt, {"perfect": det, "shuffled": shuffled, "partial": partial}


@pytest.mark.parametrize("which", ["perfect", "shuffled", "partial"])
def test_pascal_evaluator_matches_jax(which):
    gt, dets = eval_cases()
    cats = [{"id": i, "name": f"c{i}"} for i in (1, 2, 3)]
    results = []
    for mod in (port_evaluation, jax_evaluation):
        ev = mod.PascalDetectionEvaluator(cats)
        for k, (b, c) in gt.items():
            ev.add_single_ground_truth_image_info(k, {"boxes": b,
                                                      "classes": c})
        for k, (b, c, s) in dets[which].items():
            ev.add_single_detected_image_info(
                k, {"boxes": b, "classes": c, "scores": s})
        results.append(ev.evaluate())
    assert results[0] == results[1]
    m = results[0]["PascalBoxes_Precision/mAP@0.5IOU"]
    assert (m == 1.0) if which == "perfect" else (0.0 <= m < 1.0)


@pytest.mark.parametrize("which", ["perfect", "shuffled", "partial"])
def test_evaluate_ava_matches_jax(fx, which):
    ann = fx["ann_dir"]
    results = []
    for mod in (port_eval, jax_eval):
        cats, ids = mod.read_labelmap(str(ann / "label_map.pbtxt"))
        gt = mod.read_csv(str(ann / "gt.csv"), ids)
        excluded = mod.read_exclusions(str(ann / "excl.csv"))
        preds = np.full((3, 80), 0.01)
        preds[[0, 1, 2], [4, 11, 4]] = 0.9  # the GT classes
        if which == "shuffled":
            preds = np.random.RandomState(3).permutation(preds.ravel()).reshape(
                preds.shape)
        boxes = np.array([[0, 0.1, 0.1, 0.6, 0.9], [0, 0.5, 0.2, 0.9, 0.8],
                          [0, 0.2, 0.3, 0.7, 0.9]])
        metadata = np.array([[0, 902], [0, 902], [1, 902]])
        if which == "partial":
            preds, boxes, metadata = preds[:2], boxes[:2], metadata[:2]
        results.append(mod.evaluate_ava(
            preds, boxes, metadata, excluded, ids, cats, groundtruth=gt,
            video_idx_to_name=["vidA", "vidB"]))
    assert results[0] == results[1]
    if which == "perfect":
        assert results[0] == 1.0


def map_cases():
    rs = np.random.RandomState(0)
    labels = (rs.rand(40, 7) < 0.3).astype(np.int64)
    labels[:, 3] = 0  # a class with no positive: left out
    scores = rs.rand(40, 7)
    return {
        "random": (scores, labels),
        "tied": (np.round(scores * 4) / 4, labels),
        "all zero columns": (scores, np.zeros_like(labels)),
        "one class": (scores[:, :1], labels[:, :1]),
        "empty": (np.zeros((0, 7)), np.zeros((0, 7), np.int64)),
    }


@pytest.mark.parametrize("which", sorted(map_cases()))
def test_get_map_matches_sklearns(which):
    scores, labels = map_cases()[which]
    ours, theirs = get_map(scores, labels), jax_get_map(scores, labels)
    assert abs(ours - theirs) <= 1e-12, (ours, theirs)
    if which in ("all zero columns", "empty"):
        assert ours == 0.0


def test_multi_label_test_meter_matches_jax():
    rs = np.random.RandomState(5)
    videos, clips, classes = 6, 3, 5
    labels = (rs.rand(videos, classes) < 0.4).astype(np.int64)
    meters = [PortTestMeter(videos, clips, classes, 1, multi_label=True,
                            ensemble_method=m) for m in ("sum", "max")]
    theirs = [JaxTestMeter(videos, clips, classes, 1, multi_label=True,
                           ensemble_method=m) for m in ("sum", "max")]
    for _ in range(2):
        ids = rs.permutation(videos * clips)[:9]
        preds = rs.rand(9, classes)
        for m in meters + theirs:
            m.update_stats(preds, labels[ids // clips], ids)
    rest = np.setdiff1d(np.arange(videos * clips), [])
    for m in meters + theirs:
        m.clip_count[:] = clips  # every clip in: finalize does not raise
    for ours, ref in zip(meters, theirs):
        np.testing.assert_array_equal(ours.video_preds, ref.video_preds)
        assert ours.finalize_metrics() == ref.finalize_metrics()
        assert 0.0 < ours.stats["map"] <= 1.0
    assert rest.size == videos * clips


def frames_np(seed=0, shape=(2, 4, 32, 64, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


def test_detection_serving_preprocess_matches_jax(fx):
    cfg = ava_cfg(fx)
    cfg.SLOWFAST.ALPHA = 4
    frames = frames_np()
    ref = jax_detection_preprocess(cfg)(jnp.asarray(frames))
    out = make_detection_preprocess(to_port(cfg))(torch.from_numpy(frames))
    assert [tuple(p.shape) for p in out] == [(2, 1, 32, 64, 3),
                                             (2, 4, 32, 64, 3)]
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_detection_train_preprocess_pieces_match_jax():
    """The crop of given windows and the boxes through it, the flip, the
    colour jitter and the PCA lighting noise, each with JAX's draws given,
    at 1e-5."""
    frames = frames_np(1)
    crop = 24
    windows = np.array([[0.0, 5.5, 30.0, 35.5], [2.0, 20.0, 26.0, 44.0]],
                       np.float32)
    boxes = np.array([[[3.0, 2.0, 30.0, 28.0], [0.0, 0.0, 0.0, 0.0]],
                      [[25.0, 1.0, 63.0, 31.0], [30.0, 10.0, 40.0, 20.0]]],
                     np.float32)
    x = jnp.asarray(frames).astype(jnp.float32) / 255.0
    ref = JT.crop_and_resize(x, jnp.asarray(windows), crop)
    got = T.crop_and_resize(torch.from_numpy(frames), windows, crop) / 255.0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    ref_boxes = JT.transform_boxes_to_crop(boxes, windows, crop)
    got_boxes = T.transform_boxes_to_crop(torch.from_numpy(boxes), windows,
                                          crop)
    np.testing.assert_allclose(got_boxes.numpy(), np.asarray(ref_boxes),
                               atol=1e-5)

    key = jax.random.PRNGKey(7)
    rf, rb = JT.horizontal_flip_with_boxes(key, ref, ref_boxes)
    do = np.array(jax.random.uniform(key, (2,)) < 0.5)
    gf, gb = T.horizontal_flip_with_boxes(None, got, got_boxes, do=do)
    np.testing.assert_allclose(gf.numpy(), np.asarray(rf), atol=1e-5)
    np.testing.assert_allclose(gb.numpy(), np.asarray(rb), atol=1e-5)

    for var in ((0.4, 0.4, 0.4), (0.4, 0.0, 0.2)):
        ref_c = JT.color_jitter(key, rf, *var)
        ks = jax.random.split(key, 4)
        order = np.array(jax.random.permutation(ks[0], 3))
        alphas = np.stack([np.asarray(1.0 + jax.random.uniform(
            ks[i + 1], (2,), minval=-v, maxval=v)) for i, v in enumerate(var)])
        got_c = T.color_jitter(None, gf, *var, order=order, alphas=alphas)
        np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c),
                                   atol=1e-5)

    cfg = jax_get_cfg()
    eig = (cfg.AVA.TRAIN_PCA_EIGVAL, cfg.AVA.TRAIN_PCA_EIGVEC)
    ref_l = JT.lighting_jitter(key, rf, 0.1, *eig)
    alpha = np.array(jax.random.normal(key, (2, 3)) * 0.1)
    got_l = T.lighting_jitter(None, gf, 0.1, *eig, alpha=alpha)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l), atol=1e-5)


def test_detection_train_preprocess_runs_with_its_draws(fx):
    """The whole train preprocess on its generator: pathways of the crop's
    size, boxes inside the crop, padded slots still zero after the flip's
    mirror is clipped, colour and PCA jitter on."""
    from efficient_slowfast_tpu_torch.data.preprocess import \
        make_detection_train_preprocess

    cfg = to_port(ava_cfg(fx))
    cfg.SLOWFAST.ALPHA = 4
    cfg.DATA.TRAIN_CROP_SIZE = 24
    cfg.AVA.TRAIN_USE_COLOR_AUGMENTATION = True
    cfg.AVA.TRAIN_PCA_JITTER_ONLY = False
    boxes = torch.tensor([[[3.0, 2.0, 30.0, 28.0], [5.0, 5.0, 9.0, 9.0]],
                          [[25.0, 1.0, 47.0, 31.0], [30.0, 10.0, 40.0, 20.0]]])
    pre = make_detection_train_preprocess(cfg)
    gen = torch.Generator().manual_seed(0)
    paths, out = pre(gen, torch.from_numpy(frames_np(2)), [48, 40], boxes)
    assert [tuple(p.shape) for p in paths] == [(2, 1, 24, 24, 3),
                                               (2, 4, 24, 24, 3)]
    assert out.shape == boxes.shape
    assert bool(((out >= 0) & (out <= 23)).all())
    again, out2 = pre(torch.Generator().manual_seed(0),
                      torch.from_numpy(frames_np(2)), [48, 40], boxes)
    assert torch.equal(out, out2) and torch.equal(again[1], paths[1])


def test_train_then_test_map_matches_jax(fx, tmp_path):
    """Both packages train one epoch (2 keyframes, one step of 2 clips)
    from the same bridged weights and test the checkpoint: the frame mAP
    within 1e-4. Their train crops and flips are drawn from different
    generators, so the trained weights differ by a step's noise; the mAP
    ranks each class's scores over the fixture's 3 boxes, and the step
    (lr 0.001) moves no score past another. On the bridged weights
    themselves, test() gives JAX's mAP too."""
    jcfg = detection_engine_cfg(fx, tmp_path / "jax")
    jcfg.MODEL.DROPOUT_RATE = 0.0
    jcfg.SOLVER.BASE_LR = 0.001
    jcfg.TPU.DATA_AXIS = 1
    jcfg.TPU.DONATE = False
    variables = seeded_variables(to_port(jcfg))
    sd = export_torch_state_dict(variables["params"], variables["batch_stats"])
    path = tmp_path / "init.pyth"
    torch.save({"model_state": {k: torch.from_numpy(np.array(v))
                                for k, v in sd.items()}}, path)
    jcfg.TRAIN.CHECKPOINT_FILE_PATH = str(path)
    jcfg.TRAIN.CHECKPOINT_TYPE = "pytorch"
    cfg = to_port(jcfg)
    cfg.OUTPUT_DIR = str(tmp_path / "port")

    # the bridged weights, untrained
    jcfg.TEST.CHECKPOINT_FILE_PATH = cfg.TEST.CHECKPOINT_FILE_PATH = str(path)
    jcfg.TEST.CHECKPOINT_TYPE = cfg.TEST.CHECKPOINT_TYPE = "pytorch"
    theirs0 = jax_test_engine.test(jcfg)["map"]
    ours0 = run_test(cfg, device="cpu")
    assert abs(ours0.full_map - theirs0) <= 1e-4
    assert ours0.stats["map"] == ours0.full_map
    assert sum(len(p) for p in ours0.all_preds) == 3  # the real boxes

    # train, then test the last checkpoint
    jcfg.TEST.CHECKPOINT_FILE_PATH = cfg.TEST.CHECKPOINT_FILE_PATH = ""
    jstate = jax_train_engine.train(jcfg)
    theirs = jax_test_engine.test(jcfg)["map"]
    state = train(cfg, device="cpu")
    assert int(jstate.step) == state.step == 1
    ours = run_test(cfg, device="cpu").full_map
    assert 0.0 <= ours <= 1.0 and abs(ours - theirs) <= 1e-4
