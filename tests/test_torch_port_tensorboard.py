"""TensorBoard in the port against the JAX package: the confusion matrix
(numpy's own) equal to JAX's through sklearn; what the writer is given in
``train_epoch`` and ``eval_epoch`` (the same steps' metrics and scores on
both sides), by ``train()`` (its lifecycle and the val error) and by
``visualize`` (the test inputs, de-normalized, at 1e-6): the same calls,
tags and steps. Then one real event file of the port's CLI read back."""

import importlib
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.data.loader import \
    construct_loader as jax_construct_loader
from efficient_slowfast_tpu.parallel.mesh import build_mesh
from efficient_slowfast_tpu.utils import meters as jax_meters
from efficient_slowfast_tpu.visualization import \
    tensorboard_vis as jax_tensorboard_vis
from efficient_slowfast_tpu.visualization import utils as jax_vis_utils
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.data.loader import construct_loader
from efficient_slowfast_tpu_torch.engine import train as port_train
from efficient_slowfast_tpu_torch.engine import visualization as port_vis
from efficient_slowfast_tpu_torch.engine.state import TrainState
from efficient_slowfast_tpu_torch.tools import run_net
from efficient_slowfast_tpu_torch.utils import meters
from efficient_slowfast_tpu_torch.visualization import tensorboard_vis
from efficient_slowfast_tpu_torch.visualization import utils as vis_utils

# the JAX package's engine/__init__ shadows these modules with functions
jax_train = importlib.import_module("efficient_slowfast_tpu.engine.train")
jax_vis = importlib.import_module("efficient_slowfast_tpu.engine.visualization")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = 6
# tensorboard's own switch to its TensorFlow stub (the module its notf
# build ships): where TensorFlow is installed, importing it for a local
# event file costs more than the rest of this file
sys.modules.setdefault("tensorboard.compat.notf",
                       types.ModuleType("tensorboard.compat.notf"))
TRAIN_CLIPS, VAL_CLIPS, BATCH = 6, 5, 2  # 3 steps; val 2 + 2 + 1 padded


class Writer:
    """A TensorboardWriter that records its calls."""

    calls: list = []

    def __init__(self, cfg):
        Writer.calls.append(("init",))

    def add_scalars(self, data, global_step=None):
        Writer.calls.append(("scalars", dict(data), global_step))

    def plot_eval(self, preds, labels, global_step=None):
        Writer.calls.append(("plot_eval", np.asarray(preds),
                             np.asarray(labels), global_step))

    def add_video(self, video, tag=None, global_step=None):
        Writer.calls.append(("video", tag, global_step, np.asarray(video)))

    def close(self):
        Writer.calls.append(("close",))


def record(run):
    Writer.calls = []
    run()
    return Writer.calls


def assert_calls_equal(got, want, atol):
    assert [c[0] for c in got] == [c[0] for c in want]
    for g, w in zip(got, want):
        if g[0] == "scalars":
            assert g[2] == w[2] and list(g[1]) == list(w[1]), (g, w)
            np.testing.assert_allclose(list(g[1].values()),
                                       list(w[1].values()), rtol=0, atol=atol)
        elif g[0] == "plot_eval":
            assert g[3] == w[3]
            np.testing.assert_allclose(g[1], w[1], rtol=0, atol=atol)
            np.testing.assert_array_equal(g[2], w[2])
        elif g[0] == "video":
            assert g[1:3] == w[1:3] and g[3].shape == w[3].shape
            np.testing.assert_allclose(g[3], w[3], rtol=0, atol=atol)


def tiny_cfg(get, out_dir=""):
    cfg = get()
    cfg.MODEL.MODEL_NAME = "SlowFastShuffleNetV2"
    cfg.MODEL.NUM_CLASSES = CLASSES
    cfg.SLOWFAST.ALPHA, cfg.SLOWFAST.BETA_INV = 4, 8
    cfg.SLOWFAST.WIDTH_MULTI = 0.25
    cfg.DATA.NUM_FRAMES, cfg.DATA.SAMPLING_RATE = 8, 2
    cfg.DATA.CROP_SIZE = cfg.DATA.TRAIN_CROP_SIZE = 16
    cfg.DATA.TEST_CROP_SIZE = 16
    cfg.DATA.TRAIN_JITTER_SCALES = [16, 20]
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "synthetic"
    cfg.TRAIN.BATCH_SIZE = BATCH
    cfg.TEST.BATCH_SIZE = 16  # 8 videos x 3 views = 24 clips: 16 + 8 padded
    cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = 1, 3
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.METRICS_PERIOD = 2
    cfg.TPU.DATA_AXIS = 1
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.TENSORBOARD.ENABLE = True
    cfg.TENSORBOARD.CONFUSION_MATRIX.ENABLE = True
    cfg.TENSORBOARD.HISTOGRAM.ENABLE = True
    cfg.OUTPUT_DIR = out_dir
    return cfg


def loaders(cfg, construct):
    out = []
    for split, n in (("train", TRAIN_CLIPS), ("val", VAL_CLIPS)):
        ld = construct(cfg, split)
        for name in ("_path_to_videos", "_labels", "_spatial_temporal_idx"):
            setattr(ld.dataset, name, getattr(ld.dataset, name)[:n])
        out.append(ld)
    return out


def metrics(i):
    """Step i's metrics, the same on both sides."""
    return {"loss": 2.0 - 0.1 * i, "top1_err": 50.0 + i, "top5_err": 10.0 * i}


def scores(labels):
    """Seeded score rows for a batch (argmax right for some labels)."""
    rs = np.random.RandomState(int(np.asarray(labels).sum()))
    rows = rs.rand(len(labels), CLASSES).astype(np.float32)
    rows[::2, np.asarray(labels)[::2] % CLASSES] += 1.0
    return rows


def test_confusion_matrix_equals_sklearns_through_jax():
    rs = np.random.RandomState(0)
    preds = rs.rand(40, 7)
    labels = rs.randint(0, 5, 40)  # classes 5 and 6 never true: empty rows
    for normalize in ("true", "pred", "all", None):
        got = vis_utils.get_confusion_matrix(preds, labels, 7, normalize)
        want = jax_vis_utils.get_confusion_matrix(preds, labels, 7, normalize)
        assert got.dtype == want.dtype and got.shape == (7, 7)
        np.testing.assert_array_equal(got, want)
    got = vis_utils.get_confusion_matrix(preds.argmax(1), labels, 7)
    assert np.allclose(got.sum(1), [1, 1, 1, 1, 1, 0, 0])
    assert vis_utils.plot_confusion_matrix(got, 7) is not None
    assert vis_utils.plot_topk_histogram(1, got[1], topk=3) is not None


def test_epochs_give_the_writer_what_jax_gives_it():
    """train_epoch's per-step scalars and eval_epoch's plot of the whole
    val set without its padding, from the same steps' outputs."""
    # JAX
    cfg = tiny_cfg(jax_get_cfg)
    mesh = build_mesh(cfg)
    train_loader, val_loader = loaders(cfg, jax_construct_loader)
    steps = iter(range(100))

    def jax_step(state, inputs, labels, lr, rng):
        m = metrics(next(steps))
        return state, {**m, "lr": lr}

    def jax_eval(state, inputs, labels, valid):
        rows = scores(np.asarray(labels))
        keep = np.ones(len(rows)) if valid is None else np.asarray(valid)
        return {"preds": jnp.asarray(rows), "top1_err": 30.0,
                "top5_err": 5.0, "num_valid": float(keep.sum())}

    def jax_run():
        writer = Writer(cfg)
        jax_train.train_epoch(cfg, None, jax_step, lambda *a: None,
                              train_loader,
                              jax_meters.TrainMeter(len(train_loader), cfg),
                              1, mesh, jax.random.PRNGKey(0), writer=writer)
        jax_train.eval_epoch(cfg, None, jax_eval, lambda *a: None,
                             val_loader,
                             jax_meters.ValMeter(len(val_loader), cfg), 1,
                             mesh, jax.random.PRNGKey(0), writer=writer)

    want = record(jax_run)

    # the port
    cfg = tiny_cfg(get_cfg)
    train_loader, val_loader = loaders(cfg, construct_loader)
    state = TrainState(torch.nn.Linear(1, 1), None, None)
    steps = iter(range(100))

    def step(state, inputs, labels, lr, generator=None):
        m = metrics(next(steps))
        return {k: torch.tensor(v) for k, v in {**m, "lr": lr}.items()}

    def eval_step(state, inputs, labels, valid=None):
        keep = torch.ones(len(labels)) if valid is None else valid
        return {"preds": torch.from_numpy(scores(labels.numpy())),
                "top1_err": torch.tensor(30.0), "top5_err": torch.tensor(5.0),
                "num_valid": keep.sum()}

    def run():
        writer = Writer(cfg)
        port_train.train_epoch(cfg, state, step, lambda *a: None,
                               train_loader,
                               meters.TrainMeter(len(train_loader), cfg), 1,
                               writer=writer)
        port_train.eval_epoch(cfg, state, eval_step, lambda *a: None,
                              val_loader, meters.ValMeter(len(val_loader), cfg),
                              1, writer=writer)

    got = record(run)
    assert [c[2] for c in got if c[0] == "scalars"] == [3, 4, 5]
    assert got[-1][0] == "plot_eval" and got[-1][1].shape == (VAL_CLIPS,
                                                              CLASSES)
    assert_calls_equal(got, want, atol=1e-6)


def test_train_makes_feeds_and_closes_the_writer_as_jax_does(monkeypatch,
                                                             tmp_path):
    """train(): a writer where TENSORBOARD.ENABLE says, given to each
    epoch, the val error after each eval epoch, closed at the end."""
    def fake_epochs(module):
        seen = []

        def train_epoch(cfg, state, *args, writer=None, **kw):
            seen.append(writer)
            return state

        def eval_epoch(cfg, state, step, pre, loader, meter, cur_epoch,
                       *args, writer=None, **kw):
            seen.append(writer)
            return 10.0 * (cur_epoch + 1)

        monkeypatch.setattr(module, "train_epoch", train_epoch)
        monkeypatch.setattr(module, "eval_epoch", eval_epoch)
        return seen

    def opts(cfg):
        cfg.SOLVER.MAX_EPOCH = 3
        cfg.TRAIN.CHECKPOINT_PERIOD = 100
        cfg.TRAIN.EVAL_PERIOD = 1
        cfg.BN.USE_PRECISE_STATS = False
        cfg.LOG_MODEL_INFO = False
        return cfg

    monkeypatch.setattr(jax_tensorboard_vis, "TensorboardWriter", Writer)
    monkeypatch.setattr(tensorboard_vis, "TensorboardWriter", Writer)
    # the epochs are fakes: skip JAX's init compile of a state they ignore
    monkeypatch.setattr(jax_train, "create_train_state",
                        lambda cfg, model, rng: (None, None))
    monkeypatch.setattr(jax_train, "shard_state", lambda state, mesh: state)
    jax_seen = fake_epochs(jax_train)
    want = record(lambda: jax_train.train(opts(tiny_cfg(
        jax_get_cfg, str(tmp_path / "jax")))))
    seen = fake_epochs(port_train)
    got = record(lambda: port_train.train(opts(tiny_cfg(
        get_cfg, str(tmp_path / "port"))), device="cpu"))
    assert got == want == [("init",)] + [
        ("scalars", {"Val/Top1_err": 10.0 * (e + 1)}, e) for e in range(3)
    ] + [("close",)]
    assert len(seen) == len(jax_seen) == 6 and all(
        isinstance(w, Writer) for w in seen + jax_seen)


def test_visualize_writes_the_test_inputs_as_jax_does(monkeypatch, tmp_path):
    """Every real clip of the test loader, a pathway and batch at a time:
    24 clips in a batch of 16 and one of 8 (8 pad rows dropped)."""
    monkeypatch.setattr(jax_vis, "TensorboardWriter", Writer)
    monkeypatch.setattr(port_vis, "TensorboardWriter", Writer)
    # JAX's visualize makes a train state it never uses: skip its compile
    monkeypatch.setattr(jax_vis, "create_train_state",
                        lambda cfg, model, rng: (None, None))
    monkeypatch.setattr(jax_vis, "cu", types.SimpleNamespace(
        load_test_checkpoint=lambda cfg, state: state))
    want = record(lambda: jax_vis.visualize(tiny_cfg(jax_get_cfg,
                                                     str(tmp_path))))
    got = record(lambda: port_vis.visualize(tiny_cfg(get_cfg, str(tmp_path)),
                                            device="cpu"))
    videos = [c for c in got if c[0] == "video"]
    assert [(c[1], c[2], c[3].shape[:2]) for c in videos] == [
        ("Video Input Pathway 0", 0, (16, 2)),
        ("Video Input Pathway 1", 0, (16, 8)),
        ("Video Input Pathway 0", 1, (8, 2)),
        ("Video Input Pathway 1", 1, (8, 8))]
    assert all(0 <= c[3].min() and c[3].max() <= 1 for c in videos)
    assert_calls_equal(got, want, atol=1e-6)


def test_the_cli_writes_an_event_file_of_the_jax_tags(tmp_path):
    """tools/run_net.py with TENSORBOARD (the confusion matrix and the
    histograms on) and MODEL_VIS: the event file read back holds JAX's
    scalar tags at JAX's steps and the figures."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    out = str(tmp_path / "run")
    run_net.main(["--device", "cpu", "--cfg", os.path.join(
        ROOT, "configs/Synthetic/SHUFFLENETV2_TINY.yaml"),
        "OUTPUT_DIR", out, "DATA.NUM_FRAMES", "4",
        "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1",
        "TEST.BATCH_SIZE", "8", "TRAIN.BATCH_SIZE", "16",
        "TENSORBOARD.ENABLE", "True", "TENSORBOARD.MODEL_VIS.ENABLE", "True",
        "TENSORBOARD.CONFUSION_MATRIX.ENABLE", "True",
        "TENSORBOARD.HISTOGRAM.ENABLE", "True",
        "TENSORBOARD.HISTOGRAM.TOPK", "2"])
    log_dir = os.path.join(out, "runs-synthetic")
    events = EventAccumulator(log_dir, size_guidance={"images": 0}).Reload()
    tags = events.Tags()
    train = ["Train/loss", "Train/lr", "Train/Top1_err", "Train/Top5_err"]
    assert set(train + ["Val/Top1_err"]) <= set(tags["scalars"])
    for tag in train:  # 64 train clips in steps of 16
        assert [e.step for e in events.Scalars(tag)] == [0, 1, 2, 3]
    assert [e.step for e in events.Scalars("Val/Top1_err")] == [0]
    assert {"Confusion Matrix"} | {f"Top-k error {i}" for i in range(10)} \
        <= set(tags["images"])


def test_class_names_and_demo_labels_read_as_jax_reads_them(tmp_path):
    from efficient_slowfast_tpu.utils import misc as jax_misc
    from efficient_slowfast_tpu_torch.utils import misc

    names = tmp_path / "names.json"
    names.write_text('{"walk": 1, "run": 0, "jump": 3}')
    parents = tmp_path / "parents.json"
    parents.write_text('{"move": ["walk", "run"]}')
    subset = tmp_path / "subset.txt"
    subset.write_text("run\njump\n")
    got = misc.get_class_names(str(names), str(parents), str(subset))
    assert got == jax_misc.get_class_names(str(names), str(parents),
                                           str(subset))
    assert got[0] == ["run", "walk", None, "jump"]
    for text in ("id,name\n1,swipe left\n2,swipe, right\n", "a\n\nb\n", ""):
        labels = tmp_path / "labels.csv"
        labels.write_text(text)
        assert misc.load_demo_labels(str(labels)) == \
            jax_misc.load_demo_labels(str(labels))


def test_visualize_across_processes_names_item_7(monkeypatch, tmp_path):
    """Item 7 has come: across processes each batch's clips are gathered
    from every rank (here a second rank's rows are the same clips) and
    only the master writes them."""
    from efficient_slowfast_tpu_torch.parallel import distributed

    gathered = []

    def gather(*arrays):
        gathered.append(len(arrays[0]))
        return tuple(np.concatenate([a, a]) for a in arrays)

    monkeypatch.setattr(port_vis, "gather_across_hosts", gather)
    monkeypatch.setattr(port_vis, "TensorboardWriter", Writer)
    written = {}
    for rank in (0, 1):
        monkeypatch.setattr(distributed, "is_master", lambda: rank == 0)
        got = record(lambda: port_vis.visualize(
            tiny_cfg(get_cfg, str(tmp_path)), device="cpu"))
        written[rank] = [(c[1], c[2], c[3].shape[:2]) for c in got
                         if c[0] == "video"]
    assert gathered == [16, 8] * 2
    assert written[1] == []
    assert written[0] == [("Video Input Pathway 0", 0, (32, 2)),
                          ("Video Input Pathway 1", 0, (32, 8)),
                          ("Video Input Pathway 0", 1, (16, 2)),
                          ("Video Input Pathway 1", 1, (16, 8))]
