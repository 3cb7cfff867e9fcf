"""The port's 30-view test engine against the JAX package's on one
checkpoint: a ``.pyth`` written from the JAX variables by the JAX package's
``export_torch_state_dict``, set as TEST.CHECKPOINT_FILE_PATH for both; the
synthetic test split with a padded tail batch; per-video scores at
rtol = atol = 1e-4 (tests/test_full_model_parity.py's tolerance) and equal
top-k, for SlowFast through the fused engine (K1's plain version here) and
for CMDA-R50 (K2's plain version), f32 on the CPU."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.data.loader import \
    construct_loader as jax_construct_loader
from efficient_slowfast_tpu.engine.state import TrainState
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu.ops.options import configure
from efficient_slowfast_tpu.parallel.mesh import build_mesh
from efficient_slowfast_tpu.utils import checkpoint as jax_checkpoint
from efficient_slowfast_tpu.utils.meters import TestMeter as JaxTestMeter
from efficient_slowfast_tpu.utils.torch_ckpt import export_torch_state_dict
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.engine.test import perform_test
from efficient_slowfast_tpu_torch.engine.test import test as run_test
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
    flash_attention
from efficient_slowfast_tpu_torch.ops.kernels.fused_bottleneck import \
    fused_bottleneck
from torch_port_helpers import seeded_variables, small_cfg

jax_test_engine = importlib.import_module("efficient_slowfast_tpu.engine.test")

MODELS = {"slowfast_fused": dict(fused=True),
          "cmda": dict(model="SlowFastDualAttention", flash_min_tokens=64)}
VIDEOS, VIEWS, CROPS, BATCH = 8, 2, 3, 10  # 48 clips: 5 batches, 2 padded


def engine_cfg(get_cfg, path, out_dir, **kw):
    """``small_cfg`` at 8 frames and a 32² crop (CMDA's s1/s2 fusions
    attend over 128 tokens, past FLASH_MIN_TOKENS 64), 2 × 3 views of the
    synthetic test split's 8 videos in batches of 10, the checkpoint at
    ``path``, logs under ``out_dir``."""
    cfg = small_cfg(get_cfg, **kw)
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.DATA.CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.TEST.DATASET = "synthetic"
    cfg.TEST.NUM_ENSEMBLE_VIEWS = VIEWS
    cfg.TEST.NUM_SPATIAL_CROPS = CROPS
    cfg.TEST.BATCH_SIZE = BATCH
    cfg.TEST.CHECKPOINT_FILE_PATH = str(path)
    cfg.TEST.CHECKPOINT_TYPE = "pytorch"
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.TPU.DATA_AXIS = 1  # one device, one batch divisor: the port's
    return cfg


@pytest.fixture(autouse=True, scope="module")
def _restore_jax_options():
    yield
    configure(jax_get_cfg())  # JAX keeps its kernel options process-wide


@pytest.fixture(scope="module", params=sorted(MODELS))
def runs(request, tmp_path_factory):
    """(the JAX TestMeter, the port's, the port's kernel launches)."""
    kw = MODELS[request.param]
    out = tmp_path_factory.mktemp(request.param)
    path = out / "model.pyth"
    cfg = engine_cfg(jax_get_cfg, path, out, **kw)
    model = jax_build_model(cfg)
    variables = seeded_variables(engine_cfg(get_cfg, path, out, **kw))
    sd = export_torch_state_dict(variables["params"], variables["batch_stats"])
    torch.save({"model_state": {k: torch.from_numpy(np.array(v))
                                for k, v in sd.items()}}, path)
    # JAX's test(), without its model init: a state of the right shapes
    # that the checkpoint then overwrites
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=zeros["params"],
                       batch_stats=zeros["batch_stats"], opt_state=None)
    state = jax_checkpoint.load_test_checkpoint(cfg, state)
    loader = jax_construct_loader(cfg, "test")
    theirs = JaxTestMeter(VIDEOS, VIEWS * CROPS, cfg.MODEL.NUM_CLASSES,
                          len(loader))
    jax_test_engine.perform_test(cfg, state, model, loader, theirs,
                                 build_mesh(cfg))

    before = (fused_bottleneck.launches, flash_attention.launches)
    ours = run_test(engine_cfg(get_cfg, path, out, **kw), device="cpu")
    launched = (fused_bottleneck.launches - before[0],
                flash_attention.launches - before[1])
    return theirs, ours, launched


def test_thirty_view_scores_match_jax(runs):
    theirs, ours, launched = runs
    assert ours.video_preds.shape == theirs.video_preds.shape == (VIDEOS, 12)
    np.testing.assert_array_equal(ours.clip_count, VIEWS * CROPS)
    np.testing.assert_array_equal(ours.video_labels, theirs.video_labels)
    np.testing.assert_allclose(ours.video_preds, theirs.video_preds,
                               rtol=1e-4, atol=1e-4)
    # summed softmax rows: VIEWS · CROPS per video, so no second softmax
    np.testing.assert_allclose(ours.video_preds.sum(1), VIEWS * CROPS,
                               rtol=1e-5)
    assert ours.stats == theirs.stats
    np.testing.assert_array_equal(np.argsort(-ours.video_preds, 1)[:, :5],
                                  np.argsort(-theirs.video_preds, 1)[:, :5])
    assert launched == (0, 0)  # the plain versions run on CPU tensors


def test_random_init_is_seeded_and_logged(caplog, tmp_path):
    cfg = engine_cfg(get_cfg, "", tmp_path)
    cfg.RESNET.DEPTH, cfg.RESNET.TRANS_FUNC = 18, "basic_transform"
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[2, 2]] * 4
    cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = 1, 1
    cfg.TEST.BATCH_SIZE = 8
    with caplog.at_level("INFO"):
        a = run_test(cfg, device="cpu").video_preds
    assert "Testing with random initialization" in caplog.text
    np.testing.assert_array_equal(run_test(cfg, device="cpu").video_preds, a)


def _int8_test_runs(what, cfg, tmp_path):
    """Item 8's int8 serving, which test() once refused: a
    seeded random-init classifier on the synthetic split, or AVA detection
    on tests/test_ava.py's fixture, calibrates on its first test batch,
    persists the ranges and is scored."""
    from efficient_slowfast_tpu_torch.engine.quantize import calibration_path
    from test_ava import detection_engine_cfg, make_ava_fixture
    from test_torch_port_detection import to_port

    if what == "detection":
        cfg = to_port(detection_engine_cfg(make_ava_fixture(tmp_path / "ava"),
                                           tmp_path / "out"))
        cfg.TRAIN.ENABLE = False
    else:
        cfg.TEST.CHECKPOINT_FILE_PATH = ""
        cfg.RESNET.DEPTH, cfg.RESNET.TRANS_FUNC = 18, "basic_transform"
        cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[2, 2]] * 4
        cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = 1, 1
    cfg.RESNET.WIDTH_PER_GROUP = 16  # no all-zero conv input at random init
    cfg.TPU.INT8_EVAL = True
    meter = run_test(cfg, device="cpu")
    assert os.path.exists(calibration_path(cfg))
    if what == "detection":
        assert 0.0 <= meter.full_map <= 1.0
    else:
        assert meter.stats["_type"] == "test_final"
        assert np.isfinite(meter.video_preds).all()


def _orbax_test_runs(what, cfg, tmp_path):
    """Item 7b's orbax checkpoints, which test() once refused: the JAX
    package's orbax directory, written by its ``save_checkpoint``, by
    path (``jax``) or as a JAX run's last checkpoint (``output_dir``),
    scores a seeded R18 as the same weights' ``.pyth`` does; an empty
    directory raises an error that names the ``_METADATA`` it lacks."""
    from test_torch_port_orbax import write_jax_orbax

    def r18(get):
        c = engine_cfg(get, "", tmp_path)
        c.RESNET.DEPTH, c.RESNET.TRANS_FUNC = 18, "basic_transform"
        c.RESNET.NUM_BLOCK_TEMP_KERNEL = [[2, 2]] * 4
        c.TEST.NUM_ENSEMBLE_VIEWS, c.TEST.NUM_SPATIAL_CROPS = 1, 1
        c.TEST.BATCH_SIZE = 8
        return c

    cfg = r18(get_cfg)
    variables = seeded_variables(cfg)
    pyth = tmp_path / "model.pyth"
    torch.save({"model_state": {
        k: torch.from_numpy(np.array(v)) for k, v in export_torch_state_dict(
            variables["params"], variables["batch_stats"]).items()}}, pyth)
    cfg.TEST.CHECKPOINT_FILE_PATH = str(pyth)
    want = run_test(cfg, device="cpu").video_preds
    run = tmp_path / "jax_run"
    path = write_jax_orbax(r18(jax_get_cfg), variables, run, epoch=0,
                           opt_state=False)
    empty = tmp_path / "empty" / "checkpoints" / "checkpoint_epoch_00001.orbax"
    empty.mkdir(parents=True)
    for real in (True, False):
        if what == "output_dir":  # a JAX run's orbax checkpoint directory
            cfg.TEST.CHECKPOINT_FILE_PATH = ""
            cfg.OUTPUT_DIR = str(run if real else empty.parent.parent)
        else:  # the JAX package's orbax directory, by path
            cfg.TEST.CHECKPOINT_FILE_PATH = path if real else str(empty)
            cfg.TEST.CHECKPOINT_TYPE = what
        if real:
            np.testing.assert_array_equal(
                run_test(cfg, device="cpu").video_preds, want)
        else:
            with pytest.raises(FileNotFoundError, match="_METADATA"):
                run_test(cfg, device="cpu")


@pytest.mark.parametrize("what", ["detection", "int8", "jax",
                                  "output_dir"])
def test_what_later_items_bring_raises(what, tmp_path):
    """Each case once raised NotImplementedError naming the ROADMAP item
    that would bring it; the items have come, and each now runs."""
    cfg = engine_cfg(get_cfg, tmp_path / "model.pyth", tmp_path)
    if what in ("detection", "int8"):  # item 8's int8 serving, now ported
        return _int8_test_runs(what, cfg, tmp_path)
    return _orbax_test_runs(what, cfg, tmp_path)  # item 7b, now ported


def test_caffe2_checkpoint_loads(tmp_path):
    """TEST.CHECKPOINT_TYPE caffe2: the blobs of a Caffe2 pickle that name
    tensors of the model (the stem and the head here) replace the seeded
    init, as a ``.pyth`` of the same weights does."""
    import pickle

    cfg = engine_cfg(get_cfg, tmp_path / "c2_model.pkl", tmp_path)
    cfg.RESNET.DEPTH, cfg.RESNET.TRANS_FUNC = 18, "basic_transform"
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[2, 2]] * 4
    cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = 1, 1
    cfg.TEST.BATCH_SIZE = 8
    torch.manual_seed(cfg.RNG_SEED)  # test()'s init
    state = build_model(cfg, device="cpu").state_dict()
    rs = np.random.RandomState(3)
    blobs = {}
    for blob, name in (("conv1_w", "s1.pathway0_stem.conv.weight"),
                       ("pred_w", "head.projection.weight"),
                       ("pred_b", "head.projection.bias")):
        blobs[blob] = rs.randn(*state[name].shape).astype(np.float32)
        state[name] = torch.from_numpy(blobs[blob])
    with open(tmp_path / "c2_model.pkl", "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    cfg.TEST.CHECKPOINT_TYPE = "caffe2"
    loaded = run_test(cfg, device="cpu").video_preds
    torch.save({"model_state": state}, tmp_path / "same.pyth")
    cfg.TEST.CHECKPOINT_FILE_PATH = str(tmp_path / "same.pyth")
    cfg.TEST.CHECKPOINT_TYPE = "pytorch"
    np.testing.assert_array_equal(loaded,
                                  run_test(cfg, device="cpu").video_preds)
    cfg.TEST.CHECKPOINT_FILE_PATH = ""
    assert np.abs(run_test(cfg, device="cpu").video_preds - loaded).max() \
        > 1e-3  # the seeded init alone gives other scores


def test_no_device_and_no_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        perform_test(get_cfg(), torch.nn.Identity(), [], None)
