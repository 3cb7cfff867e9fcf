"""Training and testing on the frame datasets, the port against the JAX
package, f32 on the CPU: sync-BN in one process (plain BN), the Charades
and SSv2 yamls, a Charades train step and eval forward (multi-hot labels
through ``bce_logit``, sigmoid scores) at rtol = atol = 1e-4, Charades'
30-view test (max ensemble, mAP) on a frame-list fixture, a ``train()``
epoch of the fatigue CMDA yaml through both packages' loaders on a
frame-folder fixture, and the data-loading benchmark's records.

The JAX side of each comparison sets ``TPU.DATA_AXIS 1``: on the suite's 8
virtual devices ``BN.NUM_SYNC_DEVICES 4`` would give it two statistics
groups, where one process of the port has one. Weights come from the
port's seeded init through the weight bridge (a ``.pyth`` where an engine
loads them)."""

import glob
import importlib
import os
import socket
import subprocess
import sys
import threading
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.data import datasets as jax_datasets
from efficient_slowfast_tpu.data import frame_datasets as jax_fd
from efficient_slowfast_tpu.data import host_transforms as jax_ht
from efficient_slowfast_tpu.data.loader import \
    construct_loader as jax_construct_loader
from efficient_slowfast_tpu.engine.state import TrainState as JaxTrainState
from efficient_slowfast_tpu.engine.state import \
    make_train_step as jax_make_train_step
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu.models.optimizer import \
    construct_optimizer as jax_construct_optimizer
from efficient_slowfast_tpu.ops.options import configure
from efficient_slowfast_tpu.parallel.mesh import build_mesh
from efficient_slowfast_tpu.utils import benchmark as jax_benchmark
from efficient_slowfast_tpu.utils import checkpoint as jax_checkpoint
from efficient_slowfast_tpu.utils import meters as jax_meters
from efficient_slowfast_tpu.utils.torch_ckpt import export_torch_state_dict
from efficient_slowfast_tpu_torch.config import load_cfg
from efficient_slowfast_tpu_torch.data import datasets
from efficient_slowfast_tpu_torch.data.build import (DATASET_REGISTRY,
                                                     build_dataset)
from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                       make_forward,
                                                       make_train_step)
from efficient_slowfast_tpu_torch.engine.test import test as run_test
from efficient_slowfast_tpu_torch.engine.train import train
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.ops.norm import BatchNorm3d, get_norm
from efficient_slowfast_tpu_torch.tools import benchmark as benchmark_cli
from efficient_slowfast_tpu_torch.utils import benchmark, meters
from efficient_slowfast_tpu_torch.utils.weights import (
    jax_variables_to_state_dict, state_dict_to_jax_variables)
from test_torch_port_frame_datasets import (NumpyWithRandom, Recorder, Replay,
                                          frame)
from torch_port_helpers import flat_leaves, inputs_np, seeded_variables

jax_train_engine = importlib.import_module("efficient_slowfast_tpu.engine.train")
jax_test_engine = importlib.import_module("efficient_slowfast_tpu.engine.test")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
SYNC_YAMLS = ["configs/Charades/SLOWFAST_16x8_R50.yaml",
              "configs/Charades/SLOWFAST_16x8_R50_multigrid.yaml",
              "configs/SSv2/SLOWFAST_16x8_R50.yaml",
              "configs/SSv2/SLOWFAST_16x8_R50_multigrid.yaml"]
CHARADES = os.path.join(ROOT, SYNC_YAMLS[0])
FATIGUE = os.path.join(ROOT, "configs", "TIRED",
                       "DUAL_TIRED_SLOWFAST_8x8_R50_112_GRAY.yaml")


@pytest.fixture(autouse=True, scope="module")
def _restore_jax_options():
    yield
    configure(jax_get_cfg())  # JAX keeps its kernel options process-wide


def both_cfgs(yaml, opts):
    """(port cfg, JAX cfg) of ``yaml`` with ``opts``, each package's own
    loader."""
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(yaml)
    jcfg.merge_from_list(list(opts) + ["TPU.DATA_AXIS", 1])
    return load_cfg(yaml, opts), jcfg


def save_pyth(variables, path):
    sd = export_torch_state_dict(variables["params"], variables["batch_stats"])
    torch.save({"model_state": {k: torch.from_numpy(np.array(v))
                                for k, v in sd.items()}}, path)
    return str(path)


# -- sync-BN in one process ------------------------------------------------------
@pytest.mark.parametrize("yaml", SYNC_YAMLS)
def test_sync_batchnorm_yaml_builds_as_batchnorm(yaml):
    cfg = load_cfg(os.path.join(ROOT, yaml), ["RESNET.WIDTH_PER_GROUP", 8])
    assert cfg.BN.NORM_TYPE == "sync_batchnorm" and cfg.BN.NUM_SYNC_DEVICES == 4
    assert get_norm(cfg).func is BatchNorm3d
    torch.manual_seed(0)
    sync = build_model(cfg, device="cpu")
    plain_cfg = cfg.clone()
    plain_cfg.BN.NORM_TYPE = "batchnorm"
    torch.manual_seed(0)
    plain = build_model(plain_cfg, device="cpu")
    assert [(n, type(m)) for n, m in sync.named_modules()] == \
        [(n, type(m)) for n, m in plain.named_modules()]
    a, b = sync.state_dict(), plain.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


FRAME_YAMLS = sorted(
    os.path.relpath(p, ROOT) for d in ("TIRED", "WHEEL")
    for p in glob.glob(os.path.join(ROOT, "configs", d, "*.yaml")))


@pytest.mark.parametrize("yaml", FRAME_YAMLS)
def test_fatigue_and_wheel_yamls_build(yaml):
    """Every TIRED and WHEEL yaml builds (width 8) and names a registered
    frame-folder dataset."""
    cfg = load_cfg(os.path.join(ROOT, yaml), ["RESNET.WIDTH_PER_GROUP", 8])
    for name in (cfg.TRAIN.DATASET, cfg.TEST.DATASET):
        assert issubclass(DATASET_REGISTRY.get(name.capitalize()),
                          datasets.Framefolder), name
    model = build_model(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) > 0


_TWO_PROCESSES = r"""
import sys
import torch.distributed as dist
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.ops.norm import effective_sync_groups, get_norm
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
cfg = get_cfg()
cfg.BN.NORM_TYPE = "sync_batchnorm"
groups = []
for sync in (4, 1):
    cfg.BN.NUM_SYNC_DEVICES = sync
    groups.append(effective_sync_groups(cfg))
    try:
        get_norm(cfg)
        print("BUILT")
    except NotImplementedError as e:
        assert "ROADMAP item 7" in str(e), e
        print("REFUSED")
print("GROUPS", groups)
dist.barrier()
dist.destroy_process_group()
"""


def test_sync_batchnorm_across_two_processes_is_refused():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_PROCESSES, str(rank), str(port)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": ROOT}) for rank in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert out.split() == ["REFUSED", "REFUSED", "GROUPS", "[1,", "2]"], out


# -- Charades: a train step and the eval forward ---------------------------------
CHARADES_OPTS = ["RESNET.WIDTH_PER_GROUP", 8, "DATA.NUM_FRAMES", 8,
                 "DATA.CROP_SIZE", 32, "DATA.TRAIN_CROP_SIZE", 32,
                 "DATA.TEST_CROP_SIZE", 32, "MODEL.DROPOUT_RATE", 0.0,
                 "TPU.COMPUTE_DTYPE", "float32"]


def test_charades_train_step_and_eval_forward_match_jax():
    cfg, jcfg = both_cfgs(CHARADES, CHARADES_OPTS)
    assert cfg.MODEL.LOSS_FUNC == "bce_logit" and cfg.MODEL.HEAD_ACT == "sigmoid"
    variables = seeded_variables(cfg)
    inputs = inputs_np(cfg, batch=2, seed=3)
    labels = (np.random.RandomState(4).rand(2, 157) < 0.05).astype(np.float32)
    labels[:, 7] = 1.0
    lr = 0.05

    # JAX
    model = jax_build_model(jcfg)
    tx, _ = jax_construct_optimizer(jcfg, variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(variables["params"]))
    scores = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, [jnp.asarray(x) for x in inputs]))
    state, mets = jax_make_train_step(jcfg, model, tx)(
        state, [jnp.asarray(x) for x in inputs], jnp.asarray(labels), lr,
        jax.random.PRNGKey(0))
    theirs = flat_leaves({"params": state.params,
                          "batch_stats": state.batch_stats})

    # the port
    port = build_model(cfg, device="cpu")
    port.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    ours_scores = make_forward(cfg, port, device="cpu")(
        [torch.from_numpy(x) for x in inputs]).numpy()
    tstate = create_train_state(cfg, port, device="cpu")
    out = make_train_step(cfg, tstate.model, tstate.optimizer)(
        tstate, [torch.from_numpy(x) for x in inputs],
        torch.from_numpy(labels), lr)
    ours = flat_leaves(state_dict_to_jax_variables(port.state_dict()))

    assert ours_scores.shape == (2, 157)
    assert ((ours_scores > 0) & (ours_scores < 1)).all()
    np.testing.assert_allclose(ours_scores, scores, **TOL)
    assert set(out) == {"loss", "lr"}  # multi-label: no top-k errors
    np.testing.assert_allclose(float(out["loss"]), float(mets["loss"]), **TOL)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **TOL)


# -- Charades: the 30-view test ---------------------------------------------------
@pytest.fixture(scope="module")
def charades_split(tmp_path_factory):
    """Three videos of 24 JPEG frames (40 x 56) in a Charades val list,
    every frame of a video with its 1-3 of 6 labels (the meters hold a
    video's views to one label set)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("charades")
    rows = ["original_vido_id video_id frame_id path labels"]
    for v, lbl in enumerate(("0,3", "1", "2,3,5")):
        (root / f"c{v}").mkdir()
        for i in range(24):
            rel = f"c{v}/{i:05d}.jpg"
            Image.fromarray(frame(40, 56, 50 * v + i)).save(root / rel)
            rows.append(f"c{v} {v} {i} {rel} \"{lbl}\"")
    (root / "val.csv").write_text("\n".join(rows) + "\n")
    return root


def test_charades_thirty_view_test_matches_jax(charades_split, tmp_path):
    opts = CHARADES_OPTS + [
        "MODEL.NUM_CLASSES", 6, "DATA.PATH_TO_DATA_DIR", str(charades_split),
        "DATA.PATH_PREFIX", str(charades_split), "TEST.NUM_ENSEMBLE_VIEWS", 2,
        "TEST.NUM_SPATIAL_CROPS", 3, "TEST.BATCH_SIZE", 4,
        "DATA.SAMPLING_RATE", 2,
        "DATA_LOADER.NUM_WORKERS", 2, "OUTPUT_DIR", str(tmp_path)]
    cfg, jcfg = both_cfgs(CHARADES, opts)
    assert cfg.DATA.ENSEMBLE_METHOD == "max" and cfg.DATA.MULTI_LABEL
    variables = seeded_variables(cfg)
    path = save_pyth(variables, tmp_path / "model.pyth")
    for c in (cfg, jcfg):
        c.TEST.CHECKPOINT_FILE_PATH, c.TEST.CHECKPOINT_TYPE = path, "pytorch"

    # JAX's test(), without its model init: the checkpoint overwrites zeros
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params=zeros["params"],
                          batch_stats=zeros["batch_stats"], opt_state=None)
    state = jax_checkpoint.load_test_checkpoint(jcfg, state)
    loader = jax_construct_loader(jcfg, "test")
    theirs = jax_meters.TestMeter(3, 6, 6, len(loader), multi_label=True,
                                  ensemble_method="max")
    jax_stats = jax_test_engine.perform_test(
        jcfg, state, jax_build_model(jcfg), loader, theirs, build_mesh(jcfg))

    ours = run_test(cfg, device="cpu")
    np.testing.assert_array_equal(ours.clip_count, 6)
    np.testing.assert_array_equal(ours.video_labels, theirs.video_labels)
    assert ours.video_labels.sum() > 0
    np.testing.assert_allclose(ours.video_preds, theirs.video_preds,
                               rtol=1e-5, atol=1e-5)
    assert 0.0 <= ours.stats["map"] <= 1.0
    assert abs(ours.stats["map"] - jax_stats["map"]) <= 1e-6


# -- the fatigue CMDA yaml: a train() epoch through both loaders ------------------
@pytest.fixture(scope="module")
def fatigue_split(tmp_path_factory):
    """Five frame folders of 20 JPEG frames (40 x 56): four in the train
    list, three in the val list (labels of the yaml's 3 classes)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("fatigue")
    for v in range(5):
        (root / f"f{v}").mkdir()
        for i in range(20):
            Image.fromarray(frame(40, 56, 70 * v + i)).save(
                root / f"f{v}" / f"{i:05d}.jpg")
    (root / "train.txt").write_text(
        "".join(f"{root}/f{v} {v % 3}\n" for v in range(4)))
    (root / "val.txt").write_text(
        "".join(f"{root}/f{v} {v % 3}\n" for v in (4, 1, 2)))
    return root


class KeyedReplay(Replay):
    """JAX's ``random`` and ``np.random`` in its loader's threads: each
    item's fetch replays the port's draws for the same (split, index)."""

    def __init__(self, logs):
        self.logs = logs
        self.local = threading.local()

    @property
    def log(self):
        return self.local.log

    def fetch(self, orig):
        def run(dataset, index):
            self.local.log = deque(self.logs[(dataset.mode, index)])
            out = orig(dataset, index)
            assert not self.local.log, "JAX left draws unused"
            return out
        return run


def port_draws(cfg, monkeypatch):
    """{(split, index): the port's draws} for the train and val splits at
    epoch 0."""
    logs = {}
    orig = datasets.CanvasDataset._rng
    with monkeypatch.context() as m:
        for split in ("train", "val"):
            ds = build_dataset(cfg.TRAIN.DATASET, cfg, split)
            for i in range(len(ds)):
                log = logs[(split, i)] = []
                m.setattr(datasets.CanvasDataset, "_rng",
                          lambda self, index, log=log: Recorder(
                              orig(self, index), log))
                ds[i]
    return logs


def test_fatigue_cmda_train_epoch_matches_jax(fatigue_split, tmp_path,
                                              monkeypatch):
    """``train()`` of the fatigue CMDA yaml (wheel_gray) through both
    packages' loaders: two steps of 2 clips, a val epoch and a checkpoint,
    the losses at 1e-4. Cut to width 8 and R18 basic blocks (JAX compiles
    the R50 step in ~40 s more), 32² with jitter [32, 32] and no flip (the
    preprocess then draws nothing that moves a pixel), no dropout, no
    precise BN; the host's draws replayed per item."""
    opts = ["RESNET.WIDTH_PER_GROUP", 8, "RESNET.DEPTH", 18,
            "RESNET.TRANS_FUNC", "basic_transform",
            "RESNET.NUM_BLOCK_TEMP_KERNEL", [[2, 2]] * 4,
            "DATA.TRAIN_JITTER_SCALES", [32, 32],
            "DATA.TRAIN_CROP_SIZE", 32, "DATA.CROP_SIZE", 32,
            "DATA.TEST_CROP_SIZE", 32, "DATA.RANDOM_FLIP", False,
            "DATA.PATH_TO_TRAIN_DATA_TXT", str(fatigue_split / "train.txt"),
            "DATA.PATH_TO_VAL_DATA_TXT", str(fatigue_split / "val.txt"),
            "TRAIN.BATCH_SIZE", 2, "SOLVER.MAX_EPOCH", 1,
            "BN.USE_PRECISE_STATS", False, "MODEL.DROPOUT_RATE", 0.0,
            "TPU.COMPUTE_DTYPE", "float32", "DATA_LOADER.NUM_WORKERS", 2]
    cfg, jcfg = both_cfgs(FATIGUE, opts)
    assert cfg.TRAIN.DATASET == "wheel_gray"
    path = save_pyth(seeded_variables(cfg), tmp_path / "init.pyth")
    for c, out in ((cfg, "port"), (jcfg, "jax")):
        c.TRAIN.CHECKPOINT_FILE_PATH, c.TRAIN.CHECKPOINT_TYPE = path, "pytorch"
        c.OUTPUT_DIR = str(tmp_path / out)
    losses = {"port": [], "jax": []}

    def recording(orig, key):
        def update_stats(self, top1, topk, loss, lr, bs):
            losses[key].append(loss)
            return orig(self, top1, topk, loss, lr, bs)
        return update_stats

    for mod, key in ((meters, "port"), (jax_meters, "jax")):
        monkeypatch.setattr(mod.TrainMeter, "update_stats",
                            recording(mod.TrainMeter.update_stats, key))

    replay = KeyedReplay(port_draws(cfg, monkeypatch))
    state = train(cfg, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(jax_datasets.ClipDataset, "_fetch",
                  replay.fetch(jax_datasets.ClipDataset._fetch))
        for mod in (jax_datasets, jax_fd, jax_ht):
            m.setattr(mod, "random", replay)
        m.setattr(jax_ht, "np", NumpyWithRandom(replay))
        jstate = jax_train_engine.train(jcfg)
    assert int(jstate.step) == state.step == 2
    assert len(losses["port"]) == 2 and np.isfinite(losses["port"]).all()
    np.testing.assert_allclose(losses["port"], losses["jax"], **TOL)


# -- the data-loading benchmark ----------------------------------------------------
def test_benchmark_data_loading_logs_jax_records(fatigue_split, tmp_path,
                                                 monkeypatch):
    opts = ["DATA.PATH_TO_TRAIN_DATA_TXT", str(fatigue_split / "train.txt"),
            "TRAIN.DATASET", "tired", "TRAIN.BATCH_SIZE", 2,
            "DATA.NUM_FRAMES", 4, "DATA.TRAIN_JITTER_SCALES", [24, 32],
            "BENCHMARK.NUM_EPOCHS", 2, "BENCHMARK.LOG_PERIOD", 1,
            "DATA_LOADER.NUM_WORKERS", 2, "OUTPUT_DIR", str(tmp_path)]
    cfg, jcfg = both_cfgs(FATIGUE, opts)
    records = {"port": [], "jax": []}
    for mod, key in ((benchmark, "port"), (jax_benchmark, "jax")):
        monkeypatch.setattr(mod, "log_json_stats",
                            lambda s, key=key: records[key].append(dict(s)))
    times = benchmark.benchmark_data_loading(cfg)
    jax_benchmark.benchmark_data_loading(jcfg)
    shape = lambda recs: [(r["_type"], sorted(r)) for r in recs]  # noqa: E731
    assert shape(records["port"]) == shape(records["jax"])
    assert [r["_type"] for r in records["port"]] == (
        ["benchmark_iter"] * 2 + ["benchmark_epoch"]) * 2 + ["benchmark_final"]
    assert len(times) == 2 and all(t > 0 for t in times)
    assert all(r["clips_per_s"] > 0 for r in records["port"]
               if r["_type"] == "benchmark_iter")
    # the CLI: the same run from argv
    records["port"].clear()
    argv = ["--cfg", FATIGUE] + [str(o) for o in opts] + [
        "BENCHMARK.NUM_EPOCHS", "1"]
    assert len(benchmark_cli.main(argv)) == 1
    assert records["port"][-1]["_type"] == "benchmark_final"
