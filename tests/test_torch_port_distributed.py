"""The port's multi-process runtime against one process, and against the
JAX package's one-process run of the same global batch, f32 on the CPU.

Ranks are CPU processes over gloo (``DIST_BACKEND gloo``, ``--device
cpu``), started by this file run as a script (``python <this file> rank
world port dir``: ``rank_main``) or through ``tools/run_net.py``; every
child has a deadline (``DEADLINE_S``) at which it is killed, with its
process group, and the test fails. The children start together at the
module fixture's start and run while this process computes the
one-process references.

Held: two train steps of SlowFast (R18-deep bottlenecks, width 16, 8
frames, 32² crop) at 2 ranks on a global batch of 8 against the port's
one process and JAX's step (losses, parameters, BN statistics; the ranks
bit-equal), remat and gradient accumulation under DDP; the grouped BN
against JAX's ``SyncBatchNorm3d`` and ``SubBatchNorm3d`` with a split
that straddles the ranks; the unaligned gather and a two-rank 30-view
``test()`` against JAX's one-process test; the detection mAP; precise BN
and the train draws; the master-only checkpoint, the ``train_complete``
barrier and the state checksum; the CLI's launch contract, both flags."""

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from efficient_slowfast_tpu_torch.config import get_cfg  # noqa: E402
from efficient_slowfast_tpu_torch.engine.precise_bn import \
    calculate_and_update_precise_bn  # noqa: E402
from efficient_slowfast_tpu_torch.engine.state import (  # noqa: E402
    create_train_state, make_train_step, step_generator)
from efficient_slowfast_tpu_torch.engine.test import test as run_test  # noqa
from efficient_slowfast_tpu_torch.data.preprocess import \
    make_train_preprocess  # noqa: E402
from efficient_slowfast_tpu_torch.models import build_model  # noqa: E402
from efficient_slowfast_tpu_torch.models.heads import dropout  # noqa: E402
from efficient_slowfast_tpu_torch.ops.norm import (  # noqa: E402
    SubBatchNorm3d, SyncBatchNorm3d)
from efficient_slowfast_tpu_torch.parallel import distributed  # noqa: E402
from efficient_slowfast_tpu_torch.utils import checkpoint as cu  # noqa: E402

WORLD, BATCH, LR = 2, 8, 0.01
DEADLINE_S = 240
TINY = os.path.join(ROOT, "configs", "Synthetic", "SHUFFLENETV2_TINY.yaml")
VIDEOS, VIEWS, CROPS, TEST_BATCH = 8, 2, 3, 10  # 48 clips; 2 padded
TOL = dict(rtol=1e-4, atol=1e-4)
BN_TOL = dict(rtol=1e-5, atol=1e-5)


def tune(cfg):
    """R18-deep SlowFast bottlenecks at width 16, 8 frames, a 32² crop, as
    the reference configs train (torch_port_helpers.train_cfg)."""
    cfg.DATA.CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TRAIN_JITTER_SCALES = [36, 45]
    cfg.DIST_BACKEND = "gloo"
    cfg.TPU.DATA_AXIS = 1
    return cfg


def thirty_view_cfg(get_cfg_fn, path, out_dir):
    """The 30-view test's config: ``tune(small_cfg(depth=18))`` on the
    synthetic split's 8 videos, 2 x 3 views in global batches of 10 (the
    last padded), the checkpoint at ``path``."""
    from torch_port_helpers import small_cfg

    cfg = tune(small_cfg(get_cfg_fn, depth=18))
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.TEST.DATASET = "synthetic"
    cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = VIEWS, CROPS
    cfg.TEST.BATCH_SIZE = TEST_BATCH
    cfg.TEST.CHECKPOINT_FILE_PATH = str(path)
    cfg.TEST.CHECKPOINT_TYPE = "pytorch"
    cfg.DATA_LOADER.NUM_WORKERS = 1
    return cfg


def rows(rank, world, n):
    b = n // world
    return slice(rank * b, (rank + 1) * b)


# -- what a rank runs, and what the one-process references run ----------------
def train_run(cfg, sd, batches, sl):
    """Steps of ``make_train_step`` on rows ``sl`` of each global batch
    from state dict ``sd``: (losses, top-1 errors, the state dict)."""
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    state = create_train_state(cfg, model, device="cpu")
    step = make_train_step(cfg, state.model, state.optimizer)
    losses, tops = [], []
    for x, y in batches:
        mets = step(state, [torch.from_numpy(a[sl]) for a in x],
                    torch.from_numpy(y[sl]), LR, None)
        losses.append(float(mets["loss"]))
        tops.append(float(mets["top1_err"]))
    return losses, tops, {k: v.clone() for k, v in
                          state.model.state_dict().items()}, state


class _Batches:
    """A loader of given batches (``prefetch_to_device`` on the CPU reads
    ``batches()``)."""

    def __init__(self, batches):
        self._b = batches

    def batches(self):
        yield from self._b


def precise_run(cfg, sd, canvases, sl):
    """Precise BN over two global batches of uint8 canvases, rows ``sl``,
    through the train preprocess and its draws: the BN statistics."""
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    state = create_train_state(cfg, model, device="cpu")
    loader = _Batches([{"frames": f[sl], "width": w[sl]} for f, w in canvases])
    calculate_and_update_precise_bn(cfg, state, loader,
                                    make_train_preprocess(cfg), 2)
    return {k: v.clone() for k, v in state.model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def draws(cfg, canvases, sl):
    """The train preprocess of the first canvases and a dropout mask, each
    drawn for rows ``sl``."""
    f, w = canvases[0]
    gen = step_generator(cfg.RNG_SEED, 5, "cpu")
    pre = make_train_preprocess(cfg)(gen, torch.from_numpy(f[sl]),
                                     torch.from_numpy(w[sl]))
    mask = dropout(torch.ones(f.shape[0], 6)[sl], 0.5,
                   torch.Generator().manual_seed(3))
    return [p.clone() for p in pre], mask


def bn_run(data, sl_sync, sl_sub):
    """The grouped BN modules on rows of the global inputs: (output, input
    gradient, affine gradients, running statistics) of sync-BN (2
    groups) and sub-BN (3 splits of a batch of 6)."""
    out = {}
    for name, mod, sl in (
            ("sync", SyncBatchNorm3d(3, num_groups=2), sl_sync),
            ("sub", SubBatchNorm3d(3, num_splits=3), sl_sub)):
        x, g = data[name]
        mod.load_state_dict(data[name + "_state"])
        mod.train()
        xl = torch.from_numpy(x[sl]).requires_grad_()
        y = mod(xl)
        (y * torch.from_numpy(g[sl])).sum().backward()
        grads = torch.stack([mod.weight.grad, mod.bias.grad])
        distributed.all_reduce_sum(grads)
        out[name] = (y.detach().numpy(), xl.grad.numpy(), grads.numpy(),
                     {k: v.clone().numpy() for k, v in
                      mod.state_dict().items()})
    return out


def rank_main(rank, world, port, d):
    """One rank of the module fixture's job: every check's rank side, its
    results saved to ``d/rank{rank}.pt``."""
    torch.set_num_threads(1)
    distributed.TIMEOUT_S = 120
    data = torch.load(os.path.join(d, "data.pt"), weights_only=False)
    cfg = data["cfg"].clone()
    cfg.NUM_SHARDS, cfg.SHARD_ID = world, rank
    distributed.init_distributed(cfg, 0, "cpu", f"tcp://127.0.0.1:{port}")
    out = {"rank": distributed.rank(), "world": distributed.world_size()}
    out["bn"] = bn_run(data["bn"], rows(rank, world, 4), rows(rank, world, 6))
    sl = rows(rank, world, BATCH)
    losses, tops, sd, state = train_run(cfg, data["sd"], data["batches"], sl)
    out["train"] = (losses, tops, sd, distributed.state_checksum(state.model))
    remat = cfg.clone()
    remat.TPU.REMAT = True
    out["remat"] = train_run(remat, data["sd"], data["batches"], sl)[2]
    accum = cfg.clone()
    accum.TPU.GRAD_ACCUM_STEPS = 2
    out["accum"] = train_run(accum, data["sd"], data["batches"], sl)[:3]
    out["precise"] = precise_run(cfg, data["sd"], data["canvases"], sl)
    out["draws"] = draws(cfg, data["canvases"], sl)
    # the master-only checkpoint, read by every rank after the barrier
    if rank == 0:
        time.sleep(0.5)
    written = cu.save_checkpoint(d, state, 0, cfg)
    distributed.host_barrier("train_complete")
    ckpt = torch.load(cu.get_last_checkpoint(d), weights_only=False)
    out["ckpt"] = (written, sorted(os.listdir(os.path.join(d, "checkpoints"))),
                   all(torch.equal(v, sd[k])
                       for k, v in ckpt["model_state"].items()))
    out["gather"] = distributed.all_gather_unaligned(
        np.arange(rank * 10, rank * 10 + 3 + 2 * rank),
        np.full((3 + 2 * rank, 2), rank > 0))
    out["test"] = run_test(data["test_cfg"], device="cpu")
    out["detection"] = run_test(data["det_cfg"], device="cpu").full_map
    # a rank with other weights: the checksum refuses DDP on every rank
    torch.manual_seed(rank)
    try:
        create_train_state(cfg, build_model(cfg, device="cpu"), "cpu")
        out["checksum"] = "built"
    except RuntimeError as e:
        out["checksum"] = str(e)
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    distributed.destroy_distributed()


# -- the children ----------------------------------------------------------------
def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(args, log):
    """A child process in a session of its own (its spawned ranks die with
    it at the deadline)."""
    return subprocess.Popen(
        [sys.executable] + args, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})


def finish(procs, logs, t0):
    """Wait for ``procs`` until the deadline; kill every one left and fail
    with the logs' tails where any failed."""
    errors = []
    for p, log in zip(procs, logs):
        left = max(1.0, DEADLINE_S - (time.time() - t0))
        try:
            rc = p.wait(timeout=left)
        except subprocess.TimeoutExpired:
            rc = "killed at the deadline"
        if p.poll() is None or rc != 0:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
            with open(log) as f:
                errors.append(f"{log}: {rc}\n{f.read()[-3000:]}")
    if errors:
        pytest.fail("\n".join(errors))


def cli_args(out_dir, *flags, opts=()):
    code = ("import sys; from efficient_slowfast_tpu_torch.parallel import "
            "distributed as d; d.TIMEOUT_S = 120; from "
            "efficient_slowfast_tpu_torch.tools.run_net import main; "
            "main(sys.argv[1:])")
    return ["-c", code, "--device", "cpu", *flags, "--cfg", TINY,
            "DIST_BACKEND", "gloo", "OUTPUT_DIR", str(out_dir),
            "TRAIN.BATCH_SIZE", "16", "TEST.NUM_ENSEMBLE_VIEWS", "2",
            "TEST.BATCH_SIZE", "12", "DATA_LOADER.NUM_WORKERS", "1",
            "LOG_MODEL_INFO", "False", *opts]


def bn_data():
    rs = np.random.RandomState(7)
    data = {}
    for name, n, mod in (("sync", 4, SyncBatchNorm3d(3, num_groups=2)),
                         ("sub", 6, SubBatchNorm3d(3, num_splits=3))):
        x = (rs.randn(n, 3, 2, 4, 4) * 2 + 1).astype(np.float32)
        data[name] = (x, rs.randn(*x.shape).astype(np.float32))
        with torch.no_grad():
            for v in mod.state_dict().values():
                if v.dtype == torch.float32:
                    v.copy_(torch.from_numpy(
                        rs.rand(*v.shape).astype(np.float32) + 0.5))
        data[name + "_state"] = mod.state_dict()
    return data


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Start the ranks and the CLI runs, compute the one-process
    references meanwhile, then collect."""
    from efficient_slowfast_tpu.utils.torch_ckpt import \
        export_torch_state_dict
    from efficient_slowfast_tpu_torch.utils.weights import \
        jax_variables_to_state_dict
    from test_ava import detection_engine_cfg, make_ava_fixture
    from test_torch_port_detection import to_port
    from torch_port_helpers import (inputs_np, seeded_variables,
                                    train_batches, train_cfg)

    d = tmp_path_factory.mktemp("ranks")
    cfg = tune(train_cfg(depth=18))
    variables = seeded_variables(cfg)
    sd = jax_variables_to_state_dict(variables)
    batches = [(inputs_np(cfg, BATCH, 20 + i), y) for i, (_, y) in
               enumerate(train_batches(cfg, steps=2, batch=BATCH))]
    rs = np.random.RandomState(5)
    canvases = [(rs.randint(0, 256, (BATCH, 8, 36, 48, 3)).astype(np.uint8),
                 rs.randint(40, 49, BATCH).astype(np.int32))
                for _ in range(2)]
    path = d / "model.pyth"
    test_cfg = thirty_view_cfg(get_cfg, path, d / "test")
    test_variables = seeded_variables(test_cfg)
    torch.save({"model_state": {
        k: torch.from_numpy(np.array(v)) for k, v in export_torch_state_dict(
            test_variables["params"],
            test_variables["batch_stats"]).items()}}, path)
    det_cfg = to_port(detection_engine_cfg(make_ava_fixture(d / "ava"),
                                           d / "det"))
    det_cfg.TRAIN.ENABLE = False
    det_cfg.DIST_BACKEND = "gloo"
    data = dict(cfg=cfg, sd=sd, batches=batches, canvases=canvases,
                bn=bn_data(), test_cfg=test_cfg, det_cfg=det_cfg)
    torch.save(data, d / "data.pt")

    t0 = time.time()
    port = free_port()
    procs, logs = [], []
    for r in range(WORLD):
        logs.append(str(d / f"rank{r}.log"))
        procs.append(start([__file__, str(r), str(WORLD), str(port), str(d)],
                           open(logs[-1], "w")))
    cli = {"shards": d / "shards", "spawn": d / "spawn"}
    port = free_port()
    for r in range(WORLD):
        logs.append(str(d / f"shard{r}.log"))
        procs.append(start(cli_args(
            cli["shards"], "--num_shards", str(WORLD), "--shard_id", str(r),
            "--init_method", f"tcp://127.0.0.1:{port}"), open(logs[-1], "w")))
    logs.append(str(d / "spawn.log"))
    procs.append(start(cli_args(
        cli["spawn"], "--init_method", f"tcp://127.0.0.1:{free_port()}",
        opts=("NUM_GPUS", str(WORLD))), open(logs[-1], "w")))

    ref = dict(data=data, cfg=cfg, variables=variables, cli=cli)
    ref["train"] = train_run(cfg, sd, batches, slice(None))[:3]
    ref["jax_train"] = _jax_train(variables, batches)
    ref["test"] = _jax_test(test_variables, path, d / "jax_test")
    ref["port_test"] = run_test(test_cfg, device="cpu")
    ref["detection"] = run_test(det_cfg, device="cpu").full_map
    ref["precise"] = precise_run(cfg, sd, canvases, slice(None))
    ref["draws"] = draws(cfg, canvases, slice(None))
    finish(procs, logs, t0)
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ref, ranks


def _jax_train(variables, batches):
    """JAX's train step (one compile) over ``batches`` from
    ``variables``: (losses, the numpy variables after the last step)."""
    import jax
    import jax.numpy as jnp

    from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
    from efficient_slowfast_tpu.engine.state import (TrainState,
                                                     make_train_step)
    from efficient_slowfast_tpu.models import build_model as jax_build_model
    from efficient_slowfast_tpu.models.optimizer import construct_optimizer
    from torch_port_helpers import train_cfg

    jcfg = tune(train_cfg(jax_get_cfg, depth=18))
    model = jax_build_model(jcfg)
    tx, _ = construct_optimizer(jcfg, variables["params"])
    step = make_train_step(jcfg, model, tx)
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=tree(variables["params"]),
                       batch_stats=tree(variables["batch_stats"]),
                       opt_state=tx.init(variables["params"]))
    losses = []
    for x, y in batches:
        state, mets = step(state, [jnp.asarray(a) for a in x],
                           jnp.asarray(y), LR, jax.random.PRNGKey(0))
        losses.append(float(mets["loss"]))
    return losses, jax.tree_util.tree_map(
        lambda a: np.array(a, copy=True),
        {"params": state.params, "batch_stats": state.batch_stats})


def _jax_test(variables, path, out_dir):
    """JAX's one-process 30-view test of the same checkpoint and split
    (``variables`` give the shapes): its TestMeter."""
    import importlib

    import jax
    import jax.numpy as jnp

    from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
    from efficient_slowfast_tpu.data.loader import construct_loader
    from efficient_slowfast_tpu.engine.state import TrainState
    from efficient_slowfast_tpu.models import build_model as jax_build_model
    from efficient_slowfast_tpu.ops.options import configure
    from efficient_slowfast_tpu.parallel.mesh import build_mesh
    from efficient_slowfast_tpu.utils import checkpoint as jax_checkpoint
    from efficient_slowfast_tpu.utils.meters import TestMeter

    jax_test = importlib.import_module("efficient_slowfast_tpu.engine.test")
    cfg = thirty_view_cfg(jax_get_cfg, path, out_dir)
    try:
        model = jax_build_model(cfg)
        zeros = jax.tree_util.tree_map(np.zeros_like, variables)
        state = TrainState(step=jnp.zeros((), jnp.int32),
                           params=zeros["params"],
                           batch_stats=zeros["batch_stats"], opt_state=None)
        state = jax_checkpoint.load_test_checkpoint(cfg, state)
        loader = construct_loader(cfg, "test")
        meter = TestMeter(VIDEOS, VIEWS * CROPS, cfg.MODEL.NUM_CLASSES,
                          len(loader))
        jax_test.perform_test(cfg, state, model, loader, meter,
                              build_mesh(cfg))
    finally:
        configure(jax_get_cfg())
    return meter


# -- the checks ------------------------------------------------------------------
def test_the_ranks_form_one_job(job):
    _, ranks = job
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]


def test_two_rank_train_steps_match_one_process_and_jax(job):
    """(a) Losses, parameters and BN statistics: bit-equal across the
    ranks, within 1e-4 of the port's one process and of JAX's step on the
    same global batch; remat and gradient accumulation under DDP."""
    from efficient_slowfast_tpu_torch.utils.weights import \
        state_dict_to_jax_variables
    from torch_port_helpers import flat_leaves

    ref, ranks = job
    (l0, t0, sd0, crc0), (l1, t1, sd1, crc1) = (r["train"] for r in ranks)
    assert l0 == l1 and t0 == t1 and crc0 == crc1
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    losses, tops, sd = ref["train"]
    np.testing.assert_allclose(l0, losses, **TOL)
    assert t0 == tops
    for k in sd:
        np.testing.assert_allclose(sd0[k].numpy(), sd[k].numpy(),
                                   err_msg=k, **TOL)
    jax_losses, jax_vars = ref["jax_train"]
    np.testing.assert_allclose(l0, jax_losses, **TOL)
    assert jax_losses[1] != jax_losses[0]
    ours = flat_leaves(state_dict_to_jax_variables(sd0))
    theirs = flat_leaves(jax_vars)
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **TOL)
    # remat recomputes each stage's BN, its all-reduce included, and
    # drops the recompute's statistics: the same step
    for r in ranks:
        for k, v in r["remat"].items():
            np.testing.assert_allclose(v.numpy(), sd0[k].numpy(),
                                       err_msg=k, rtol=1e-5, atol=1e-5)


def test_gradient_accumulation_under_ddp_is_the_ranks_microbatches(job):
    """Microbatch i is every rank's i-th part (``no_sync`` but the last):
    one process on the global batch in that order steps the same."""
    ref, ranks = job
    cfg = ref["cfg"].clone()
    cfg.TPU.GRAD_ACCUM_STEPS = 2
    order = np.array([0, 1, 4, 5, 2, 3, 6, 7])
    batches = [([a[order] for a in x], y[order])
               for x, y in ref["data"]["batches"]]
    losses, tops, sd, _ = train_run(cfg, ref["data"]["sd"], batches,
                                    slice(None))
    for r in ranks:
        got_losses, got_tops, got = r["accum"]
        np.testing.assert_allclose(got_losses, losses, **TOL)
        assert got_tops == tops
        for k in sd:
            np.testing.assert_allclose(got[k].numpy(), sd[k].numpy(),
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("name", ["sync", "sub"])
def test_grouped_bn_matches_jax_across_ranks(job, name):
    """(b) JAX's SyncBatchNorm3d (2 groups of a batch of 4) and
    SubBatchNorm3d (3 splits of a batch of 6: split 1 spans both ranks) on
    the global batch: outputs, input and affine gradients, running
    statistics at 1e-5."""
    import jax
    import jax.numpy as jnp

    from efficient_slowfast_tpu.ops import norm as jax_norm

    ref, ranks = job
    data = ref["data"]["bn"]
    x, g = data[name]
    st = {k: v.numpy() for k, v in data[name + "_state"].items()}
    to_nhwc = lambda a: np.moveaxis(a, 1, -1)  # noqa: E731
    if name == "sync":
        mod = jax_norm.SyncBatchNorm3d(num_groups=2)
        stats = {"mean": st["running_mean"], "var": st["running_var"]}
    else:
        mod = jax_norm.SubBatchNorm3d(num_splits=3)
        stats = {"mean": st["bn.running_mean"], "var": st["bn.running_var"],
                 "split_mean": st["split_bn.running_mean"].reshape(3, 3),
                 "split_var": st["split_bn.running_var"].reshape(3, 3)}
    params = {"bn": {"scale": st["weight"], "bias": st["bias"]}}

    def f(p, xx):
        return mod.apply({"params": p, "batch_stats": {"bn": stats}}, xx,
                         train=True, mutable=["batch_stats"])

    y, new = f(params, jnp.asarray(to_nhwc(x)))
    _, pull = jax.vjp(lambda p, xx: f(p, xx)[0], params,
                      jnp.asarray(to_nhwc(x)))
    gp, gx = pull(jnp.asarray(to_nhwc(g)))
    new = new["batch_stats"]["bn"]
    n = x.shape[0] // WORLD
    for r, rank in enumerate(ranks):
        out, xgrad, affine, state = rank["bn"][name]
        sl = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(out, np.moveaxis(np.asarray(y), -1, 1)[sl],
                                   **BN_TOL)
        np.testing.assert_allclose(
            xgrad, np.moveaxis(np.asarray(gx), -1, 1)[sl], **BN_TOL)
        np.testing.assert_allclose(affine[0], gp["bn"]["scale"], **BN_TOL)
        np.testing.assert_allclose(affine[1], gp["bn"]["bias"], **BN_TOL)
        if name == "sync":
            pairs = [("running_mean", "mean"), ("running_var", "var")]
        else:
            pairs = [("split_bn.running_mean", "split_mean"),
                     ("split_bn.running_var", "split_var")]
        for ours, theirs in pairs:
            np.testing.assert_allclose(state[ours].reshape(-1),
                                       np.asarray(new[theirs]).reshape(-1),
                                       err_msg=ours, **BN_TOL)


def test_unaligned_gather_and_thirty_view_test_match_jax(job):
    """(c) Rows of unequal counts come back in rank order; a two-rank
    30-view test() of a split whose last batch is padded gives JAX's
    one-process per-video scores and top-k, every view counted once."""
    ref, ranks = job
    for r in ranks:
        ids, flags = r["gather"]
        np.testing.assert_array_equal(ids, [0, 1, 2, 10, 11, 12, 13, 14])
        assert flags.dtype == np.bool_
        np.testing.assert_array_equal(flags[:, 0], [False] * 3 + [True] * 5)
    theirs = ref["test"]
    for r in ranks:
        ours = r["test"]
        np.testing.assert_array_equal(ours.clip_count, VIEWS * CROPS)
        np.testing.assert_array_equal(ours.video_labels, theirs.video_labels)
        np.testing.assert_allclose(ours.video_preds, theirs.video_preds,
                                   **TOL)
        assert ours.stats == theirs.stats
        np.testing.assert_array_equal(ours.video_preds,
                                      ref["port_test"].video_preds)


def test_two_rank_detection_map_is_one_process(job):
    """(d) Each rank scores one keyframe (and a wrapped duplicate it
    drops); the gathered boxes give the one-process mAP on both."""
    ref, ranks = job
    assert 0.0 <= ref["detection"] <= 1.0
    for r in ranks:
        assert r["detection"] == pytest.approx(ref["detection"], abs=1e-6)


def test_master_checkpoint_barrier_and_checksum(job):
    """(e) Only the master writes; after ``train_complete`` every rank
    reads its checkpoint, bit-equal to its own state; ranks built with
    other weights fail on the checksum, on every rank, and return."""
    _, ranks = job
    (w0, files0, same0), (w1, files1, same1) = (r["ckpt"] for r in ranks)
    assert w0.endswith("checkpoint_epoch_00001.pyth") and w1 is None
    assert files0 == files1 == ["checkpoint_epoch_00001.pyth"]
    assert same0 and same1
    for r in ranks:
        assert "checksum differs across ranks" in r["checksum"], r["checksum"]


def test_precise_bn_and_draws_are_the_global_batch(job):
    """(f) Precise BN at two ranks gives the one-process statistics of the
    same global batches, their crops, flips and jitter drawn for the
    global batch; so does the head's dropout mask."""
    ref, ranks = job
    for r in ranks:
        for k, v in ref["precise"].items():
            np.testing.assert_allclose(r["precise"][k].numpy(), v.numpy(),
                                       err_msg=k, **BN_TOL)
    pre, mask = ref["draws"]
    for i, r in enumerate(ranks):
        sl = rows(i, WORLD, BATCH)
        got_pre, got_mask = r["draws"]
        for a, b in zip(got_pre, pre):
            torch.testing.assert_close(a, b[sl], rtol=0, atol=0)
        torch.testing.assert_close(got_mask, mask[sl], rtol=0, atol=0)


def _json_stats(out_dir, kind):
    import json

    with open(os.path.join(out_dir, "stdout.log")) as f:
        lines = [json.loads(line.split("json_stats: ", 1)[1]) for line in f
                 if "json_stats: " in line]
    return [s for s in lines if s["_type"] == kind]


def test_cli_launch_by_flags_and_by_spawn(job):
    """(g) ``tools/run_net.py::main`` as two processes
    (``--num_shards 2 --shard_id i --init_method``) and as one that spawns
    two (``NUM_GPUS 2``): one job each, train then test; the same global
    batches, so the same checkpoint bit for bit and the same test."""
    ref, _ = job
    out = {}
    for name, d in ref["cli"].items():
        ckpts = sorted(os.listdir(d / "checkpoints"))
        assert ckpts == ["checkpoint_epoch_00001.pyth"], (name, ckpts)
        out[name] = (torch.load(d / "checkpoints" / ckpts[0],
                                weights_only=False)["model_state"],
                     _json_stats(d, "test_final"),
                     _json_stats(d, "train_epoch"))
    (a, test_a, train_a), (b, test_b, train_b) = out["shards"], out["spawn"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert len(test_a) == 1 and test_a == test_b
    assert len(train_a) == 1
    assert {k: v for k, v in train_a[0].items() if "time" not in k
            and "mem" not in k and "eta" not in k} == \
        {k: v for k, v in train_b[0].items() if "time" not in k
         and "mem" not in k and "eta" not in k}


def test_nccl_on_the_cpu_raises():
    cfg = get_cfg()
    cfg.NUM_SHARDS = 2
    with pytest.raises(ValueError, match="DIST_BACKEND nccl needs a CUDA"):
        distributed.init_distributed(cfg, 0, "cpu")
    assert not distributed.initialized()


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
