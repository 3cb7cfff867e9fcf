"""``TPU.SPATIAL_SHARD`` and ``TPU.DATA_AXIS`` in the port: each frame's
height split over the S ranks of a space group (``parallel/spatial.py``),
held against the port's one process and against the JAX package on the
suite's 8 virtual devices with the same ``SPATIAL_SHARD`` and ``DATA_AXIS``
set to the port's D (``tests/test_spatial_shard.py``'s checks), f32 on
the CPU at 1e-4.

Ranks are CPU processes over gloo started by this file run as a script
(``python <this file> <job> rank world port dir``: ``rank_main``), each
with a deadline, as ``tests/test_torch_port_distributed.py`` starts its
own; they run while this process computes the port's one-process
references and two more children JAX's (``jax_main``). Two jobs: ``s2``
(D = 1, S = 2) and ``d2s2`` (D = 2, S = 2, four ranks).

Held (SlowFast with R18-deep bottlenecks at width 16, 8 frames, a 32²
crop, unless said):
- (i) the eval forward at S = 2 against JAX's and the one process's, with
  each rank holding only its band of every stage's rows but s5's (at a
  32² crop s5's stride-2 rows do not split: its fallback);
- (ii) one train step at S = 2 (loss, a conv leaf, the head's leaf, a BN
  statistic, every leaf) against the one process's and JAX's step on its
  ``DATA_AXIS 2 x SPATIAL_SHARD 2`` mesh (plain BN: JAX's layout does not
  change the step, ``tests/test_spatial_shard.py:152``);
- (iii) the fallback at a 34² crop (17-row bands: the stem's stride-2
  rows do not split): the step against the one process's, the forward
  against JAX's;
- (iv) the detection forward against JAX's and the one process's;
- (v) CMDA (K2's plain version on each rank's queries against the space
  group's keys), its forward and one step against JAX's at S = 2;
- (vi) D = 2, S = 2 over four ranks: the step against JAX's mesh, a
  split-BN step against the one process's with NUM_SPLITS x D splits,
  and the split- and sync-BN group counts against JAX's
  ``effective_num_splits``/``effective_sync_groups`` at (1, 2) and (2, 2);
- the eval forwards of ShuffleNetV2, GhostNet and I3D-NLN-R50 against the
  one process's (their train steps are chaotic at random init: a change
  of BN's float32 arithmetic alone moves a MobileNetV2 gradient by more
  than its size, so none is held here).
Also: the job's shape and its refusals, and a forward outside a job of
space groups, which raises."""

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
from efficient_slowfast_tpu_torch.engine.state import (  # noqa: E402
    create_train_state, make_detection_forward, make_forward,
    make_train_step)
from efficient_slowfast_tpu_torch.models import build_model  # noqa: E402
from efficient_slowfast_tpu_torch.ops.norm import (  # noqa: E402
    effective_num_splits, effective_sync_groups)
from efficient_slowfast_tpu_torch.parallel import (  # noqa: E402
    distributed, spatial)

DEADLINE_S = 240
BATCH, LR, BOXES = 8, 0.01, 3
TOL = dict(rtol=1e-4, atol=1e-4)
JOBS = {"s2": 2, "d2s2": 4}
STAGES = ("s1", "s2", "s3", "s4", "s5")
# JAX's references, each part in a child of its own (``jax_main``)
JAX_PARTS = ("jax_forwards", "jax_step", "jax_cmda_forward", "jax_cmda_step")
# the other families' eval forwards at S = 2, against the one process's:
# ShuffleNetV2 (channel shuffles, the efficient head's pool), GhostNet (SE
# means, 5x5 stride-2 depthwise convs) and I3D-NLN-R50 (softmax non-local
# blocks on pooled keys)
FAMILIES = ("shufflenetv2", "ghostnet", "i3d_nln")


def model_cfg(get, model="SlowFast", crop=32, s=1, d=0, norm="batchnorm",
              splits=1, detection=False):
    """``small_cfg(depth=18)`` at ``crop``, no dropout, the final BN's γ
    zero (the train tests' recipe), ``TPU.SPATIAL_SHARD`` ``s`` and
    ``TPU.DATA_AXIS`` ``d``; CMDA's fusions above 16 tokens take the
    streaming path."""
    from torch_port_helpers import small_cfg

    cfg = small_cfg(get, depth=18, model=model, flash_min_tokens=16)
    cfg.DATA.CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = crop
    cfg.DATA.TRAIN_CROP_SIZE = crop
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.RESNET.ZERO_INIT_FINAL_BN = True
    cfg.TPU.SPATIAL_SHARD, cfg.TPU.DATA_AXIS = s, d
    cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS = norm, splits
    cfg.DIST_BACKEND = "gloo"
    if detection:
        cfg.DETECTION.ENABLE = True
        cfg.MODEL.NUM_CLASSES = 8
        cfg.MODEL.HEAD_ACT = "sigmoid"
    if hasattr(cfg.TPU, "DONATE"):
        cfg.TPU.DONATE = False
    return cfg


def family_cfg(name, s=1):
    from torch_port_helpers import NLN_R50, efficient_cfg, small_cfg

    if name == "i3d_nln":
        cfg = small_cfg(get_cfg, model="ResNet", nonlocal_loc=NLN_R50,
                        flash_min_tokens=16)
        cfg.DATA.CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    else:
        cfg = efficient_cfg(name)
    cfg.TPU.SPATIAL_SHARD, cfg.DIST_BACKEND = s, "gloo"
    return cfg


def inputs(cfg, batch, seed):
    from torch_port_helpers import inputs_np

    return inputs_np(cfg, batch, seed)


def boxes_np(crop):
    return np.tile(np.asarray([1.0, 2.0, crop - 3.0, crop - 1.0], np.float32),
                   (4, BOXES, 1))


# -- what a rank runs, and what the one-process references run ----------------
def model_of(cfg, sd):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


def forward_run(cfg, sd, x, record=False):
    """The eval forward's scores (and, with ``record``, each stage's
    output as (is it a band, its rows))."""
    model = model_of(cfg, sd)
    seen = {}
    if record:
        for name in STAGES:
            getattr(model, name).register_forward_hook(
                lambda m, a, out, name=name: seen.__setitem__(
                    name, [(spatial.is_split(o), o.shape[3]) for o in out]))
    out = make_forward(cfg, model, "cpu")([torch.from_numpy(a) for a in x])
    return out.numpy(), seen


def step_run(cfg, sd, x, y, rows):
    """One train step on rows ``rows`` of the global batch: (loss, the
    state dict after it)."""
    model = model_of(cfg, sd)
    state = create_train_state(cfg, model, device="cpu")
    step = make_train_step(cfg, state.model, state.optimizer)
    mets = step(state, [torch.from_numpy(a[rows]) for a in x],
                torch.from_numpy(y[rows]), LR, torch.Generator())
    return float(mets["loss"]), {k: v.clone() for k, v in
                                 state.model.state_dict().items()}


def detection_run(cfg, sd, x):
    model = model_of(cfg, sd)
    fwd = make_detection_forward(cfg, model, "cpu")
    return fwd([torch.from_numpy(a) for a in x],
               torch.from_numpy(boxes_np(cfg.DATA.CROP_SIZE))).numpy()


def bn_counts(world_cfg):
    """(split count, sync groups) for BN.NUM_SPLITS 2, NUM_SYNC_DEVICES 1."""
    c = world_cfg.clone()
    c.BN.NUM_SPLITS, c.BN.NUM_SYNC_DEVICES = 2, 1
    return effective_num_splits(c), effective_sync_groups(c)


def rank_main(job, rank, world, port, d):
    """One rank of ``job``: its checks' rank sides, saved to
    ``d/{job}{rank}.pt``."""
    torch.set_num_threads(1)
    distributed.TIMEOUT_S = 120
    data = torch.load(os.path.join(d, "data.pt"), weights_only=False)
    s = 2
    dd = world // s
    cfg = model_cfg(get_cfg, s=s, d=dd)
    cfg.NUM_SHARDS, cfg.SHARD_ID = world, rank
    distributed.init_distributed(cfg, 0, "cpu", f"tcp://127.0.0.1:{port}")
    out = {"mesh": (distributed.data_rank(), distributed.data_size(),
                    distributed.space_rank(), distributed.space_size()),
           "bn": bn_counts(cfg)}
    i, b = distributed.data_rank(), BATCH // dd
    rows = slice(i * b, (i + 1) * b)
    x, y = data["x"], data["y"]
    out["step"] = step_run(cfg, data["sd"], x, y, rows)
    if job == "s2":
        out["forward"] = forward_run(cfg, data["sd"], data["xf"], True)
        odd = model_cfg(get_cfg, crop=34, s=s, d=dd)
        out["odd_forward"] = forward_run(odd, data["sd"], data["x34"])[0]
        out["odd_step"] = step_run(odd, data["sd"], data["x34"], y, rows)
        det = model_cfg(get_cfg, s=s, d=dd, detection=True)
        out["detection"] = detection_run(det, data["det_sd"], data["xf"])
        cmda = model_cfg(get_cfg, "SlowFastDualAttention", s=s, d=dd)
        out["cmda_forward"] = forward_run(cmda, data["cmda_sd"],
                                          data["xf"])[0]
        out["cmda_step"] = step_run(cmda, data["cmda_sd"], x, y, rows)
        out["families"] = {
            name: forward_run(family_cfg(name, s), data["families"][name][0],
                              data["families"][name][1])[0]
            for name in FAMILIES}
    else:
        sub = model_cfg(get_cfg, s=s, d=dd, norm="sub_batchnorm")
        out["sub_step"] = step_run(sub, data["sub_sd"], x, y, rows)
    torch.save(out, os.path.join(d, f"{job}{rank}.pt"))
    distributed.destroy_distributed()


# -- the children ----------------------------------------------------------------
def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start(args, log):
    return subprocess.Popen(
        [sys.executable] + args, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})


def finish(procs, logs, t0):
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


def _variables(cfg):
    from torch_port_helpers import seeded_variables

    return seeded_variables(cfg)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Start both jobs' ranks, compute the references meanwhile, then
    collect."""
    from efficient_slowfast_tpu_torch.utils.weights import \
        jax_variables_to_state_dict

    d = tmp_path_factory.mktemp("space")
    one = model_cfg(get_cfg)
    variables = _variables(one)
    cmda_vars = _variables(model_cfg(get_cfg, "SlowFastDualAttention"))
    det_vars = _variables(model_cfg(get_cfg, detection=True))
    sub = model_cfg(get_cfg, norm="sub_batchnorm", splits=2)
    sub_sd = jax_variables_to_state_dict(_variables(sub))
    families = {}
    for i, name in enumerate(FAMILIES):
        cfg = family_cfg(name)
        torch.manual_seed(i)
        families[name] = (build_model(cfg, device="cpu").state_dict(),
                          inputs(cfg, 2, 30 + i))
    data = dict(
        sd=jax_variables_to_state_dict(variables),
        cmda_sd=jax_variables_to_state_dict(cmda_vars),
        det_sd=jax_variables_to_state_dict(det_vars), sub_sd=sub_sd,
        x=inputs(one, BATCH, 20), xf=inputs(one, 4, 21),
        x34=inputs(model_cfg(get_cfg, crop=34), BATCH, 22),
        y=(np.arange(BATCH) * 5 % 12).astype(np.int64), families=families)
    torch.save(data, d / "data.pt")
    torch.save(dict(variables=variables, cmda=cmda_vars, det=det_vars),
               d / "variables.pt")

    t0 = time.time()
    procs, logs = [], []
    for part in JAX_PARTS:
        logs.append(str(d / f"{part}.log"))
        procs.append(start([__file__, part, str(d)], open(logs[-1], "w")))
    for name, world in JOBS.items():
        port = free_port()
        for r in range(world):
            logs.append(str(d / f"{name}{r}.log"))
            procs.append(start([__file__, name, str(r), str(world), str(port),
                                str(d)], open(logs[-1], "w")))

    full = slice(None)
    ref = dict(data=data)
    ref["forward"] = forward_run(one, data["sd"], data["xf"])[0]
    ref["step"] = step_run(one, data["sd"], data["x"], data["y"], full)
    odd = model_cfg(get_cfg, crop=34)
    ref["odd_step"] = step_run(odd, data["sd"], data["x34"], data["y"], full)
    ref["detection"] = detection_run(model_cfg(get_cfg, detection=True),
                                     data["det_sd"], data["xf"])
    ref["sub_step"] = step_run(sub, sub_sd, data["x"], data["y"], full)
    ref["families"] = {name: forward_run(family_cfg(name), *families[name])[0]
                       for name in FAMILIES}
    finish(procs, logs, t0)
    ref["jax"] = {}
    for part in JAX_PARTS:
        ref["jax"].update(torch.load(d / f"{part}.pt", weights_only=False))
    ranks = {name: [torch.load(d / f"{name}{r}.pt", weights_only=False)
                    for r in range(world)] for name, world in JOBS.items()}
    return ref, ranks


def jax_main(part, d):
    """One part of JAX's references (JAX_PARTS), in a child with the
    suite's 8 virtual CPU devices: the SlowFast, odd-crop and detection
    forwards at S = 2 (``DATA_AXIS 1``) with the BN counts; the SlowFast
    step on the ``DATA_AXIS 2 x SPATIAL_SHARD 2`` mesh; CMDA's forward;
    CMDA's step at S = 2. Saved to ``d/{part}.pt``."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               "force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.environ["JAX_COMPILATION_CACHE_DIR"])
    torch.set_num_threads(1)
    data = torch.load(os.path.join(d, "data.pt"), weights_only=False)
    v = torch.load(os.path.join(d, "variables.pt"), weights_only=False)
    out = _jax_references(part, v["variables"], v["cmda"], v["det"], data)
    torch.save(out, os.path.join(d, f"{part}.pt"))


def _jax_references(part, variables, cmda_vars, det_vars, data):
    import jax
    import jax.numpy as jnp

    from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
    from efficient_slowfast_tpu.engine.state import (
        TrainState, make_detection_forward as jax_detection_forward,
        make_forward as jax_forward, make_train_step as jax_train_step,
        shard_state)
    from efficient_slowfast_tpu.models import build_model as jax_build_model
    from efficient_slowfast_tpu.models.optimizer import construct_optimizer
    from efficient_slowfast_tpu.ops import norm as jax_norm
    from efficient_slowfast_tpu.ops.options import configure
    from efficient_slowfast_tpu.parallel.mesh import build_mesh, shard_batch

    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    snap = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.array(a, copy=True), t)
    out = {}
    try:
        def forward(cfg, v, x, det=False):
            model, mesh = jax_build_model(cfg), build_mesh(cfg)
            xs = shard_batch(mesh, [jnp.asarray(a) for a in x], spatial=True)
            var = {"params": tree(v["params"]),
                   "batch_stats": tree(v["batch_stats"])}
            if det:
                b = shard_batch(mesh, jnp.asarray(boxes_np(
                    cfg.DATA.CROP_SIZE)))
                return np.asarray(jax_detection_forward(cfg, model)(
                    var, xs, b))
            return np.asarray(jax_forward(cfg, model)(var, xs))

        def step(cfg, v):
            model, mesh = jax_build_model(cfg), build_mesh(cfg)
            tx, _ = construct_optimizer(cfg, v["params"])
            state = shard_state(TrainState(
                step=jnp.zeros((), jnp.int32), params=tree(v["params"]),
                batch_stats=tree(v["batch_stats"]),
                opt_state=tx.init(v["params"])), mesh)
            xs = shard_batch(mesh, [jnp.asarray(a) for a in data["x"]],
                             spatial=True)
            ys = shard_batch(mesh, jnp.asarray(data["y"].astype(np.int32)))
            state, mets = jax_train_step(cfg, model, tx)(
                state, xs, ys, LR, jax.random.PRNGKey(0))
            return float(mets["loss"]), snap(
                {"params": state.params, "batch_stats": state.batch_stats})

        cmda = model_cfg(jax_get_cfg, "SlowFastDualAttention", s=2, d=1)
        if part == "jax_cmda_forward":
            out["cmda_forward"] = forward(cmda, cmda_vars, data["xf"])
            return out
        if part == "jax_cmda_step":
            out["cmda_step"] = step(cmda, cmda_vars)
            return out
        if part == "jax_step":
            out["step"] = step(model_cfg(jax_get_cfg, s=2, d=2), variables)
            return out
        out["forward"] = forward(model_cfg(jax_get_cfg, s=2, d=1), variables,
                                 data["xf"])
        out["odd_forward"] = forward(model_cfg(jax_get_cfg, crop=34, s=2,
                                               d=1), variables, data["x34"])
        out["detection"] = forward(model_cfg(jax_get_cfg, s=2, d=1,
                                             detection=True), det_vars,
                                   data["xf"], det=True)
        for dd in (1, 2):
            c = model_cfg(jax_get_cfg, s=2, d=dd)
            c.BN.NUM_SPLITS, c.BN.NUM_SYNC_DEVICES = 2, 1
            out[f"bn{dd}"] = (jax_norm.effective_num_splits(c),
                              jax_norm.effective_sync_groups(c))
    finally:
        configure(jax_get_cfg())
    return out


# -- the checks ------------------------------------------------------------------
def _port_vars(sd):
    from efficient_slowfast_tpu_torch.utils.weights import \
        state_dict_to_jax_variables
    from torch_port_helpers import flat_leaves

    return flat_leaves(state_dict_to_jax_variables(sd))


def _held_step(got, want_sd, jax_step=None):
    """A rank's (loss, state dict) against the one process's (and JAX's
    (loss, variables)): the loss, a conv leaf, the head's leaf, a BN
    statistic, then every leaf."""
    from torch_port_helpers import flat_leaves

    loss, sd = got
    np.testing.assert_allclose(loss, want_sd[0], **TOL)
    named = ("s1.pathway0_stem.conv.weight", "head.projection.weight",
             "s2.pathway1_res0.branch2.b_bn.running_mean",
             "s2.pathway1_res0.branch2.b_bn.split_bn.running_mean")
    assert sum(k in sd for k in named) == 3
    for k in [k for k in named if k in sd] + list(sd):
        np.testing.assert_allclose(sd[k].numpy(), want_sd[1][k].numpy(),
                                   err_msg=k, **TOL)
    if jax_step is not None:
        np.testing.assert_allclose(loss, jax_step[0], **TOL)
        ours, theirs = _port_vars(sd), flat_leaves(jax_step[1])
        assert set(ours) == set(theirs)
        for k in theirs:
            np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **TOL)


def test_ranks_form_the_data_by_space_mesh(job):
    _, ranks = job
    assert [r["mesh"] for r in ranks["s2"]] == [(0, 1, 0, 2), (0, 1, 1, 2)]
    assert [r["mesh"] for r in ranks["d2s2"]] == [
        (0, 2, 0, 2), (0, 2, 1, 2), (1, 2, 0, 2), (1, 2, 1, 2)]


def test_eval_forward_is_layout_invariant(job):
    """(i) Each rank holds only its band of s1-s4's rows (s5 at a 32²
    crop is its stage's fallback, whole on each rank); the scores equal
    the one process's and JAX's at S = 2."""
    ref, ranks = job
    for r in ranks["s2"]:
        scores, seen = r["forward"]
        np.testing.assert_allclose(scores, ref["forward"], **TOL)
        np.testing.assert_allclose(scores, ref["jax"]["forward"], **TOL)
        for name, rows in zip(STAGES, (8, 8, 4, 2, 1)):
            want = (name != "s5", rows // 2 if name != "s5" else rows)
            assert seen[name] == [want, want], (name, seen[name])


def test_train_step_is_layout_invariant(job):
    """(ii) One step at S = 2: the ranks bit-equal, each within 1e-4 of
    the one process's and of JAX's step on its DATA_AXIS 2 x
    SPATIAL_SHARD 2 mesh."""
    ref, ranks = job
    a, b = (r["step"] for r in ranks["s2"])
    assert a[0] == b[0] and all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    _held_step(a, ref["step"], ref["jax"]["step"])


def test_fallback_at_an_odd_crop(job):
    """(iii) 34² (17-row bands): the whole height from the stem on, the
    step equal to the one process's and the forward to JAX's."""
    ref, ranks = job
    for r in ranks["s2"]:
        _held_step(r["odd_step"], ref["odd_step"])
        np.testing.assert_allclose(r["odd_forward"],
                                   ref["jax"]["odd_forward"], **TOL)


def test_detection_forward_spatial_shard(job):
    """(iv) ROIAlign reads the whole height of s5's features."""
    ref, ranks = job
    for r in ranks["s2"]:
        np.testing.assert_allclose(r["detection"], ref["detection"], **TOL)
        np.testing.assert_allclose(r["detection"], ref["jax"]["detection"],
                                   **TOL)


def test_cmda_local_queries_match_jax(job):
    """(v) CMDA: each rank's queries against the space group's keys (K2's
    plain version here), the forward and one step against JAX's at S =
    2."""
    ref, ranks = job
    for r in ranks["s2"]:
        np.testing.assert_allclose(r["cmda_forward"],
                                   ref["jax"]["cmda_forward"], **TOL)
        loss, sd = r["cmda_step"]
        jloss, jvars = ref["jax"]["cmda_step"]
        np.testing.assert_allclose(loss, jloss, **TOL)
        from torch_port_helpers import flat_leaves

        ours, theirs = _port_vars(sd), flat_leaves(jvars)
        for k in theirs:
            np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_other_families_forward_is_layout_invariant(job, name):
    """The eval forward of each family at S = 2 against the one process's,
    at 1e-4 of the scores' scale (GhostNet's reach 2.5e4 at random
    init)."""
    ref, ranks = job
    want = ref["families"][name]
    for r in ranks["s2"]:
        np.testing.assert_allclose(r["families"][name], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_data_by_space_step_and_bn_groups(job):
    """(vi) D = 2, S = 2: the step against JAX's mesh and the one
    process's; split BN cuts the global batch into NUM_SPLITS x D groups
    (the one process's NUM_SPLITS 2 here), and the BN group counts are
    JAX's at (1, 2) and (2, 2) (the world-sized (4, 2) and (8, 4) before
    the repair)."""
    ref, ranks = job
    for r in ranks["d2s2"]:
        _held_step(r["step"], ref["step"], ref["jax"]["step"])
        _held_step(r["sub_step"], ref["sub_step"])
        assert r["bn"] == ref["jax"]["bn2"] == (4, 2)
    for r in ranks["s2"]:
        assert r["bn"] == ref["jax"]["bn1"] == (2, 1)


def test_mesh_shape_and_its_refusals():
    """D and S from the world (JAX's ``build_mesh``): a world S does not
    divide raises as JAX's mesh asserts; a one-machine job is cut to D x
    S; a job of several machines larger than its mesh raises, naming
    both."""
    cfg = model_cfg(get_cfg, s=2)
    assert distributed.mesh_shape(cfg, 8) == (4, 2)
    cfg.TPU.DATA_AXIS = 3
    assert distributed.mesh_shape(cfg, 8) == (3, 2)
    cfg.NUM_GPUS = 8
    assert distributed.job_size(cfg) == 6
    cfg.NUM_SHARDS = 2
    with pytest.raises(ValueError, match="6 processes.*has 16"):
        distributed.job_size(cfg)
    for world in (1, 3):
        with pytest.raises(AssertionError, match="SPATIAL_SHARD=2"):
            distributed.mesh_shape(cfg, world)


def test_a_forward_outside_a_job_of_space_groups_raises():
    """A model built under SPATIAL_SHARD splits every forward, so outside
    a job of S-rank space groups its forward raises: it never runs
    unsplit. (The entry points' split paths, int8 serving, the export,
    the demo and Grad-CAM, are held in
    tests/test_torch_port_spatial_entry.py.)"""
    cfg = model_cfg(get_cfg, s=2)
    model = build_model(cfg, device="cpu")
    x = [torch.from_numpy(a) for a in inputs(cfg, 2, 0)]
    with pytest.raises(RuntimeError, match="space groups"):
        model.eval()(x)


def test_a_split_activation_refuses_unserved_ops():
    """An op that spans the height of a band raises (``HSplit``)."""
    x = spatial.as_split(torch.ones(1, 2, 1, 4, 4))
    with pytest.raises(RuntimeError, match="height-split"):
        x.mean(dim=(2, 3, 4))
    with pytest.raises(RuntimeError, match="height-split"):
        torch.nn.functional.avg_pool3d(x, (1, 2, 2))
    assert spatial.is_split(torch.relu(x) + 1)
    assert spatial.is_split(x.mean(dim=1))


@pytest.mark.slow
def test_spatial_shard_cli_end_to_end(tmp_path):
    """The CLI under ``TPU.SPATIAL_SHARD 2`` (two gloo ranks spawned by
    ``NUM_GPUS 2``): train an epoch, val, then the multi-view test (JAX's
    ``tests/test_spatial_shard.py:218``; slow, as that one is: a whole
    train and test of two processes)."""
    code = ("import sys; from efficient_slowfast_tpu_torch.parallel import "
            "distributed as d; d.TIMEOUT_S = 120; from "
            "efficient_slowfast_tpu_torch.tools.run_net import main; "
            "main(sys.argv[1:])")
    log = open(tmp_path / "cli.log", "w")
    proc = start(["-c", code, "--device", "cpu", "--init_method",
                  f"tcp://127.0.0.1:{free_port()}", "--cfg",
                  os.path.join(ROOT, "configs", "Synthetic",
                               "SHUFFLENETV2_TINY.yaml"),
                  "NUM_GPUS", "2", "TPU.SPATIAL_SHARD", "2", "DIST_BACKEND",
                  "gloo", "OUTPUT_DIR", str(tmp_path), "TRAIN.BATCH_SIZE",
                  "8", "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.BATCH_SIZE", "8",
                  "DATA_LOADER.NUM_WORKERS", "1", "LOG_MODEL_INFO", "False",
                  "TPU.CHECKPOINT_BACKEND", "orbax"], log)
    finish([proc], [str(tmp_path / "cli.log")], time.time())
    names = os.listdir(tmp_path / "checkpoints")
    assert any(n.endswith(".dcp") for n in names), names
    with open(tmp_path / "cli.log") as f:
        assert '"_type": "test_final"' in f.read()


if __name__ == "__main__":
    if sys.argv[1].startswith("jax"):
        jax_main(sys.argv[1], sys.argv[2])
    else:
        rank_main(sys.argv[1], *map(int, sys.argv[2:5]), sys.argv[5])
