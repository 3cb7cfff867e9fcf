"""The entry points under ``TPU.SPATIAL_SHARD 2``: int8 serving (K3's
plain version on halo slabs, the ranges calibrated over the space group),
int8 ``test()``, the serving export, Grad-CAM and the demo, each on two
gloo ranks (this file run as a script, ``rank_main``, with a deadline, as
``tests/test_torch_port_spatial_shard.py`` starts its ranks), held against
the port's one process and, where named, against the JAX package on the
suite's 8 virtual devices (two children, ``jax_main``). f32 on the CPU,
SlowFast with R18-deep bottlenecks at width 16, 8 frames, a 32² crop.

How int8 under the split is held. A float change of 1e-7 flips a
quantization code, and the flips carry through the network, so no int8
path is held to 1e-4 end to end. What is exact: each split int8 conv's
output rows equal the unsplit int8 conv's on the gathered input bit for
bit (integer sums, a per-element dequantization), and the group's range
is exactly the maximum of its ranks' own. The ranges agree with the one
process's to float rounding (1e-6 relative). End to end, a distance
ratio: the split's int8 scores lie no farther from the float scores than
``RATIO`` times the one process's own int8 scores do. If the split
computed the one process's int8 network exactly, the ratio would be 1;
its departures are code flips of the same kind, each moving the scores by
one quantization step, and int8's own distance is the sum of all such
steps, so by the triangle inequality a split whose flips stay at int8's
own size stays within 2. A fault (a band's halo rows lost, a band's range
left unshared) moves a layer's output by its scale, several times int8's
error (JAX's own 2-row-band fault reads 5x, ROADMAP §3).

JAX's split ``+INT8_SPATIAL`` is wrong at 2-row bands on the CPU (XLA's
partitioning of the quantize-then-int8-conv, ROADMAP §3), so the port's
split is held against JAX's unsplit int8 at the 32² crop, and against
JAX's mesh only at 128², where every split int8 conv's bands hold 4 rows
or more and JAX's split agrees with its unsplit. ``INT8_EVAL``'s
pointwise convs have no halo; it is held against JAX's mesh at 32².

Grad-CAM: scores within rtol = atol = 1e-4, CAMs within 1e-3, against
JAX's ``GradCAM`` on mesh-constrained inputs. The demo's float windows
within 1e-4 of the one process's, its int8 windows by the ratio, and only
the master draws, writes and shows."""

import importlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from efficient_slowfast_tpu_torch.config import get_cfg  # noqa: E402
from efficient_slowfast_tpu_torch.config.defaults import \
    assert_and_infer_cfg  # noqa: E402
from efficient_slowfast_tpu_torch.engine import demo as demo_mod  # noqa: E402
from efficient_slowfast_tpu_torch.engine import quantize  # noqa: E402
from efficient_slowfast_tpu_torch.engine.export import (  # noqa: E402
    export_serving, load_serving)
from efficient_slowfast_tpu_torch.engine.state import \
    make_forward  # noqa: E402
from efficient_slowfast_tpu_torch.models import build_model  # noqa: E402
from efficient_slowfast_tpu_torch.ops.conv import int8_convs  # noqa: E402
from efficient_slowfast_tpu_torch.ops.kernels.int8_conv import \
    int8_conv  # noqa: E402
from efficient_slowfast_tpu_torch.parallel import (  # noqa: E402
    distributed, spatial)
from efficient_slowfast_tpu_torch.visualization.gradcam import \
    GradCAM  # noqa: E402
from test_torch_port_spatial_shard import (  # noqa: E402
    JAX_CHILD_FLAGS, finish, free_port, inputs, model_cfg, start)

WORLD = 2
TOL = dict(rtol=1e-4, atol=1e-4)
CAM_ATOL = 1e-3
RATIO = 2.0
# (name, INT8_SPATIAL)
OPTIONS = (("eval", False), ("spatial", True))
CMDA = "SlowFastDualAttention"
# Grad-CAM targets: SlowFast's s2 (bands) and s5 (its fallback, whole at
# 32²), CMDA's s3 and s4 (bands)
CAMS = (("slowfast", "s2"), ("slowfast", "s5"), ("cmda", "s3"),
        ("cmda", "s4"))
DEMO_HW, DEMO_WINDOWS = (32, 44), 2
DEMO_BOXES = {"0": [[0.1, 0.15, 0.5, 0.9], [0.5, 0.1, 0.9, 0.8]],
              "1": [[0.2, 0.2, 0.7, 0.95]]}


# the head's projection scaled so that the logits' spread is ~1, as a
# trained head's (at init they are ~0.04 and the scores near uniform,
# where int8's distance from float shows little)
HEAD_GAIN = 30.0


def base_cfg(get, model="SlowFast", crop=32, s=1, detection=False):
    """``model_cfg`` (D = 1 under the split) with every block's final BN
    at its seeded γ (the train tests zero it: each block the identity)."""
    cfg = model_cfg(get, model, crop=crop, s=s, d=1 if s > 1 else 0,
                    detection=detection)
    cfg.RESNET.ZERO_INIT_FINAL_BN = False
    return cfg


def int8_cfg(spatial_opt, s=1, crop=32):
    cfg = base_cfg(get_cfg, crop=crop, s=s)
    cfg.TPU.INT8_EVAL, cfg.TPU.INT8_SPATIAL = True, spatial_opt
    return cfg


def cam_cfg(get, which, s=1):
    return base_cfg(get, CMDA if which == "cmda" else "SlowFast", s=s)


def weights(cfg):
    """JAX-layout variables of ``cfg``'s model, seeded, the head's gain
    HEAD_GAIN."""
    from torch_port_helpers import seeded_variables

    v = seeded_variables(cfg)
    fc = v["params"]["head"]["projection"]["fc"]
    fc["kernel"] = (np.asarray(fc["kernel"]) * HEAD_GAIN).astype(np.float32)
    return v


def model_of(cfg, sd):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


def torch_x(x):
    return [torch.from_numpy(a) for a in x]


# -- what a rank and the one process run ------------------------------------
class OwnRanges:
    """Each rank's ranges before the job's maximum (``_job_ranges``)."""

    def __enter__(self):
        self.real, self.seen = quantize._job_ranges, []

        def recorded(convs):
            self.seen.append([float(m.act_max) for m in convs])
            self.real(convs)

        quantize._job_ranges = recorded
        return self

    def __exit__(self, *exc):
        quantize._job_ranges = self.real


def int8_run(cfg, sd, x, check_rows=False):
    """(the group's quant state, this rank's own ranges, scores, per int8
    conv call (its name, whether its input was a band, whether its output
    equals the unsplit int8 conv's on the gathered input bit for bit))."""
    model = model_of(cfg, sd)
    with OwnRanges() as own:
        quant = quantize.calibrate_int8(model, [torch_x(x)])
    calls, hooks = [], []
    if check_rows:
        for name, m in int8_convs(model).items():
            hooks.append(m.register_forward_hook(
                lambda m, a, y, name=name: calls.append((name, m, a[0], y))))
    scores = make_forward(cfg, model, "cpu")(torch_x(x)).numpy()
    for h in hooks:
        h.remove()
    rows = []
    with torch.inference_mode():
        for name, m, xb, yb in calls:
            xw, yw = spatial.gather_height(xb), spatial.gather_height(yb)
            bias = m.bias.to(m.compute_dtype) if m.bias is not None else None
            codes, scale = m.weight_codes()
            want = int8_conv(xw, codes, scale, m.act_max, bias,
                             m.kernel_size, m.stride, m.padding,
                             m.compute_dtype)
            rows.append((name, spatial.is_split(xb), torch.equal(yw, want)))
    own = own.seen[0] if own.seen else [float(v) for v in quant.values()]
    return ({k: float(v) for k, v in quant.items()}, own, scores, rows)


def cam_run(cfg, sd, x):
    """{target: (scores, CAMs)} of ``cfg``'s model on ``x``."""
    model = model_of(cfg, sd)
    which = "cmda" if cfg.MODEL.MODEL_NAME == CMDA else "slowfast"
    return {t: GradCAM(model, t, cfg)(torch_x(x)) for w, t in CAMS
            if w == which}


def int8_test_cfg(out, ckpt, s=1):
    """int8 ``test()`` of the synthetic split on the weights of ``ckpt``:
    4-clip batches, one view, calibrated on 2 batches."""
    cfg = int8_cfg(False, s=s)
    cfg.TEST.CHECKPOINT_FILE_PATH, cfg.TEST.CHECKPOINT_TYPE = ckpt, "pytorch"
    cfg.TRAIN.ENABLE = False
    cfg.TEST.DATASET = "synthetic"
    cfg.TEST.BATCH_SIZE = 4
    cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = 1, 1
    cfg.TPU.INT8_CALIB_BATCHES = 2
    cfg.DATA_LOADER.NUM_WORKERS = 1
    cfg.OUTPUT_DIR = out
    return assert_and_infer_cfg(cfg)


def int8_test_runs(cfg):
    """Two ``test()`` runs (the first calibrates and persists, the second
    loads): (each run's video scores, the saves this rank made)."""
    test_mod = importlib.import_module(
        "efficient_slowfast_tpu_torch.engine.test")
    saves, real = [], quantize.save_calibration
    quantize.save_calibration = lambda *a: saves.append(1) or real(*a)
    try:
        preds = [test_mod.test(cfg, device="cpu").video_preds
                 for _ in range(2)]
    finally:
        quantize.save_calibration = real
    return preds, len(saves)


def demo_cfg(out, kind, s=1, ckpt=""):
    """A demo of ``kind``: "fused" (K1's engine), "int8" (INT8_EVAL,
    calibrated lazily on the first window) or "detection" (boxes from a
    file), on the seeded weights of ``ckpt``."""
    cfg = base_cfg(get_cfg, s=s, detection=kind == "detection")
    cfg.TPU.FUSED_EVAL = kind == "fused"
    cfg.TPU.INT8_EVAL = kind == "int8"
    cfg.TRAIN.ENABLE, cfg.TEST.ENABLE, cfg.DEMO.ENABLE = False, False, True
    cfg.TEST.CHECKPOINT_FILE_PATH, cfg.TEST.CHECKPOINT_TYPE = ckpt, "pytorch"
    cfg.DEMO.OUTPUT_FILE = os.path.join(out, f"{kind}.mp4")
    cfg.OUTPUT_DIR = os.path.join(out, kind)
    if kind == "detection":
        cfg.DEMO.BOXES_FILE = os.path.join(out, "boxes.json")
        cfg.DETECTION.ENABLE = True
    return cfg


def demo_windows():
    rs = np.random.RandomState(7)
    return [(w, rs.randint(0, 255, (8, *DEMO_HW, 3), np.uint8))
            for w in range(DEMO_WINDOWS)]


def demo_run(cfg):
    """(the raw scores of each window's forward, the entries, the windows
    shown, the windows drawn) of the demo on the injected stream."""
    scores, shown, drawn = [], [], []
    made = {"cls": demo_mod.make_forward,
            "det": demo_mod.make_detection_forward}
    annotate = (demo_mod._annotate, demo_mod._annotate_boxes)

    def recording(make):
        def build(*a, **k):
            fwd = make(*a, **k)

            def call(*args):
                out = fwd(*args)
                scores.append(out.float().numpy().copy())
                return out
            return call
        return build

    demo_mod.make_forward = recording(made["cls"])
    demo_mod.make_detection_forward = recording(made["det"])
    demo_mod._annotate = lambda *a: drawn.append(1) or annotate[0](*a)
    demo_mod._annotate_boxes = lambda *a: drawn.append(1) or annotate[1](*a)
    try:
        entries = demo_mod.demo(cfg, stream=iter(demo_windows()),
                                display=lambda f: shown.append(1) or True,
                                device="cpu")
    finally:
        demo_mod.make_forward = made["cls"]
        demo_mod.make_detection_forward = made["det"]
        demo_mod._annotate, demo_mod._annotate_boxes = annotate
    # the forward's calls after the warm-up's: one a window
    return scores[len(scores) - len(entries):], entries, len(shown), len(
        drawn)


def rank_main(rank, port, d):
    """One rank of the S = 2 job: each check's rank side, saved to
    ``d/rank{rank}.pt``."""
    torch.set_num_threads(1)
    distributed.TIMEOUT_S = 120
    data = torch.load(os.path.join(d, "data.pt"), weights_only=False)
    cfg = base_cfg(get_cfg, s=WORLD)
    cfg.NUM_SHARDS, cfg.SHARD_ID = WORLD, rank
    distributed.init_distributed(cfg, 0, "cpu", f"tcp://127.0.0.1:{port}")
    out = {"mesh": (distributed.space_rank(), distributed.space_size())}
    for name, opt in OPTIONS:
        cfg = int8_cfg(opt, s=WORLD)
        out[name] = int8_run(cfg, data["sd"], data["x"], check_rows=True)
        out[f"odd_{name}"] = int8_run(int8_cfg(opt, s=WORLD, crop=34),
                                      data["sd"], data["x34"])
    out["big"] = int8_run(int8_cfg(True, s=WORLD, crop=128), data["sd"],
                          data["x128"], check_rows=True)
    # (iii) the export of the +INT8_SPATIAL model, calibrated by the group
    cfg = int8_cfg(True, s=WORLD)
    model = model_of(cfg, data["sd"])
    quantize.calibrate_int8(model, [torch_x(data["x"])])
    out["export"] = export_serving(cfg, model, os.path.join(d, "split_int8"),
                                   device="cpu")
    out["exists_after_barrier"] = os.path.exists(out["export"])
    # (ii) int8 test()
    out["test"] = int8_test_runs(int8_test_cfg(
        os.path.join(d, "test"), data["ckpt_fused"], s=WORLD))
    # (iv) Grad-CAM
    for which in ("slowfast", "cmda"):
        out[f"cam_{which}"] = cam_run(cam_cfg(get_cfg, which, s=WORLD),
                                      data[f"cam_{which}"], data["x1"])
    # (v) the demo
    for kind in ("fused", "int8", "detection"):
        out[f"demo_{kind}"] = demo_run(demo_cfg(
            os.path.join(d, "demo"), kind, s=WORLD, ckpt=data[f"ckpt_{kind}"]))
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    distributed.destroy_distributed()


# -- JAX's references, in one child ------------------------------------------
# JAX's references in two children that run side by side: the forwards,
# and Grad-CAM (each traces and compiles its own models)
JAX_PARTS = ("serve", "cam")


def jax_main(part, d):
    """JAX's scores (``part`` "serve") or CAMs ("cam") on the suite's 8
    virtual CPU devices, saved to ``d/jax_{part}.pt``: the float and int8
    forwards unsplit (int8 calibrated unsplit, as JAX's test engine
    calibrates), INT8_EVAL on the S = 2 mesh, +INT8_SPATIAL at 128²
    unsplit and on the mesh; Grad-CAM of each target on mesh-constrained
    inputs."""
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + JAX_CHILD_FLAGS
    import jax

    jax.config.update("jax_platforms", "cpu")
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.environ["JAX_COMPILATION_CACHE_DIR"])
    import jax.numpy as jnp

    from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
    from efficient_slowfast_tpu.engine.quantize import \
        calibrate_int8 as jax_calibrate
    from efficient_slowfast_tpu.engine.state import \
        make_forward as jax_forward
    from efficient_slowfast_tpu.models import build_model as jax_build_model
    from efficient_slowfast_tpu.ops.options import configure
    from efficient_slowfast_tpu.parallel.mesh import build_mesh, shard_batch
    from efficient_slowfast_tpu.visualization.gradcam import \
        GradCAM as JaxGradCAM

    torch.set_num_threads(1)
    data = torch.load(os.path.join(d, "data.pt"), weights_only=False)
    v = torch.load(os.path.join(d, "variables.pt"), weights_only=False)
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731

    def jcfg(opt=None, s=0, crop=32):
        cfg = base_cfg(jax_get_cfg, crop=crop, s=s)
        if opt is not None:
            cfg.TPU.INT8_EVAL, cfg.TPU.INT8_SPATIAL = True, opt
        return cfg

    def serve(cfg, var, x):
        model = jax_build_model(cfg)
        jx = [jnp.asarray(a) for a in x]
        if cfg.TPU.SPATIAL_SHARD:
            jx = shard_batch(build_mesh(cfg), jx, spatial=True)
        return np.asarray(jax_forward(cfg, model)(var, jx))

    def calibrated(cfg, x):
        var = {"params": tree(v["sf"]["params"]),
               "batch_stats": tree(v["sf"]["batch_stats"])}
        return jax_calibrate(jax_build_model(cfg), var,
                             [[jnp.asarray(a) for a in x]])

    out = {}
    try:
        if part == "cam":
            for which, target in CAMS:
                cfg = cam_cfg(jax_get_cfg, which, s=2)
                x = shard_batch(build_mesh(cfg),
                                [jnp.asarray(a) for a in data["x1"]],
                                spatial=True)
                scores, cams = JaxGradCAM(jax_build_model(cfg),
                                          tree(v[which]), target)(x)
                out[f"cam_{which}_{target}"] = (np.asarray(scores),
                                                [np.asarray(c) for c in cams])
            return
        plain = {"params": tree(v["sf"]["params"]),
                 "batch_stats": tree(v["sf"]["batch_stats"])}
        out["float"] = serve(jcfg(), plain, data["x"])
        out["float128"] = serve(jcfg(crop=128), plain, data["x128"])
        for name, opt in OPTIONS:
            var = calibrated(jcfg(opt), data["x"])
            out[name] = serve(jcfg(opt), var, data["x"])
            if not opt:
                out["eval_mesh"] = serve(jcfg(opt, s=2), var, data["x"])
        var = calibrated(jcfg(True, crop=128), data["x128"])
        out["big"] = serve(jcfg(True, crop=128), var, data["x128"])
        out["big_mesh"] = serve(jcfg(True, s=2, crop=128), var, data["x128"])
    finally:
        configure(jax_get_cfg())
        torch.save(out, os.path.join(d, f"jax_{part}.pt"))


# -- the fixture ---------------------------------------------------------------
def write_ckpt(path, sd):
    torch.save({"model_state": sd}, path)
    return str(path)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Start the two ranks and the JAX child, compute the one process's
    references meanwhile, then collect."""
    from efficient_slowfast_tpu_torch.utils.weights import \
        jax_variables_to_state_dict
    from torch_port_helpers import calibrate_fusions

    d = tmp_path_factory.mktemp("space_entry")
    one = base_cfg(get_cfg)
    x1 = inputs(one, 1, 43)
    sf = weights(one)
    cmda_cfg = cam_cfg(get_cfg, "cmda")
    cmda = calibrate_fusions(cmda_cfg, weights(cmda_cfg), x1)
    det = weights(base_cfg(get_cfg, detection=True))
    sd = jax_variables_to_state_dict(sf)
    det_sd = jax_variables_to_state_dict(det)
    for sub in ("demo", "demo1"):
        (d / sub).mkdir()
        (d / sub / "boxes.json").write_text(json.dumps(DEMO_BOXES))
    data = dict(
        sd=sd, x=inputs(one, 4, 40), x34=inputs(base_cfg(get_cfg, crop=34),
                                                4, 41),
        x128=inputs(base_cfg(get_cfg, crop=128), 2, 42), x1=x1,
        cam_slowfast=sd, cam_cmda=jax_variables_to_state_dict(cmda),
        ckpt_fused=write_ckpt(d / "sf.pyth", sd),
        ckpt_int8=write_ckpt(d / "sf_int8.pyth", sd),
        ckpt_detection=write_ckpt(d / "det.pyth", det_sd))
    torch.save(data, d / "data.pt")
    torch.save(dict(sf=sf, slowfast=sf, cmda=cmda), d / "variables.pt")

    t0 = time.time()
    port = free_port()
    logs = ([str(d / f"jax_{part}.log") for part in JAX_PARTS]
            + [str(d / f"rank{r}.log") for r in range(WORLD)])
    procs = [start([__file__, "jax", part, str(d)], open(log, "w"))
             for part, log in zip(JAX_PARTS, logs)]
    procs += [start([__file__, str(r), str(port), str(d)],
                    open(logs[len(JAX_PARTS) + r], "w"))
              for r in range(WORLD)]

    ref = dict(data=data)
    ref["float"] = make_forward(one, model_of(one, sd), "cpu")(
        torch_x(data["x"])).numpy()
    odd = base_cfg(get_cfg, crop=34)
    ref["odd_float"] = make_forward(odd, model_of(odd, sd), "cpu")(
        torch_x(data["x34"])).numpy()
    for name, opt in OPTIONS:
        ref[name] = int8_run(int8_cfg(opt), sd, data["x"])
        ref[f"odd_{name}"] = int8_run(int8_cfg(opt, crop=34), sd,
                                      data["x34"])
    ref["test"] = int8_test_runs(int8_test_cfg(str(d / "test1"),
                                               data["ckpt_fused"]))
    float_test = int8_test_cfg(str(d / "test_float"), data["ckpt_fused"])
    float_test.TPU.INT8_EVAL = False
    ref["test_float"] = importlib.import_module(
        "efficient_slowfast_tpu_torch.engine.test").test(
            float_test, device="cpu").video_preds
    for which in ("slowfast", "cmda"):
        ref[f"cam_{which}"] = cam_run(cam_cfg(get_cfg, which),
                                      data[f"cam_{which}"], x1)
    for kind in ("fused", "int8", "detection"):
        ref[f"demo_{kind}"] = demo_run(demo_cfg(
            str(d / "demo1"), kind, ckpt=data[f"ckpt_{kind}"]))
    finish(procs, logs, t0)
    ref["jax"] = {k: v for part in JAX_PARTS for k, v in torch.load(
        d / f"jax_{part}.pt", weights_only=False).items()}
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ref, ranks, d


# -- the checks ----------------------------------------------------------------
def far(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def held_by_ratio(got, want_int8, want_float, what):
    """``got`` no farther from ``want_float`` than RATIO x ``want_int8``
    is (max |d| of the scores)."""
    own = far(want_int8, want_float)
    assert own > 0, what
    assert far(got, want_float) <= RATIO * own, (what, far(got, want_float),
                                                 own)


def test_ranks_form_one_space_group(job):
    _, ranks, _ = job
    assert [r["mesh"] for r in ranks] == [(0, 2), (1, 2)]


@pytest.mark.parametrize("name", [n for n, _ in OPTIONS])
def test_int8_ranges_are_the_groups_and_the_one_processes(job, name):
    """(i) The group's range of each conv is exactly the maximum of its
    ranks' own (a band's), equal on both ranks, and within 1e-6 relative
    of the one process's; at 34² too, whose stride-2 rows fall back to
    the whole height, where the pointwise convs' strided calibration
    reads the one process's rows."""
    ref, ranks, _ = job
    for key in (name, f"odd_{name}"):
        quant = ranks[0][key][0]
        assert ranks[1][key][0] == quant
        own = np.maximum(ranks[0][key][1], ranks[1][key][1])
        np.testing.assert_array_equal(own, np.asarray(list(quant.values()),
                                                      np.float32))
        want = ref[key][0]
        assert set(quant) == set(want)
        for k in want:
            np.testing.assert_allclose(quant[k], want[k], rtol=1e-6,
                                       err_msg=k)
    # a band's own range is below the frame's somewhere: the reduction
    # did something
    assert any(a != b for a, b in zip(ranks[0][name][1], ranks[1][name][1]))


@pytest.mark.parametrize("name", [n for n, _ in OPTIONS])
def test_int8_rows_are_the_unsplit_convs_bit_for_bit(job, name):
    """(i) Every int8 conv of a split forward (47-style pointwise and,
    under +INT8_SPATIAL, the stems and 3x3s) gives the unsplit int8 conv's
    output on the gathered input, bit for bit; most on bands."""
    _, ranks, _ = job
    for r in ranks:
        rows = r[name][3]
        assert rows and all(eq for _, _, eq in rows), [
            n for n, _, eq in rows if not eq]
        banded = [n for n, split, _ in rows if split]
        assert len(banded) >= len(rows) // 2, banded
        if name == "spatial":
            assert any("stem" in n for n in banded)


@pytest.mark.parametrize("name", [n for n, _ in OPTIONS])
def test_int8_scores_by_the_ratio(job, name):
    """(i) The split's int8 scores against the one process's float and
    int8, and against JAX's unsplit float and int8, by RATIO; under
    INT8_EVAL also against JAX's int8 forward on its S = 2 mesh; at 34²
    against the one process's."""
    ref, ranks, _ = job
    jax_ref = ref["jax"]
    for r in ranks:
        got = r[name][2]
        np.testing.assert_array_equal(got, ranks[0][name][2])
        held_by_ratio(got, ref[name][2], ref["float"], f"{name} port")
        held_by_ratio(got, jax_ref[name], jax_ref["float"], f"{name} JAX")
        if name == "eval":
            held_by_ratio(got, jax_ref["eval_mesh"], jax_ref["float"],
                          "INT8_EVAL JAX mesh")
        held_by_ratio(r[f"odd_{name}"][2], ref[f"odd_{name}"][2],
                      ref["odd_float"], f"{name} 34")


def test_int8_spatial_at_four_row_bands_against_jax_mesh(job):
    """(i) At 128² every split int8 conv's bands hold 4 rows or more: there
    JAX's split +INT8_SPATIAL agrees with its unsplit, and the port's
    split is held against JAX's mesh by the ratio."""
    ref, ranks, _ = job
    jax_ref = ref["jax"]
    held_by_ratio(jax_ref["big_mesh"], jax_ref["big"], jax_ref["float128"],
                  "JAX's split at 128²")
    for r in ranks:  # every int8 conv on bands, bit for bit
        rows = r["big"][3]
        assert rows and all(eq and split for _, split, eq in rows)
        held_by_ratio(r["big"][2], jax_ref["big_mesh"], jax_ref["float128"],
                      "port split vs JAX mesh at 128²")


def test_int8_test_calibrates_once_and_the_master_persists(job):
    """(ii) int8 test() under the split: the first run calibrates over the
    group and the master alone persists; the second loads the file; the
    ranks' video scores are equal, and held against the one process's
    int8 and float test() by the ratio."""
    ref, ranks, _ = job
    (a1, a2), saves0 = ranks[0]["test"]
    (b1, b2), saves1 = ranks[1]["test"]
    assert (saves0, saves1) == (1, 0)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(a1, b1)
    (w1, w2), saves = ref["test"]
    assert saves == 1
    np.testing.assert_array_equal(w1, w2)
    held_by_ratio(a1, w1, ref["test_float"], "int8 test()")


def test_split_export_is_the_unsplit_artifact(job):
    """(iii) The master writes the one-device artifact (the others wait
    for it), carrying the group's ranges: its scores equal those of the
    unsplit export of the same model and ranges, at batches 4 and 1."""
    ref, ranks, d = job
    path = ranks[0]["export"]
    assert ranks[1]["export"] == path and all(
        r["exists_after_barrier"] for r in ranks)
    cfg = int8_cfg(True)
    model = model_of(cfg, ref["data"]["sd"])
    quant = {k: torch.tensor(np.float32(v))
             for k, v in ranks[0]["spatial"][0].items()}
    one = export_serving(cfg, model, str(d / "one_int8"), quant=quant,
                         device="cpu")
    split, whole = load_serving(path), load_serving(one)
    for b in (4, 1):
        x = [a[:b] for a in ref["data"]["x"]]
        np.testing.assert_array_equal(split(x), whole(x))


@pytest.mark.parametrize("which, target", CAMS)
def test_gradcam_matches_jax_mesh(job, which, target):
    """(iv) Scores and CAMs of each rank against JAX's GradCAM on
    mesh-constrained inputs and the one process's."""
    ref, ranks, _ = job
    j_scores, j_cams = ref["jax"][f"cam_{which}_{target}"]
    o_scores, o_cams = ref[f"cam_{which}"][target]
    for r in ranks:
        scores, cams = r[f"cam_{which}"][target]
        np.testing.assert_allclose(scores, j_scores, **TOL)
        np.testing.assert_allclose(scores, o_scores, **TOL)
        assert isinstance(cams, list) and len(cams) == len(j_cams) == 2
        for c, jc, oc in zip(cams, j_cams, o_cams):
            assert c.shape == jc.shape == oc.shape
            np.testing.assert_allclose(c, jc, rtol=0, atol=CAM_ATOL)
            np.testing.assert_allclose(c, oc, rtol=0, atol=CAM_ATOL)


@pytest.mark.parametrize("kind", ["fused", "int8", "detection"])
def test_demo_windows_against_the_one_process(job, kind):
    """(v) Each rank serves every window; the float windows (fused K1's
    engine, the RoI head) within 1e-4 of the one process's, the int8
    windows by the ratio against the one process's fused and int8
    windows; the master alone draws, writes and shows."""
    ref, ranks, d = job
    o_scores, o_entries, _, _ = ref[f"demo_{kind}"]
    for i, r in enumerate(ranks):
        scores, entries, shown, drawn = r[f"demo_{kind}"]
        assert len(scores) == len(o_scores) == len(entries) >= 1
        assert [e["window"] for e in entries] == [
            e["window"] for e in o_entries]
        for got, want, f in zip(scores, o_scores, ref["demo_fused"][0]):
            if kind == "int8":
                held_by_ratio(got, want, f, "int8 demo window")
            else:
                np.testing.assert_allclose(got, want, **TOL)
        assert (shown > 0, drawn > 0) == (i == 0, i == 0), (i, shown, drawn)
    assert os.path.getsize(d / "demo" / f"{kind}.mp4") > 0


@pytest.mark.slow
def test_entry_point_clis_under_the_split(tmp_path):
    """The Grad-CAM tool and the CLI's demo branch under ``TPU.SPATIAL_SHARD
    2`` (two gloo ranks spawned by ``NUM_GPUS 2``) on a video file: the
    master alone writes the overlays and the annotated video (slow: two
    whole jobs of two processes, each building the model)."""
    from efficient_slowfast_tpu_torch.data import decoder

    video = str(tmp_path / "clip.mp4")
    frames = np.random.RandomState(3).randint(0, 255, (64, 48, 64, 3),
                                              np.uint8)
    decoder.write_test_video(video, frames, fps=30)
    tiny = os.path.join(ROOT, "configs", "Synthetic", "SHUFFLENETV2_TINY.yaml")
    split = ["NUM_GPUS", "2", "DIST_BACKEND", "gloo", "TPU.SPATIAL_SHARD",
             "2", "OUTPUT_DIR", str(tmp_path)]
    head = ("import sys; from efficient_slowfast_tpu_torch.parallel import "
            "distributed as d; d.TIMEOUT_S = 120; from "
            "efficient_slowfast_tpu_torch.tools.{} import main; "
            "main(sys.argv[1:])")
    runs = [(["-c", head.format("gradcam_video"), "--device", "cpu",
              "--init_method", f"tcp://127.0.0.1:{free_port()}", "--cfg",
              tiny, "--video", video, "--target-layer", "s3", "--out-dir",
              str(tmp_path / "cam")] + split, "cam.log"),
            (["-c", head.format("run_net"), "--device", "cpu",
              "--init_method", f"tcp://127.0.0.1:{free_port()}", "--cfg",
              tiny, "TRAIN.ENABLE", "False", "TEST.ENABLE", "False",
              "DEMO.ENABLE", "True", "DEMO.DATA_SOURCE", video,
              "DEMO.OUTPUT_FILE", str(tmp_path / "demo.mp4")] + split,
             "demo.log")]
    for argv, name in runs:
        log = str(tmp_path / name)
        finish([start(argv, open(log, "w"))], [log], time.time())
    cams = sorted(os.listdir(tmp_path / "cam"))
    assert cams == [f"gradcam_clip_s3_pathway{p}.mp4" for p in (0, 1)]
    assert decoder.probe(str(tmp_path / "demo.mp4"))["nb_frames"] > 0
    with open(tmp_path / "demo.log") as f:
        assert f.read().count('"_type": "demo_window"') >= 2


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_main(sys.argv[2], sys.argv[3])
    else:
        rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
