"""Shared set-up of the PyTorch-port parity tests: one small SlowFast-R50
(or CMDA-R50) config for both packages, seeded inputs, and JAX variables
with jittered BN statistics (as tests/test_inference_engine.py:68-83
jitters them) and, for CMDA, a non-zero attention γ and seeded attention
biases, so that the attention reaches the output."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu_torch.config import get_cfg as torch_get_cfg
from efficient_slowfast_tpu_torch.models import build_model as torch_build_model
from efficient_slowfast_tpu_torch.utils.weights import \
    jax_variables_to_state_dict


def executable(fn, *args):
    """``fn`` jitted (or as jitted already) and compiled for ``args`` at
    XLA's lowest backend optimisation: the JAX references of the port's
    tests spend their time compiling, and op by op (eagerly) a model
    compiles each of its operations apart."""
    fn = fn if hasattr(fn, "lower") else jax.jit(fn)
    return fn.lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


def compiled(fn, *args):
    """``fn(*args)`` through ``executable``."""
    return executable(fn, *args)(*args)


# the stage depths of RESNET.DEPTH, as NUM_BLOCK_TEMP_KERNEL lists them
_DEPTHS = {18: [2, 2, 2, 2], 50: [3, 4, 6, 3], 101: [3, 4, 23, 3]}
# I3D-NLN-R50's non-local blocks (configs/Kinetics/I3D_NLN_8x8_R50.yaml):
# after blocks 1, 3 of s3 and 1, 3, 5 of s4
NLN_R50 = [[], [1, 3], [1, 3, 5], []]


def small_cfg(get_cfg=torch_get_cfg, fused=False, depth=50,
              trans="bottleneck_transform", model="SlowFast",
              flash_min_tokens=1024, arch=None, nonlocal_loc=None,
              instantiation="softmax", width=16):
    """SlowFast (R50 by default) at width 16, 8 frames, α 4, crop 64, 12
    classes, f32; ``model`` "SlowFastDualAttention" gives CMDA, whose
    s1/s2 fusions attend over 512 tokens and s3/s4 over 128 and 32.
    ``model`` "ResNet" gives the single-pathway ``arch`` (i3d by default;
    its s3 attends over 256 tokens, s4 over 64). ``nonlocal_loc`` puts
    non-local blocks after the listed blocks of each stage (in every
    pathway), with ``instantiation``."""
    cfg = get_cfg()
    single = model == "ResNet"
    paths = 1 if single else 2
    cfg.MODEL.MODEL_NAME = model
    cfg.MODEL.ARCH = arch or ("i3d" if single else "slowfast")
    cfg.MODEL.NUM_CLASSES = 12
    cfg.RESNET.DEPTH = depth
    cfg.RESNET.TRANS_FUNC = trans
    cfg.RESNET.WIDTH_PER_GROUP = width
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[n] * paths for n in _DEPTHS[depth]]
    cfg.RESNET.SPATIAL_STRIDES = [[1] * paths] + [[2] * paths] * 3
    cfg.RESNET.SPATIAL_DILATIONS = [[1] * paths] * 4
    cfg.NONLOCAL.LOCATION = [[list(loc)] * paths for loc in
                             (nonlocal_loc or [[]] * 4)]
    cfg.NONLOCAL.GROUP = [[1] * paths] * 4
    cfg.NONLOCAL.POOL = [[[1, 2, 2]] * paths] * 4
    cfg.NONLOCAL.INSTANTIATION = instantiation
    if single:
        cfg.DATA.INPUT_CHANNEL_NUM = [3]
    cfg.SLOWFAST.ALPHA = 4
    cfg.SLOWFAST.BETA_INV = 8
    cfg.SLOWFAST.FUSION_KERNEL_SZ = 7
    cfg.DATA.NUM_FRAMES = 8
    cfg.DATA.CROP_SIZE = 64
    cfg.DATA.TEST_CROP_SIZE = 64
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.FUSED_EVAL = fused
    cfg.TPU.FLASH_MIN_TOKENS = flash_min_tokens
    return cfg


def inputs_np(cfg, batch=2, seed=0):
    rs = np.random.RandomState(seed)
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.CROP_SIZE
    if cfg.MODEL.MODEL_NAME == "ResNet":
        return [rs.rand(batch, t, s, s, 3).astype(np.float32)]
    return [rs.rand(batch, t // cfg.SLOWFAST.ALPHA, s, s, 3).astype(np.float32),
            rs.rand(batch, t, s, s, 3).astype(np.float32)]


def _jitter(tree, key):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _jitter(v, key)
        elif k == "mean":
            key[0] += 1
            out[k] = np.asarray(v) + 0.05 * np.float32(key[0] % 7 - 3)
        elif k == "var":
            key[0] += 1
            out[k] = np.asarray(v) * np.float32(1.0 + 0.1 * (key[0] % 5))
        else:
            out[k] = np.asarray(v)
    return out


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def attention_params(tree, rs, inside=False):
    """Params with every SpatialAttention's γ set to 0.5 (it starts at 0,
    where the attention never reaches the output) and its q/k/v biases
    drawn from ``rs``."""
    out = {}
    for k, v in tree.items():
        here = inside or k.startswith("attention_spatial")
        if hasattr(v, "items"):
            out[k] = attention_params(v, rs, here)
        elif here and k == "gamma":
            out[k] = np.full_like(v, 0.5)
        elif here and k == "bias":
            out[k] = (0.1 * rs.randn(*v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


def nonlocal_params(tree, rs, inside=False, gamma=1.0):
    """Params with every non-local block's final BN γ drawn around
    ``gamma`` from ``rs``: it starts at 0, where the block adds exactly
    nothing and a wrong affinity would pass any comparison of the
    output."""
    out = {}
    for k, v in tree.items():
        here = inside or "_nonlocal" in k
        if hasattr(v, "items"):
            out[k] = nonlocal_params(v, rs, here, gamma)
        elif here and k == "scale":
            out[k] = (gamma * (1.0 + 0.1 * rs.randn(*v.shape))).astype(
                v.dtype)
        else:
            out[k] = v
    return out


def seeded_variables(cfg, seed=0, nonlocal_gamma=1.0):
    """JAX-layout numpy variables of ``cfg``'s model from the port's seeded
    init (no JAX compile), BN statistics jittered, attention γ and biases
    set as in ``jax_model_and_variables`` and non-local γ drawn around
    ``nonlocal_gamma``."""
    from efficient_slowfast_tpu_torch.utils.weights import \
        state_dict_to_jax_variables

    torch.manual_seed(seed)
    variables = state_dict_to_jax_variables(
        torch_build_model(cfg, device="cpu").state_dict())
    params = attention_params(variables["params"], np.random.RandomState(1))
    return {"params": nonlocal_params(params, np.random.RandomState(2),
                                      gamma=nonlocal_gamma),
            "batch_stats": _jitter(variables["batch_stats"], [0])}


def jax_model_and_variables(inputs, **kw):
    """The JAX model of ``small_cfg`` and its numpy variables (BN jittered)."""
    cfg = small_cfg(jax_get_cfg, **kw)
    model = jax_build_model(cfg)
    rng = jax.random.PRNGKey(0)
    variables = compiled(functools.partial(model.init, train=False),
                         {"params": rng, "dropout": rng},
                         [jnp.asarray(x) for x in inputs])
    params = attention_params(_numpy_tree(variables["params"]),
                              np.random.RandomState(1))
    return model, {"params": params,
                   "batch_stats": _jitter(variables["batch_stats"], [0])}


def port_model(variables, **kw):
    """The port's model of ``small_cfg(**kw)`` on the CPU, loaded with the
    JAX variables."""
    cfg = small_cfg(**kw)
    model = torch_build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return cfg, model.eval()


def torch_inputs(inputs):
    return [torch.from_numpy(x) for x in inputs]


def train_cfg(get_cfg=torch_get_cfg, accum=1, remat=False, remat_stages=(),
              flash=True, **kw):
    """``small_cfg`` for training as the reference configs train
    (``configs/Kinetics/SLOWFAST_8x8_R50.yaml``: each block's final BN
    zero-initialised, SGD lr 0.1 with nesterov momentum 0.9, weight decay
    1e-4 and none on BN), with no dropout (the two frameworks draw different
    bits), ``TPU.GRAD_ACCUM_STEPS`` ``accum``, the remat options and
    ``TPU.FLASH_ATTENTION`` ``flash``."""
    cfg = small_cfg(get_cfg, **kw)
    cfg.RESNET.ZERO_INIT_FINAL_BN = True
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.SOLVER.OPTIMIZING_METHOD = "sgd"
    cfg.SOLVER.BASE_LR = 0.1
    cfg.SOLVER.MOMENTUM = 0.9
    cfg.SOLVER.NESTEROV = True
    cfg.SOLVER.DAMPENING = 0.0
    cfg.SOLVER.WEIGHT_DECAY = 1e-4
    cfg.BN.WEIGHT_DECAY = 0.0
    cfg.TPU.GRAD_ACCUM_STEPS = accum
    cfg.TPU.REMAT = remat
    cfg.TPU.REMAT_STAGES = list(remat_stages)
    cfg.TPU.FLASH_ATTENTION = flash
    return cfg


def train_batches(cfg, steps=3, batch=2, seed=10):
    """``steps`` seeded (inputs, labels) batches of numpy arrays."""
    out = []
    for i in range(steps):
        labels = np.random.RandomState(seed + 100 + i).randint(
            0, cfg.MODEL.NUM_CLASSES, batch)
        out.append((inputs_np(cfg, batch, seed + i), labels))
    return out


def jax_train_runs(variables, runs, **kw):
    """JAX's ``make_train_step`` (built and compiled once) over each run of
    ``runs``, a list of [(inputs, labels, lr)], every run from
    ``variables``: per run, (losses, the numpy variables after each step,
    the last metrics)."""
    from efficient_slowfast_tpu.engine.state import (TrainState,
                                                     make_train_step)
    from efficient_slowfast_tpu.models.optimizer import construct_optimizer

    cfg = train_cfg(jax_get_cfg, **kw)
    model = jax_build_model(cfg)
    tx, _ = construct_optimizer(cfg, variables["params"])
    step, out = make_train_step(cfg, model, tx), []
    for run in runs:
        state = TrainState(step=jnp.zeros((), jnp.int32),
                           params=jax.tree_util.tree_map(jnp.asarray,
                                                         variables["params"]),
                           batch_stats=jax.tree_util.tree_map(
                               jnp.asarray, variables["batch_stats"]),
                           opt_state=tx.init(variables["params"]))
        losses, snaps = [], []
        for inputs, labels, lr in run:
            args = (state, [jnp.asarray(x) for x in inputs],
                    jnp.asarray(labels), lr, jax.random.PRNGKey(0))
            if hasattr(step, "lower"):  # compiled once, for every run
                step = executable(step, *args)
            state, mets = step(*args)
            losses.append(float(mets["loss"]))
            # copies: the next step donates the state's buffers
            snaps.append(jax.tree_util.tree_map(
                lambda a: np.array(a, copy=True),
                {"params": state.params, "batch_stats": state.batch_stats}))
        out.append((losses, snaps, {k: float(v) for k, v in mets.items()}))
    return out


def port_train_run(variables, run, generator=None, **kw):
    """The port's ``make_train_step`` on the CPU over ``run``
    [(inputs, labels, lr)] from ``variables``: (losses, the variables in
    JAX's layout after each step, the last metrics, the train state)."""
    from efficient_slowfast_tpu_torch.engine.state import (
        create_train_state, make_train_step)
    from efficient_slowfast_tpu_torch.utils.weights import \
        state_dict_to_jax_variables

    cfg = train_cfg(**kw)
    model = torch_build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    state = create_train_state(cfg, model, device="cpu")
    step = make_train_step(cfg, state.model, state.optimizer)
    losses, snaps = [], []
    for inputs, labels, lr in run:
        mets = step(state, torch_inputs(inputs), torch.from_numpy(labels), lr,
                    generator)
        losses.append(float(mets["loss"]))
        snaps.append(state_dict_to_jax_variables(
            {k: v.clone() for k, v in state.model.state_dict().items()}))
    return losses, snaps, {k: float(v) for k, v in mets.items()}, state


def flat_leaves(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def jax_train_variables(inputs, **kw):
    """Numpy variables of the JAX model of ``train_cfg(**kw)``, BN
    statistics jittered and attention γ and biases set as in
    ``jax_model_and_variables``."""
    model = jax_build_model(train_cfg(jax_get_cfg, **kw))
    rng = jax.random.PRNGKey(0)
    variables = compiled(functools.partial(model.init, train=False),
                         {"params": rng, "dropout": rng},
                         [jnp.asarray(x) for x in inputs])
    params = attention_params(_numpy_tree(variables["params"]),
                              np.random.RandomState(1))
    return {"params": params,
            "batch_stats": _jitter(variables["batch_stats"], [0])}


def calibrate_attention(variables, inputs, std=3.0, **kw):
    """``variables`` with each CMDA fusion's query and key convs (kernel
    and bias) scaled, fusion by fusion, so that its attention logits have
    standard deviation ``std`` on ``inputs`` in a train-mode forward. At
    init the unscaled logits reach std 40-90 here, a near-argmax softmax
    whose gradient cancels to rounding noise (chip_smoke.ATTN_LOGIT_STD
    argues the same for the full-width model)."""
    return calibrate_fusions(train_cfg(**kw), variables, inputs, std)


# The efficient families at the zoo's widths
# (configs/Kinetics/*_16x2_112.yaml): (MODEL_NAME, SLOWFAST.WIDTH_MULTI, SLOWFAST.GROUPS, crop). ShuffleNet's
# crop is 64, as tests/test_full_model_parity.py runs it: its s4 shortcut's
# average-pool window then stays inside the feature map.
EFFICIENT = {
    "shufflenetv2": ("SlowFastShuffleNetV2", 2.0, 1, 32),
    "shufflenet": ("SlowFastShuffleNet", 2.0, 3, 64),
    "mobilenetv2": ("SlowFastMoibleNetV2", 1.0, 1, 32),
    "ghostnet": ("SlowFastGhostNet", 1.0, 1, 32),
}


def efficient_cfg(family, get_cfg=torch_get_cfg, flash_min_tokens=16,
                  train=False):
    """``EFFICIENT[family]`` at 8 frames (α 4, β 8), 12 classes, f32, no
    dropout, with ``TPU.FLASH_MIN_TOKENS`` lowered so that the fusions of
    more than 16 slow tokens take the streaming path (flash_attention in
    the port, chunked_attention in JAX); ``train`` adds the zoo yamls'
    solver (SGD lr 0.01 with nesterov momentum 0.9, weight decay 1e-4 and
    none on BN)."""
    name, wm, groups, crop = EFFICIENT[family]
    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = name
    cfg.MODEL.NUM_CLASSES = 12
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.SLOWFAST.WIDTH_MULTI = wm
    cfg.SLOWFAST.GROUPS = groups
    cfg.SLOWFAST.ALPHA = 4
    cfg.SLOWFAST.BETA_INV = 8
    cfg.DATA.NUM_FRAMES = 8
    cfg.DATA.CROP_SIZE = crop
    cfg.DATA.TEST_CROP_SIZE = crop
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.FLASH_MIN_TOKENS = flash_min_tokens
    if train:
        cfg.SOLVER.OPTIMIZING_METHOD = "sgd"
        cfg.SOLVER.BASE_LR = 0.01
        cfg.SOLVER.MOMENTUM = 0.9
        cfg.SOLVER.NESTEROV = True
        cfg.SOLVER.DAMPENING = 0.0
        cfg.SOLVER.WEIGHT_DECAY = 1e-4
        cfg.BN.WEIGHT_DECAY = 0.0
    return cfg


def efficient_variables(cfg, seed=0):
    """JAX-layout numpy variables of an efficient family from the port's
    seeded init through the weight bridge (no JAX compile), BN statistics
    jittered and every attention γ 0.5 with seeded q/k/v biases."""
    from efficient_slowfast_tpu_torch.utils.weights import \
        state_dict_to_jax_variables

    torch.manual_seed(seed)
    variables = state_dict_to_jax_variables(
        torch_build_model(cfg, device="cpu").state_dict(), cfg)
    return {"params": attention_params(variables["params"],
                                       np.random.RandomState(1)),
            "batch_stats": _jitter(variables["batch_stats"], [0])}


def calibrate_fusions(cfg, variables, inputs, std=3.0):
    """``variables`` of ``cfg``'s model with each CMDA fusion's query and
    key convs scaled, fusion by fusion in the forward's order, so that its
    logits have standard deviation ``std`` on ``inputs`` in a train-mode
    forward."""
    params = _numpy_tree(variables["params"])
    names = [n for n, _ in torch_build_model(cfg, device="cpu")
             .named_modules() if n.endswith("attention_spatial_s2f")]
    for name in names:
        model = torch_build_model(cfg, device="cpu")
        model.load_state_dict(jax_variables_to_state_dict(
            {"params": params, "batch_stats": variables["batch_stats"]},
            cfg))
        att = model.get_submodule(name)
        seen = {}
        att.register_forward_hook(lambda m, inp, out: seen.update(x=inp[0]))
        with torch.no_grad():
            model.train()(torch_inputs(inputs))
            q = att.query_conv(seen["x"]).flatten(2)
            k = att.key_conv(seen["x"]).flatten(2)
            f = (std / torch.einsum("bdn,bdm->bnm", q, k).std().item()) ** 0.5
        att_params = params[name.split(".")[0]]["attention_spatial_s2f"]
        for proj in ("query", "key"):
            conv = att_params[proj]["conv"]
            conv["kernel"] = (conv["kernel"] * f).astype(np.float32)
            conv["bias"] = (conv["bias"] * f).astype(np.float32)
    return {"params": params, "batch_stats": variables["batch_stats"]}
