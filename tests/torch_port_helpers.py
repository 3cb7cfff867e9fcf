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


def small_cfg(get_cfg=torch_get_cfg, fused=False, depth=50,
              trans="bottleneck_transform", model="SlowFast",
              flash_min_tokens=1024):
    """SlowFast (R50 by default) at width 16, 8 frames, α 4, crop 64, 12
    classes, f32; ``model`` "SlowFastDualAttention" gives CMDA, whose
    s1/s2 fusions attend over 512 tokens and s3/s4 over 128 and 32."""
    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = model
    cfg.MODEL.ARCH = "slowfast"
    cfg.MODEL.NUM_CLASSES = 12
    cfg.RESNET.DEPTH = depth
    cfg.RESNET.TRANS_FUNC = trans
    cfg.RESNET.WIDTH_PER_GROUP = 16
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = (
        [[3, 3], [4, 4], [6, 6], [3, 3]] if depth == 50 else [[2, 2]] * 4)
    cfg.RESNET.SPATIAL_STRIDES = [[1, 1], [2, 2], [2, 2], [2, 2]]
    cfg.RESNET.SPATIAL_DILATIONS = [[1, 1]] * 4
    cfg.NONLOCAL.LOCATION = [[[], []]] * 4
    cfg.NONLOCAL.GROUP = [[1, 1]] * 4
    cfg.NONLOCAL.POOL = [[[1, 2, 2], [1, 2, 2]]] * 4
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


def jax_model_and_variables(inputs, **kw):
    """The JAX model of ``small_cfg`` and its numpy variables (BN jittered)."""
    cfg = small_cfg(jax_get_cfg, **kw)
    model = jax_build_model(cfg)
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(functools.partial(model.init, train=False))(
        {"params": rng, "dropout": rng}, [jnp.asarray(x) for x in inputs])
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
