"""The port's Grad-CAM of SlowFastShuffleNetV2 against the JAX package's,
f32 on the CPU: scores at rtol = atol = 1e-4, CAMs at atol 1e-3, at a
stage target and at a block named by its JAX path."""

import jax.numpy as jnp
import numpy as np
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu.visualization import gradcam as jax_gradcam
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.utils.weights import (
    jax_module_to_torch, jax_variables_to_state_dict)
from efficient_slowfast_tpu_torch.visualization import gradcam
from torch_port_helpers import efficient_cfg, efficient_variables, inputs_np

SCORE_TOL = dict(rtol=1e-4, atol=1e-4)
CAM_ATOL = 1e-3


def _cams_equal(got, want):
    got, want = (got, want) if isinstance(want, list) else ([got], [want])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=CAM_ATOL)


def test_efficient_gradcam_matches_jax():
    """SlowFastShuffleNetV2 at s3 and at ``s3/pathway1_block0`` (its
    ``nn.Sequential`` index in the port), for a chosen class."""
    def cfg_of(get=None):  # the width of configs/Synthetic/SHUFFLENETV2_TINY
        cfg = efficient_cfg("shufflenetv2",
                            **({} if get is None else {"get_cfg": get}))
        cfg.SLOWFAST.WIDTH_MULTI = 0.25
        return cfg

    cfg = cfg_of()
    variables = efficient_variables(cfg)
    inputs = inputs_np(cfg, batch=2, seed=4)
    block = jax_module_to_torch("s3/pathway1_block0", cfg)
    assert block.startswith("s3.pathway1_channel_") and block.endswith(
        ".features.0"), block
    for target in ("s3", "s3/pathway1_block0"):
        model = build_model(cfg, device="cpu")
        model.load_state_dict(jax_variables_to_state_dict(variables, cfg))
        idx = np.asarray([3, 7])
        p_scores, p_cams = gradcam.GradCAM(model, target, cfg)(
            [torch.from_numpy(x) for x in inputs], idx)
        j_scores, j_cams = jax_gradcam.GradCAM(
            jax_build_model(cfg_of(jax_get_cfg)), variables, target)(
                [jnp.asarray(x) for x in inputs], idx)
        np.testing.assert_allclose(p_scores, np.asarray(j_scores),
                                   **SCORE_TOL)
        assert isinstance(p_cams, list) == (target == "s3")
        _cams_equal(p_cams, j_cams)
