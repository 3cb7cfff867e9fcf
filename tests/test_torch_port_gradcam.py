"""The port's Grad-CAM against the JAX package's on the same weights and
clip, f32 on the CPU: CMDA-R50 (width 16) at its stage s4 and at a block.
Scores within rtol = atol = 1e-4 (as tests/test_full_model_parity.py holds
the forward), CAMs within atol 1e-3 (they lie in [0, 1]); overlays byte
for byte. SlowFastShuffleNetV2 and the video tool are in
test_torch_port_gradcam_video.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu.visualization import gradcam as jax_gradcam
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.utils.weights import \
    jax_variables_to_state_dict
from efficient_slowfast_tpu_torch.visualization import gradcam
from torch_port_helpers import (calibrate_fusions, inputs_np,
                                seeded_variables, small_cfg)

SCORE_TOL = dict(rtol=1e-4, atol=1e-4)
CAM_ATOL = 1e-3
CMDA = "SlowFastDualAttention"


def _cams_equal(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
    else:
        got, want = [got], [want]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32, (g.shape, w.shape)
        assert 0.0 <= g.min() and g.max() <= 1.0
        np.testing.assert_allclose(g, w, rtol=0, atol=CAM_ATOL)


def _both(cfg_of, variables, inputs, jax_target, port_target=None,
          class_idx=None):
    """(port scores, CAMs), (JAX scores, CAMs) of one target."""
    cfg, jcfg = cfg_of(), cfg_of(jax_get_cfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg))
    got = gradcam.GradCAM(model, port_target or jax_target, cfg)(
        [torch.from_numpy(x) for x in inputs], class_idx)
    want = jax_gradcam.GradCAM(jax_build_model(jcfg), variables, jax_target)(
        [jnp.asarray(x) for x in inputs], class_idx)
    return got, want


@pytest.fixture(scope="module")
def cmda():
    cfg_of = lambda get=None: small_cfg(  # noqa: E731
        **({} if get is None else {"get_cfg": get}), model=CMDA,
        flash_min_tokens=64)
    inputs = inputs_np(cfg_of(), batch=1, seed=3)
    variables = calibrate_fusions(cfg_of(), seeded_variables(cfg_of()), inputs)
    return cfg_of, variables, inputs


@pytest.mark.parametrize("jax_target, port_target", [
    ("s4", None), ("s4/pathway1_res3", "s4.pathway1_res3")])
def test_cmda_gradcam_matches_jax(cmda, jax_target, port_target):
    """A stage (one CAM a pathway) and a block (one CAM), the block named
    by the port's module and by JAX's path alike."""
    cfg_of, variables, inputs = cmda
    (p_scores, p_cams), (j_scores, j_cams) = _both(
        cfg_of, variables, inputs, jax_target, port_target)
    np.testing.assert_allclose(p_scores, np.asarray(j_scores), **SCORE_TOL)
    _cams_equal(p_cams, j_cams if isinstance(j_cams, list) else
                np.asarray(j_cams))
    assert isinstance(p_cams, list) == (port_target is None)
    if port_target is None:  # (B, T, H, W) per pathway at s4's 8 x 8
        assert [c.shape for c in p_cams] == [(1, 2, 4, 4), (1, 8, 4, 4)]


def test_unknown_layer_raises_key_error():
    cfg = small_cfg(model=CMDA, depth=18)
    with pytest.raises(KeyError):
        gradcam.GradCAM(build_model(cfg, device="cpu"), "nope/nothere", cfg)


@pytest.mark.parametrize("shape, cam_shape, alpha", [
    ((4, 16, 16, 3), (2, 4, 4), 0.5), ((7, 40, 30, 3), (3, 5, 6), 0.3)])
def test_overlay_heatmap_is_jax_byte_for_byte(shape, cam_shape, alpha):
    rs = np.random.RandomState(sum(shape))
    frames = rs.randint(0, 256, shape).astype(np.uint8)
    cam = rs.rand(*cam_shape).astype(np.float32)
    got = gradcam.overlay_heatmap(frames, cam, alpha)
    want = jax_gradcam.overlay_heatmap(frames, cam, alpha)
    assert got.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, want)
