"""The port's ROIAlign against the JAX package's (``ops/roi_align.py``) on
seeded features and boxes, f32 on the CPU, rtol = atol = 1e-4: boxes
inside the map, boxes clipped to its edges, degenerate and zero-padded
boxes, ``aligned`` True and False, ``sampling_ratio`` 0 (the adaptive
grid) and 2, RoIs of three clips; and its input gradient against
``jax.vjp``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.ops.roi_align import roi_align as jax_roi_align
from efficient_slowfast_tpu_torch.ops.roi_align import roi_align

TOL = dict(rtol=1e-4, atol=1e-4)
B, H, W, C, OUT, SCALE = 3, 9, 14, 6, 7, 1 / 16

# image pixels: the map is (H, W) at 1/16, so the image is 144 × 224
INSIDE = [[0, 10.0, 12.0, 80.0, 70.0], [1, 33.3, 20.5, 150.2, 131.9],
          [2, 100.0, 40.0, 207.0, 143.0], [1, 5.0, 7.0, 30.0, 25.0]]
# clipped to the image, as the data path clips every box: on its edges
EDGE = [[0, 0.0, 0.0, 223.0, 143.0], [2, 150.0, 0.0, 223.0, 60.0],
        [1, 0.0, 100.0, 40.0, 143.0], [0, 223.0, 10.0, 223.0, 143.0]]
# zero extent, negative extent, and the loader's zero-padded box slot
DEGENERATE = [[1, 30.0, 30.0, 30.0, 50.0], [2, 60.0, 50.0, 20.0, 20.0],
              [0, 0.0, 0.0, 0.0, 0.0], [2, 0.0, 0.0, 0.0, 0.0]]
BOXES = {"inside": INSIDE, "edge": EDGE, "degenerate": DEGENERATE,
         "mixed": INSIDE[:2] + EDGE[:2] + DEGENERATE[2:]}


def features(seed=0):
    return np.random.RandomState(seed).randn(B, H, W, C).astype(np.float32)


def both(feat, boxes, aligned, ratio):
    ref = np.asarray(jax_roi_align(jnp.asarray(feat), jnp.asarray(boxes),
                                   OUT, SCALE, ratio, aligned))
    out = roi_align(torch.from_numpy(feat), torch.from_numpy(boxes), OUT,
                    SCALE, ratio, aligned)
    return out, ref


@pytest.mark.parametrize("ratio", [0, 2])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("which", sorted(BOXES))
def test_roi_align_matches_jax(which, aligned, ratio):
    boxes = np.asarray(BOXES[which], np.float32)
    out, ref = both(features(), boxes, aligned, ratio)
    assert out.shape == (len(boxes), OUT, OUT, C) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    if which == "degenerate" and aligned and ratio == 0:
        # the adaptive grid has no sample in them: exactly 0, as torch's
        # kernel gives
        assert (out == 0).all()


def test_zero_padded_boxes_pool_to_exactly_zero():
    boxes = np.zeros((5, 5), np.float32)
    boxes[:, 0] = [0, 1, 2, 0, 1]
    out, _ = both(features(), boxes, True, 0)
    assert torch.equal(out, torch.zeros_like(out))


def test_rois_read_only_their_own_clip():
    """A RoI's values move with its clip's features and no other's."""
    feat = features()
    boxes = np.asarray(INSIDE, np.float32)
    base, _ = both(feat, boxes, True, 0)
    feat[1] += 5.0
    moved, _ = both(feat, boxes, True, 0)
    on_clip1 = boxes[:, 0] == 1
    assert torch.equal(moved[~on_clip1], base[~on_clip1])
    assert not torch.allclose(moved[on_clip1], base[on_clip1])


@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align_input_gradient_matches_jax_vjp(aligned):
    feat = features(1)
    boxes = np.asarray(INSIDE + EDGE + DEGENERATE, np.float32)
    cot = np.random.RandomState(2).randn(len(boxes), OUT, OUT, C).astype(
        np.float32)
    _, vjp = jax.vjp(lambda f: jax_roi_align(f, jnp.asarray(boxes), OUT,
                                             SCALE, 0, aligned),
                     jnp.asarray(feat))
    ref = np.asarray(vjp(jnp.asarray(cot))[0])
    x = torch.from_numpy(feat).requires_grad_(True)
    roi_align(x, torch.from_numpy(boxes), OUT, SCALE, 0, aligned).backward(
        torch.from_numpy(cot))
    np.testing.assert_allclose(x.grad.numpy(), ref, **TOL)
