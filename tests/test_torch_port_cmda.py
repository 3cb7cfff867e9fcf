"""The port's CMDA modules (SpatialAttention, ECA, FuseFastAndSlow and the
whole SlowFastDualAttention, also with its slow-pathway head) against the JAX modules on the same weights,
carried across by jax_variables_to_state_dict, and inputs: f32 on the CPU,
rtol 1e-4 and atol 1e-5, with a non-zero attention γ and jittered BN
statistics, on both sides of TPU.FLASH_MIN_TOKENS."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu.models.fuse import \
    FuseFastAndSlow as JaxFuseFastAndSlow
from efficient_slowfast_tpu.ops import attention as jattn
from efficient_slowfast_tpu.ops.options import configure, options
from efficient_slowfast_tpu_torch.engine.inference import supports
from efficient_slowfast_tpu_torch.engine.state import make_forward
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.models.fuse import FuseFastAndSlow
from efficient_slowfast_tpu_torch.ops.attention import ECA, SpatialAttention
from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
    flash_attention
from efficient_slowfast_tpu_torch.ops.kernels.fused_bottleneck import \
    fused_bottleneck
from efficient_slowfast_tpu_torch.utils.weights import \
    jax_variables_to_state_dict
from torch_port_helpers import (_jitter, _numpy_tree, attention_params,
                                compiled, inputs_np, jax_model_and_variables,
                                port_model, seeded_variables, small_cfg,
                                torch_inputs)

TOL = dict(rtol=1e-4, atol=1e-5)
CMDA = "SlowFastDualAttention"
# (port use_flash, flash_min_tokens): the dense path, the streaming path
# through flash_attention (its plain version on the CPU), and the explicit
# opt-out TPU.FLASH_ATTENTION False
PATHS = {"dense": (True, 1024), "flash": (True, 64),
         "chunked_opt_out": (False, 64)}


@pytest.fixture(autouse=True)
def _restore_jax_options():
    yield
    configure(jax_get_cfg())  # JAX keeps its kernel options process-wide


def _ndhwc(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _to_port(x):  # (B, T, H, W, C) → the NCDHW channels-last view
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _from_port(y):
    return y.permute(0, 2, 3, 4, 1).detach().numpy()


def _jax_variables(module, *args, **kw):
    variables = module.init(jax.random.PRNGKey(0), *args, **kw)
    return {"params": attention_params(_numpy_tree(variables["params"]),
                                       np.random.RandomState(1), True),
            "batch_stats": _jitter(_numpy_tree(
                variables.get("batch_stats", {})), [0])}


def _load(module, variables):
    module.load_state_dict(jax_variables_to_state_dict(variables),
                           strict=True)
    return module.eval()


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spatial_attention_matches_jax(monkeypatch, path):
    use_flash, min_tokens = PATHS[path]
    monkeypatch.setattr(options, "flash_attention", use_flash)
    monkeypatch.setattr(options, "flash_min_tokens", min_tokens)
    x = _ndhwc(np.random.RandomState(2), 2, 2, 6, 6, 8)  # 72 tokens
    jmod = jattn.SpatialAttention(reduction=1)
    variables = _jax_variables(jmod, jnp.asarray(x))
    assert float(variables["params"]["gamma"][0]) == 0.5
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    port = _load(SpatialAttention(8, reduction=1, use_flash=use_flash,
                                  flash_min_tokens=min_tokens), variables)
    with torch.no_grad():
        out = _from_port(port(_to_port(x)))
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.abs(out - x).max() > 1e-2  # the attention reaches the output


def test_eca_matches_jax():
    x = _ndhwc(np.random.RandomState(3), 2, 2, 5, 5, 12)
    jmod = jattn.ECA()
    variables = _jax_variables(jmod, jnp.asarray(x))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    port = _load(ECA(), variables)
    with torch.no_grad():
        out = _from_port(port(_to_port(x)))
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_fuse_fast_and_slow_matches_jax(monkeypatch, path):
    use_flash, min_tokens = PATHS[path]
    monkeypatch.setattr(options, "flash_attention", use_flash)
    monkeypatch.setattr(options, "flash_min_tokens", min_tokens)
    rs = np.random.RandomState(4)
    xs = _ndhwc(rs, 2, 2, 6, 6, 16)   # 72 slow tokens, 16 → 2 channels
    xf = _ndhwc(rs, 2, 8, 6, 6, 4)
    jmod = JaxFuseFastAndSlow(alpha=4, beta_inv=8, reduction=1)
    jx = [jnp.asarray(xs), jnp.asarray(xf)]
    variables = _jax_variables(jmod, jx, train=False)
    ref = jmod.apply(variables, jx, train=False)
    port = _load(FuseFastAndSlow(16, 4, 4, 8, use_flash=use_flash,
                                 flash_min_tokens=min_tokens), variables)
    with torch.no_grad():
        out = port([_to_port(xs), _to_port(xf)])
    assert [o.shape[1] for o in out] == [16 + 4, 2 + 4]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(_from_port(o), np.asarray(r), **TOL)


@pytest.fixture(scope="module")
def cmda_setup():
    inputs = inputs_np(small_cfg(model=CMDA))
    _, variables = jax_model_and_variables(inputs, model=CMDA)
    return inputs, variables


@pytest.mark.parametrize("min_tokens", [1024, 256])
def test_port_cmda_eval_matches_jax(cmda_setup, min_tokens):
    # 512 tokens at s1/s2_fuse, 128 at s3_fuse, 32 at s4_fuse: at 1024 all
    # four attend densely; at 256 s1/s2_fuse stream (JAX chunked against the
    # port's plain version) while s3/s4_fuse stay dense
    from efficient_slowfast_tpu.models import build_model as jax_build_model

    inputs, variables = cmda_setup
    jax_model = jax_build_model(small_cfg(jax_get_cfg, model=CMDA,
                                          flash_min_tokens=min_tokens))
    assert options.flash_min_tokens == min_tokens
    ref = np.asarray(compiled(
        lambda v, x: jax_model.apply(v, x, train=False), variables,
        [jnp.asarray(x) for x in inputs]))
    _, model = port_model(variables, model=CMDA, flash_min_tokens=min_tokens)
    fuses = [model.s1_fuse, model.s2_fuse, model.s3_fuse, model.s4_fuse]
    assert [f.attention_spatial_s2f.flash_min_tokens
            for f in fuses] == [min_tokens] * 4
    with torch.no_grad():
        out = model(torch_inputs(inputs)).numpy()
    assert out.shape == ref.shape == (2, 12)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-4)


def test_make_forward_serves_the_cmda_module(cmda_setup):
    inputs, variables = cmda_setup
    cfg, model = port_model(variables, model=CMDA, fused=True,
                            flash_min_tokens=256)
    assert cfg.TPU.FUSED_EVAL and not supports(cfg)
    out = make_forward(cfg, model, device="cpu")(torch_inputs(inputs))
    with torch.no_grad():
        ref = model(torch_inputs(inputs))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    # no kernel on the CPU: the fused engine does not cover CMDA, and the
    # attention's wrapper (reached at s1/s2_fuse) runs its plain version
    assert fused_bottleneck.launches == flash_attention.launches == 0


@pytest.mark.parametrize("key", ["DETECTION.ENABLE"])
def test_cmda_refuses_what_is_not_ported(key):
    """Detection is ported: under DETECTION.ENABLE CMDA builds the RoI
    head (tests/test_torch_port_detection.py holds it against JAX) and
    refuses only a forward without the boxes that head needs."""
    cfg = small_cfg(model=CMDA)
    cfg.merge_from_list([key, "True"])
    model = build_model(cfg, device="cpu")
    assert type(model.head).__name__ == "ResNetRoIHead"
    with pytest.raises(ValueError, match="boxes"):
        model.eval()(torch_inputs(inputs_np(cfg)))


def test_cmda_slow_pathway_head_matches_jax():
    """MODEL.SLOW_PATHWAY_HEAD: CMDA classifies from the slow pathway alone
    (``efficient_slowfast_tpu/models/cmda.py:110``), as JAX does."""
    cfg, jcfg = small_cfg(model=CMDA), small_cfg(jax_get_cfg, model=CMDA)
    cfg.MODEL.SLOW_PATHWAY_HEAD = jcfg.MODEL.SLOW_PATHWAY_HEAD = True
    variables = seeded_variables(cfg)
    inputs = inputs_np(cfg)
    jmodel = jax_build_model(jcfg)
    ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, [jnp.asarray(x) for x in inputs]))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    assert model.head.projection.in_features == 16 * 32  # slow only
    with torch.no_grad():
        out = model.eval()(torch_inputs(inputs)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-4)


def test_cmda_stage_widths_at_r50():
    cfg = small_cfg(model=CMDA)
    cfg.RESNET.WIDTH_PER_GROUP = 64
    model = build_model(cfg, device="cpu")
    widths = [[getattr(model, s).pathway0_res0.branch2.a.in_channels,
               getattr(model, s).pathway1_res0.branch2.a.in_channels]
              for s in ("s2", "s3", "s4", "s5")]
    assert widths == [[72, 16], [288, 64], [576, 128], [1152, 256]]
    assert model.head.projection.in_features == 2048 + 256
