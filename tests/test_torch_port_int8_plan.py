"""K3's launch planner and the layouts its two launches share
(ops/kernels/int8_conv.py: ``plan``, ``quantized_layout``,
``padded_codes``), on the CPU, where the CUDA kernel cannot run.

The planner is held at every int8 conv shape of the int8 SlowFast-R50 8x8
request (the 51 shapes of a 4-clip request at 32 frames and 256², from
the calibrating forward's hooks, ``chip_smoke.py`` phase 15) and at the
off-path shapes: tiles that wgmma takes, shared memory inside the block's
budget, K slabs covering the codes, a grid of at least 132 blocks or a K
split as far as K allows, and the gather's alignment. The quantize pass's
plain version must keep ``activation_codes`` and write zeros elsewhere. An
int64 emulation of the GEMM's addressing (A's rows gathered from the code
buffer segment by segment, B from the padded codes, the K slabs summed per
split) must give the plain version's and JAX's int32 accumulators exactly:
integer sums have no rounding, so every tolerance is zero."""

import numpy as np
import pytest
import torch

from efficient_slowfast_tpu_torch.ops.kernels import int8_conv as k3
from test_torch_port_int8 import _jax_layer, jax_int8  # noqa: F401
import jax.numpy as jnp

# (name, convs of the shape, x (B, Cin, T, H, W), Co, kernel, stride,
# padding): the int8 SlowFast-R50 8x8 request under +INT8_SPATIAL
PATH = [
    ('s1.pathway0_stem.conv', 1, (4, 3, 8, 256, 256), 64,
     (1, 7, 7), (1, 2, 2), (0, 3, 3)),
    ('s1.pathway1_stem.conv', 1, (4, 3, 32, 256, 256), 8,
     (5, 7, 7), (1, 2, 2), (2, 3, 3)),
    ('s1_fuse.conv_f2s', 1, (4, 8, 32, 64, 64), 16,
     (7, 1, 1), (4, 1, 1), (3, 0, 0)),
    ('s2.pathway0_res0.branch1', 1, (4, 80, 8, 64, 64), 256,
     (1, 1, 1), (1, 1, 1), (0, 0, 0)),
    ('s2.pathway0_res0.branch2.a', 1, (4, 80, 8, 64, 64), 64,
     (1, 1, 1), (1, 1, 1), (0, 0, 0)),
    ('s2.pathway0_res0.branch2.b', 3, (4, 64, 8, 64, 64), 64,
     (1, 3, 3), (1, 1, 1), (0, 1, 1)),
    ('s2.pathway0_res0.branch2.c', 3, (4, 64, 8, 64, 64), 256,
     (1, 1, 1), (1, 1, 1), (0, 0, 0)),
    ('s2.pathway0_res1.branch2.a', 2, (4, 256, 8, 64, 64), 64,
     (1, 1, 1), (1, 1, 1), (0, 0, 0)),
    ('s2.pathway1_res0.branch1', 4, (4, 8, 32, 64, 64), 32,
     (1, 1, 1), (1, 1, 1), (0, 0, 0)),
    ('s2.pathway1_res0.branch2.a', 1, (4, 8, 32, 64, 64), 8,
     (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    ('s2.pathway1_res0.branch2.b', 3, (4, 8, 32, 64, 64), 8,
     (1, 3, 3), (1, 1, 1), (0, 1, 1)),
    ('s2.pathway1_res1.branch2.a', 2, (4, 32, 32, 64, 64), 8,
     (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    ('s2_fuse.conv_f2s', 1, (4, 32, 32, 64, 64), 64,
     (7, 1, 1), (4, 1, 1), (3, 0, 0)),
    ('s3.pathway0_res0.branch1', 1, (4, 320, 8, 64, 64), 512,
     (1, 1, 1), (1, 2, 2), (0, 0, 0)),
    ('s3.pathway0_res0.branch2.a', 1, (4, 320, 8, 64, 64), 128,
     (1, 1, 1), (1, 1, 1), (0, 0, 0)),
    ('s3.pathway0_res0.branch2.b', 1, (4, 128, 8, 64, 64), 128,
     (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ('s3.pathway0_res0.branch2.c', 4, (4, 128, 8, 32, 32), 512,
     (1, 1, 1), (1, 1, 1), (0, 0, 0)),
    ('s3.pathway0_res1.branch2.a', 3, (4, 512, 8, 32, 32), 128,
     (1, 1, 1), (1, 1, 1), (0, 0, 0)),
    ('s3.pathway0_res1.branch2.b', 3, (4, 128, 8, 32, 32), 128,
     (1, 3, 3), (1, 1, 1), (0, 1, 1)),
    ('s3.pathway1_res0.branch1', 1, (4, 32, 32, 64, 64), 64,
     (1, 1, 1), (1, 2, 2), (0, 0, 0)),
    ('s3.pathway1_res0.branch2.a', 1, (4, 32, 32, 64, 64), 16,
     (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    ('s3.pathway1_res0.branch2.b', 1, (4, 16, 32, 64, 64), 16,
     (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ('s3.pathway1_res0.branch2.c', 4, (4, 16, 32, 32, 32), 64,
     (1, 1, 1), (1, 1, 1), (0, 0, 0)),
    ('s3.pathway1_res1.branch2.a', 3, (4, 64, 32, 32, 32), 16,
     (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    ('s3.pathway1_res1.branch2.b', 3, (4, 16, 32, 32, 32), 16,
     (1, 3, 3), (1, 1, 1), (0, 1, 1)),
    ('s3_fuse.conv_f2s', 1, (4, 64, 32, 32, 32), 128,
     (7, 1, 1), (4, 1, 1), (3, 0, 0)),
    ('s4.pathway0_res0.branch1', 1, (4, 640, 8, 32, 32), 1024,
     (1, 1, 1), (1, 2, 2), (0, 0, 0)),
    ('s4.pathway0_res0.branch2.a', 1, (4, 640, 8, 32, 32), 256,
     (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    ('s4.pathway0_res0.branch2.b', 1, (4, 256, 8, 32, 32), 256,
     (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ('s4.pathway0_res0.branch2.c', 6, (4, 256, 8, 16, 16), 1024,
     (1, 1, 1), (1, 1, 1), (0, 0, 0)),
    ('s4.pathway0_res1.branch2.a', 5, (4, 1024, 8, 16, 16), 256,
     (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    ('s4.pathway0_res1.branch2.b', 5, (4, 256, 8, 16, 16), 256,
     (1, 3, 3), (1, 1, 1), (0, 1, 1)),
    ('s4.pathway1_res0.branch1', 1, (4, 64, 32, 32, 32), 128,
     (1, 1, 1), (1, 2, 2), (0, 0, 0)),
    ('s4.pathway1_res0.branch2.a', 1, (4, 64, 32, 32, 32), 32,
     (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    ('s4.pathway1_res0.branch2.b', 1, (4, 32, 32, 32, 32), 32,
     (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ('s4.pathway1_res0.branch2.c', 6, (4, 32, 32, 16, 16), 128,
     (1, 1, 1), (1, 1, 1), (0, 0, 0)),
    ('s4.pathway1_res1.branch2.a', 5, (4, 128, 32, 16, 16), 32,
     (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    ('s4.pathway1_res1.branch2.b', 5, (4, 32, 32, 16, 16), 32,
     (1, 3, 3), (1, 1, 1), (0, 1, 1)),
    ('s4_fuse.conv_f2s', 1, (4, 128, 32, 16, 16), 256,
     (7, 1, 1), (4, 1, 1), (3, 0, 0)),
    ('s5.pathway0_res0.branch1', 1, (4, 1280, 8, 16, 16), 2048,
     (1, 1, 1), (1, 2, 2), (0, 0, 0)),
    ('s5.pathway0_res0.branch2.a', 1, (4, 1280, 8, 16, 16), 512,
     (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    ('s5.pathway0_res0.branch2.b', 1, (4, 512, 8, 16, 16), 512,
     (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ('s5.pathway0_res0.branch2.c', 3, (4, 512, 8, 8, 8), 2048,
     (1, 1, 1), (1, 1, 1), (0, 0, 0)),
    ('s5.pathway0_res1.branch2.a', 2, (4, 2048, 8, 8, 8), 512,
     (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    ('s5.pathway0_res1.branch2.b', 2, (4, 512, 8, 8, 8), 512,
     (1, 3, 3), (1, 1, 1), (0, 1, 1)),
    ('s5.pathway1_res0.branch1', 1, (4, 128, 32, 16, 16), 256,
     (1, 1, 1), (1, 2, 2), (0, 0, 0)),
    ('s5.pathway1_res0.branch2.a', 1, (4, 128, 32, 16, 16), 64,
     (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    ('s5.pathway1_res0.branch2.b', 1, (4, 64, 32, 16, 16), 64,
     (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ('s5.pathway1_res0.branch2.c', 3, (4, 64, 32, 8, 8), 256,
     (1, 1, 1), (1, 1, 1), (0, 0, 0)),
    ('s5.pathway1_res1.branch2.a', 2, (4, 256, 32, 8, 8), 64,
     (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    ('s5.pathway1_res1.branch2.b', 2, (4, 64, 32, 8, 8), 64,
     (1, 3, 3), (1, 1, 1), (0, 1, 1)),
]
# beside the path (chip_smoke.py K3_OFF_PATH): Co not a multiple of 8, K
# not a multiple of 32, a temporal stride, a 3-channel stem with stride 2
OFF_PATH = [
    ("proj 40->100 s2", 0, (4, 40, 8, 28, 28), 100, (1, 1, 1), (1, 2, 2),
     (0, 0, 0)),
    ("3x3x3 12->20 K108", 0, (4, 12, 8, 20, 20), 20, (3, 3, 3), (1, 1, 1),
     (1, 1, 1)),
    ("3x1x1 20->36 K60 s2", 0, (4, 20, 16, 14, 14), 36, (3, 1, 1),
     (2, 1, 1), (1, 0, 0)),
    ("stem 3->24 1x5x5 s2", 0, (4, 3, 8, 30, 30), 24, (1, 5, 5), (1, 2, 2),
     (0, 2, 2))]
SHAPES = PATH + OFF_PATH


def test_the_table_is_the_request():
    """51 shapes, 110 convs under +INT8_SPATIAL, 47 of them pointwise (the
    INT8_EVAL set)."""
    assert len(PATH) == 51
    assert sum(r[1] for r in PATH) == 110
    assert sum(r[1] for r in PATH if r[4] == (1, 1, 1)) == 47


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32,
                                       torch.int32])
@pytest.mark.parametrize("name, count, x, co, k, s, p", SHAPES,
                         ids=[r[0] for r in SHAPES])
def test_plan_fits_the_card(name, count, x, co, k, s, p, out_dtype):
    pl = k3.plan(x, co, k, s, p, out_dtype)
    # tiles wgmma takes: 64 rows a consumer warpgroup, N of an instantiation
    assert pl.bm in (64, 128) and pl.nwg in (1, 2)
    assert pl.bn in k3.WGMMA_N and pl.bn % 8 == 0 and pl.bn <= 256
    assert pl.bn >= min(co, 128)
    # shared memory: the CUDA source's formula, inside the block's budget
    # (two blocks an SM where BN <= 64)
    out_size = 2 if out_dtype == torch.bfloat16 else 4
    chunks = pl.k_a // pl.gather if pl.gather else 0
    assert pl.smem == k3.smem_bytes(pl.nwg, pl.bn, pl.stages, out_size,
                                    chunks)
    budget = k3.SMEM_PER_BLOCK if pl.bn > 64 else k3.SMEM_PER_SM // 2 - 1024
    assert pl.smem <= budget <= 227 * 1024
    assert 1 <= pl.stages <= k3.MAX_STAGES
    # K: B's rows hold the codes' K (or its padded copy), A's extent fits,
    # the slabs cover B's rows and every split walks at least one
    kk = k[0] * k[1] * k[2] * x[1]
    assert pl.k_b % 32 == 0 and pl.k_a <= pl.k_b < pl.k_a + 32
    assert pl.k_a >= kk and pl.kp == -(-kk // 32) * 32
    assert pl.nk * k3.SLAB >= pl.k_b > (pl.nk - 1) * k3.SLAB
    assert 1 <= pl.split <= min(pl.nk, k3.MAX_SPLIT)
    # the grid: 132 blocks, or a split as far as K (and the cap) allows
    assert pl.ctas == pl.tiles * pl.split
    assert pl.tiles == -(-pl.m // pl.bm) * -(-co // pl.bn)
    assert pl.ctas >= k3.SMS or (
        pl.split == min(pl.nk, k3.MAX_SPLIT) and pl.nwg == 1) or (
        pl.split == 1 and pl.nwg == 1 and pl.nk == 1), pl
    # the gather: aligned units inside each segment, rows and taps
    if pl.gather:
        u = pl.gather
        assert u in (4, 8, 16)
        assert pl.seg % u == 0 and pl.seg >= pl.kw * pl.cp
        assert (pl.wq * pl.cp) % u == 0 and (pl.sw * pl.cp) % u == 0
    else:  # A by TMA: a pointwise conv, rows of whole 16-byte panels
        assert k == (1, 1, 1) and not any(p) and pl.cp % 16 == 0
    # the buffer holds every tap of every output, with the gathers' slack
    assert (pl.to - 1) * pl.st + pl.kt <= pl.tq
    assert (pl.ho - 1) * pl.sh + pl.kh <= pl.hq
    assert (pl.wo - 1) * pl.sw + pl.kw <= pl.wq
    assert pl.q_bytes >= pl.b * pl.tq * pl.hq * pl.wq * pl.cp + k3.SLAB - 16
    assert pl.cp0 % 4 == 0 and pl.ci <= pl.cp0 < pl.ci + 4
    # the stems' 2 x 2 blocks: 16-byte positions, the kernel halved
    pointwise = k == (1, 1, 1) and not any(p)
    assert pl.s2d == int(not pointwise and s[1:] == (2, 2) and pl.cp0 == 4)
    assert pl.cp == (4 * pl.cp0 if pl.s2d else pl.cp0)
    if pl.s2d:
        assert (pl.kh, pl.kw, pl.sh, pl.sw, pl.gather) == (
            -(-k[1] // 2), -(-k[2] // 2), 1, 1, 16)
    assert pl.relayout == int(pl.cp != x[1] or pl.seg != pl.kw * pl.cp)


# small layers for the layout and the emulation: (Cin, Co, kernel,
# stride, padding, x (B, T, H, W))
LAYERS = {
    "stem 3 1x7x7 s2": (3, 16, (1, 7, 7), (1, 2, 2), (0, 3, 3), (2, 2, 12, 12)),
    "stem 3 5x7x7 s2": (3, 8, (5, 7, 7), (1, 2, 2), (2, 3, 3), (1, 6, 10, 10)),
    "Cin 8 1x3x3": (8, 8, (1, 3, 3), (1, 1, 1), (0, 1, 1), (2, 3, 9, 9)),
    "Cin 8 3x1x1": (8, 16, (3, 1, 1), (1, 1, 1), (1, 0, 0), (2, 4, 6, 6)),
    "Cin 16 1x3x3 s2": (16, 24, (1, 3, 3), (1, 2, 2), (0, 1, 1), (1, 2, 9, 9)),
    "Cin 8 7x1x1 s4": (8, 16, (7, 1, 1), (4, 1, 1), (3, 0, 0), (1, 16, 4, 4)),
    "pointwise 8 s2": (8, 32, (1, 1, 1), (1, 2, 2), (0, 0, 0), (2, 2, 7, 7)),
    "pointwise 48 s2": (48, 40, (1, 1, 1), (1, 2, 2), (0, 0, 0), (2, 2, 7, 7)),
    "Cin 12 3x3x3": (12, 20, (3, 3, 3), (1, 1, 1), (1, 1, 1), (1, 4, 6, 6)),
    "Cin 40 3x1x1 K": (40, 24, (3, 1, 1), (1, 1, 1), (1, 0, 0), (1, 4, 3, 3)),
}


def _layer(name, dtype=torch.float32, seed=0):
    ci, co, k, s, p, (b, t, h, w) = LAYERS[name]
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(b, ci, t, h, w).astype(np.float32)).to(dtype)
    weight = torch.from_numpy(rs.randn(co, ci, *k).astype(np.float32))
    am = x.float().abs().amax()
    return x, weight, am, (ci, co, k, s, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(LAYERS))
def test_quantized_layout_keeps_the_codes_and_zeros_the_rest(name, dtype):
    x, weight, am, (ci, co, k, s, p) = _layer(name, dtype)
    pl = k3.plan(tuple(x.shape), co, k, s, p, torch.float32)
    buf = k3.quantized_layout(x, am, pl)
    assert buf.dtype == torch.int8
    assert tuple(buf.shape) == (pl.b, pl.tq, pl.hq, pl.wq, pl.cp)
    codes = k3.activation_codes(x, am)  # (B, Cin, T, H, W)
    # byte c of buffer position q holds x at q * qs + qo (+ the s2d
    # sub-position c // cp0), channel c % cp0, where that is inside x
    tq, hq, wq, c = torch.meshgrid(
        torch.arange(pl.tq), torch.arange(pl.hq), torch.arange(pl.wq),
        torch.arange(pl.cp), indexing="ij")
    sub, ch = (c // pl.cp0, c % pl.cp0) if pl.s2d else (0 * c, c)
    src = (tq * pl.qst + pl.qot, hq * pl.qsh + sub // 2 + pl.qoh,
           wq * pl.qsw + sub % 2 + pl.qow)
    keep = ch < ci
    for v, size in zip(src, x.shape[2:]):
        keep &= (v >= 0) & (v < size)
    idx = [v.clamp(0, size - 1) for v, size in zip(src, x.shape[2:])]
    want = codes[:, ch.clamp(max=ci - 1), idx[0], idx[1], idx[2]]
    want = want * keep.to(want.dtype)
    assert torch.equal(buf, want)
    if not (k == (1, 1, 1) and s != (1, 1, 1)):  # nothing sliced away:
        # every code of x is in the buffer once
        assert int((buf != 0).sum()) == int((codes != 0).sum())


def _emulate(buf, bq, pl, split):
    """The GEMM's int32 accumulator, in int64, as the kernel reads its
    operands: output row m's K byte k is the code at base(m) + segment
    offset + offset in the segment (a flat read of the buffer, past its
    end into zeros as into the scratch's slack), B's row is the padded
    codes, and each of ``split`` blocks sums its K slabs."""
    flat = torch.cat([buf.reshape(-1).long(), torch.zeros(k3.SLAB,
                                                          dtype=torch.long)])
    m = torch.arange(pl.m)
    wo, r = m % pl.wo, m // pl.wo
    ho, r = r % pl.ho, r // pl.ho
    to, b = r % pl.to, r // pl.to
    base = (((b * pl.tq + to * pl.st) * pl.hq + ho * pl.sh) * pl.wq
            + wo * pl.sw) * pl.cp
    k = torch.arange(pl.k_a)
    seg, off = k // pl.seg, k % pl.seg
    dt, dy = seg // pl.kh, seg % pl.kh
    a = flat[base[:, None] + ((dt * pl.hq + dy) * pl.wq * pl.cp + off)[None]]
    bm = bq[:, :pl.k_a].long()
    acc = torch.zeros(pl.m, bq.shape[0], dtype=torch.long)
    for s in range(split):
        k0 = s * pl.nk // split * k3.SLAB
        k1 = min((s + 1) * pl.nk // split * k3.SLAB, pl.k_a)
        acc += a[:, k0:k1] @ bm[:, k0:k1].T
    assert acc.abs().max() < 2 ** 31
    return acc.view(pl.b, pl.to, pl.ho, pl.wo, -1).int()


@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("name", list(LAYERS))
def test_gemm_emulation_equals_the_plain_accumulator(name, split):
    x, weight, am, (ci, co, k, s, p) = _layer(name, seed=1)
    codes, _ = k3.weight_codes(weight)
    pl = k3.plan(tuple(x.shape), co, k, s, p, torch.int32)
    bq = k3.padded_codes(codes, pl)
    assert tuple(bq.shape) == (co, pl.k_b)
    split = min(split, pl.nk)
    got = _emulate(k3.quantized_layout(x, am, pl), bq, pl, split)
    want = k3.int8_conv_accumulator(x, codes, am, k, s, p)
    assert torch.equal(got, want.permute(0, 2, 3, 4, 1))


@pytest.mark.parametrize("name", ["stem 3 1x7x7 s2", "Cin 8 1x3x3",
                                  "stem 3 5x7x7 s2"])
def test_padded_b_and_split_k_equal_jax(jax_int8, name):  # noqa: F811
    """The padded-tap B layout and a split-K sum, emulated, against JAX's
    int8 conv_general_dilated accumulator (jitted, as it serves)."""
    ci, co, k, s, p, (b, t, h, w) = LAYERS[name]
    rs = np.random.RandomState(7)
    kernel = (rs.randn(*k, ci, co) / np.sqrt(np.prod(k) * ci)).astype(
        np.float32)
    bias = np.zeros(co, np.float32)
    x = rs.randn(b, t, h, w, ci).astype(np.float32)
    act_max, _, _, acc, _ = _jax_layer(ci, co, k, s, p, "float32", kernel,
                                       bias, jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    codes, _ = k3.weight_codes(torch.from_numpy(kernel).permute(4, 3, 0, 1, 2))
    am = torch.tensor(act_max, dtype=torch.float32)
    pl = k3.plan(tuple(xt.shape), co, k, s, p, torch.int32)
    assert pl.relayout == (ci == 3)
    buf = k3.quantized_layout(xt, am, pl)
    for split in range(1, min(pl.nk, 4) + 1):
        got = _emulate(buf, k3.padded_codes(codes, pl), pl, split)
        np.testing.assert_array_equal(got.numpy(), acc)
