"""The split of the bf16 cluster kernel (``csrc/flash_attention.cu``, D or
C above 128) that ``forward_split`` plans, over a grid of widths from 129
to 2048, D and C apart, with ragged N and M: the cluster's size, its
slices of D and C, the shared memory a block asks for, the grid, and the
logit work against the bound's. The kernel itself runs only on the card;
``chip_smoke.py`` checks the plan's bytes against the launched kernel's
attribute there."""

import itertools

import pytest

from efficient_slowfast_tpu_torch.ops.kernels import flash_attention as tfa

SMEM_LIMIT = 232448  # dynamic shared memory of an H100 block
WIDTHS = (129, 136, 200, 256, 300, 512, 600, 700, 1000, 1024, 1100, 1536,
          2048)
# (B, N, M): ragged against the 128-row query tile and the key tiles
ROWS = ((1, 1000, 250), (8, 4096, 1024), (16, 1568, 392))


def _ceil(x, to):
    return -(-x // to) * to


@pytest.mark.parametrize("d,c", [
    pytest.param(d, c, id=f"d{d}-c{c}")
    for d, c in itertools.chain(
        itertools.product(WIDTHS, WIDTHS),
        ((64, w) for w in WIDTHS), ((w, 64) for w in WIDTHS))])
def test_split_fits_the_kernel(d, c):
    for b, n, m in ROWS:
        plan = tfa.forward_split(b, n, m, d, c)
        r = plan["cluster"]
        assert r in (1, 2, 4, 8)
        assert -(-c // r) <= 256 and plan["c_slice"] <= plan["width"] <= 256
        assert plan["c_slice"] % 64 == 0 and plan["c_slice"] * r >= c
        assert plan["d_slice"] == 256  # the kernel's unrolled logit chain
        assert plan["d_slice"] * (r if plan["exchange"] else 1) >= d
        assert plan["exchange"] == (d > 256)
        assert plan["blocks"] == r * -(-n // plan["rows"]) * b
        assert plan["blocks"] % r == 0
        assert plan["smem"] <= SMEM_LIMIT
        assert plan["smem"] == tfa.cluster_smem_bytes(
            plan["d_slice"], plan["width"], plan["keys"], plan["k_stages"],
            plan["v_stages"], plan["exchange"], r)
        # the exchange's tiles are 32 keys; deferred (R up to 4) it runs
        # S two tiles ahead, which needs three k stages
        assert plan["keys"] == (32 if plan["exchange"] else 64)
        assert 2 <= plan["v_stages"] <= plan["k_stages"] <= 3
        if plan["exchange"] and r <= 4:
            assert plan["k_stages"] == 3
        # the logits are computed once where the cluster splits D (up to
        # the padding of its slices), R times where every block holds D
        assert plan["recompute"] == pytest.approx(
            r * plan["d_slice"] / d)
        assert plan["recompute"] >= 1.0


@pytest.mark.parametrize("d,c,cluster,exchange", [
    (256, 256, 1, False),    # I3D-NLN's s3: one block a query tile
    (512, 512, 2, True),     # s4: a cluster of two splits D
    (1024, 1024, 4, True),   # a res5 block: four, no recompute
    (64, 2048, 8, False),    # narrow D: each block computes it whole
    (2048, 64, 8, True),     # wide D, narrow C: D sets the cluster
])
def test_split_at_the_zoo_widths(d, c, cluster, exchange):
    plan = tfa.forward_split(8, 4096, 1024, d, c)
    assert (plan["cluster"], plan["exchange"]) == (cluster, exchange)
    assert plan["d_slice"] == 256
    # once where the blocks split D in 256-column slices or one block holds
    # D = 256; R times 256 / D where every block computes it whole
    assert plan["recompute"] == (1.0 if exchange else cluster * 256 / d)


def test_widths_the_kernel_cannot_hold_raise():
    # C above 2048 with D above a block's 256 columns
    with pytest.raises(ValueError):
        tfa.forward_split(1, 1000, 250, 1024, 4096)
    # D above eight blocks' 256 columns
    with pytest.raises(ValueError):
        tfa.forward_split(1, 1000, 250, 2049, 64)
    # both go to the chunked kernel
    assert tfa.chunked_widths(1024, 4096) and tfa.chunked_widths(2049, 64)
    # wider C where D fits one block: every block computes the logits
    assert tfa.forward_split(1, 1000, 250, 256, 4096)["cluster"] == 16
    assert not tfa.chunked_widths(256, 4096)


BEYOND = (129, 256, 257, 300, 1024, 2040, 2048, 2049, 2100, 3072, 4096,
          5000)


@pytest.mark.parametrize("d", BEYOND)
def test_every_width_has_a_kernel(d):
    # each bf16 call above 128 runs the cluster kernel on forward_split's
    # plan or, exactly where no split fits, the chunked kernel, which needs
    # D above 256 (three 128-column chunks: its v buffers' reuse)
    for c in BEYOND + (64,):
        try:
            tfa.forward_split(1, 1000, 250, d, c)
            planned = True
        except ValueError:
            planned = False
        assert planned != tfa.chunked_widths(d, c), (d, c)
        if not planned:
            assert d > 256 and (d > 2048 or c > 2048)
