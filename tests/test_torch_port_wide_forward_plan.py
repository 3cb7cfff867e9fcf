"""The split of the bf16 cluster kernel (``csrc/flash_attention.cu``, D or
C above 128) that ``forward_split`` plans, over a grid of widths from 129
to 2048 and beyond, D and C apart, with ragged N and M: the column groups,
the cluster's size and pushers, their slices of D and C, the shared
memory a block asks for, the grid, and the logit work against the
bound's. The kernel itself runs only on the card;
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
        _hold(tfa.forward_split(b, n, m, d, c), b, n, d, c)


def _hold(plan, b, n, d, c):
    """The plan's slices and groups cover D and C, its bytes fit a block
    and are the kernel's arithmetic, and it computes q kᵀ at most
    ceil(C / 2048) times (its column groups), padding aside, but where D
    and C fit one slice and one group: there each of R blocks computes
    it (faster on the card than one block's broadcast)."""
    dp, cp = _ceil(d, 64), _ceil(c, 64)
    r, p, g = plan["cluster"], plan["pushers"], plan["groups"]
    assert r in (1, 2, 4, 8) and 1 <= p <= r
    # G column groups of R blocks, each up to 256 output columns
    assert g == -(-cp // 2048)
    assert plan["c_slice"] % 64 == 0 and plan["c_slice"] * r * g >= cp
    assert plan["c_slice"] <= plan["width"] <= 256
    assert plan["width"] == next(w for w in (64, 128, 256)
                                 if plan["c_slice"] <= w)
    # one slice of D, one group: every block computes the logits, no
    # cluster
    alone = dp <= 256 and g == 1
    assert plan["exchange"] == (r > 1 and not alone)
    # the least cluster that holds the pushers and a group's columns
    assert r == 1 or max(1 if alone else p, -(-cp // (256 * g))) > r // 2
    # P pushers of `slices` 256-column slices cover D, each holds some of
    # it; without the exchange each block holds all of D
    assert plan["d_slice"] == 256  # the kernel's unrolled logit chain
    cover = (1 if alone else p) * plan["slices"] * 256
    assert cover >= dp and cover - plan["slices"] * 256 < dp
    assert not alone or p == r
    # q resident up to D = 2048 (one slice a pusher), streamed beyond
    assert plan["stream"] == (dp > 2048) == (plan["slices"] > 1)
    assert plan["blocks"] == g * r * -(-n // plan["rows"]) * b
    assert plan["smem"] <= SMEM_LIMIT
    mode = 0 if not plan["exchange"] else 2 if plan["stream"] else 1
    assert plan["smem"] == tfa.cluster_smem_bytes(
        mode, plan["width"], plan["keys"], plan["k_stages"],
        plan["v_stages"], p, plan["rounds"])
    # the exchange's tiles are 32 keys; deferred (q resident, one round)
    # it runs S two tiles ahead, which needs three k stages; q streamed
    # beside k takes two stages of each
    assert plan["keys"] == (32 if plan["exchange"] else 64)
    assert plan["rounds"] in (1, 2) and (mode or plan["rounds"] == 1)
    assert 2 <= plan["v_stages"] <= plan["k_stages"] <= 3
    if mode == 1 and plan["rounds"] == 1:
        assert plan["k_stages"] == 3
    if mode == 2:
        assert plan["k_stages"] == plan["v_stages"] == 2
    # q kᵀ once a column group, padding aside (R times without the
    # exchange); the padding is the zero columns of the pushers' slices
    if alone:
        assert plan["recompute"] == r and c <= 2048 and d <= 256
    else:
        assert plan["recompute"] == g <= -(-c // 2048)
    assert plan["padded"] == pytest.approx(cover / d)
    assert plan["padded"] >= 1.0


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
    assert plan["groups"] == 1 and plan["d_slice"] == 256
    assert not plan["stream"]
    # once where the blocks split D in 256-column slices or one block holds
    # D = 256; R times where every block computes it whole
    assert plan["recompute"] == (1 if exchange else cluster)
    assert plan["padded"] == max(256 / d, 1.0)


def test_widths_the_kernel_cannot_hold_raise():
    # no kernel holds an empty width
    for d, c in ((0, 64), (64, 0), (-1, 256)):
        with pytest.raises(ValueError):
            tfa.forward_split(1, 1000, 250, d, c)
    # every positive width has a split: C above 2048 with D above 256, D
    # above 2048, and C above 2048 with D up to 256 (eight blocks a group)
    for d, c in ((1024, 4096), (2049, 64), (256, 4096)):
        plan = tfa.forward_split(1, 1000, 250, d, c)
        assert plan["recompute"] == -(-c // 2048)
    assert tfa.forward_split(1, 1000, 250, 256, 4096)["cluster"] == 8
    assert not hasattr(tfa, "chunked_widths")


BEYOND = (129, 256, 257, 300, 1024, 2040, 2048, 2049, 2100, 3072, 4096,
          5000)


@pytest.mark.parametrize("d", BEYOND)
def test_every_width_has_a_kernel(d):
    # each bf16 call above 128 runs the cluster kernel on forward_split's
    # plan, at any D and C
    for c in BEYOND + (64,):
        _hold(tfa.forward_split(1, 1000, 250, d, c), 1, 1000, d, c)


@pytest.mark.parametrize("d,c", [(256, 16448), (64, 20000), (8192, 8192)])
def test_the_widest_have_a_plan(d, c):
    # widths a planner of at most 64 blocks a tile cannot split (256,
    # 16448), (64, 20000), and D streamed over 32 slices (8192)
    for b, n, m in ROWS:
        _hold(tfa.forward_split(b, n, m, d, c), b, n, d, c)
