"""The split of the bf16 backward's cluster kernel (``csrc/
flash_attention_bwd.cu``, D or C above 128) that ``backward_cluster_split``
plans, over a grid of widths from 129 to 2048 and beyond, D and C apart,
with ragged N and M: the column groups, the cluster's size, the shared
memory a block asks for, the query tile, the rings, the exchange's rounds,
the grid, and the tensor-core work against the bound's. The
kernel itself runs only on the card; ``chip_smoke.py`` checks the plan's
bytes against the launched kernel's attribute there."""

import itertools

import pytest

from efficient_slowfast_tpu_torch.ops.kernels import flash_attention as tfa

SMEM_LIMIT = 232448  # dynamic shared memory of an H100 block
WIDTHS = (8, 64, 129, 136, 200, 256, 257, 300, 512, 600, 700, 1000, 1024,
          1100, 1536, 2040, 2048)
# (B, N, M): ragged against the query tiles and the 64-key blocks
ROWS = ((1, 1000, 250), (8, 3136, 784), (16, 1568, 392))


def _ceil(x, to):
    return -(-x // to) * to


@pytest.mark.parametrize("d", WIDTHS)
def test_split_fits_the_kernel(d):
    for c in WIDTHS:
        if max(d, c) <= 128:
            continue
        for b, n, m in ROWS:
            plan = tfa.backward_cluster_split(b, n, m, d, c)
            r = plan["cluster"]
            assert plan["kernel"] == "cluster" and r in (1, 2, 4, 8)
            assert plan["groups"] == 1 and plan["extra_stages"] == 0
            # the least cluster whose 2 R warpgroups of 128 columns hold D
            # and C
            assert 256 * r >= max(_ceil(d, 8), _ceil(c, 8))
            assert r == 1 or 128 * r < max(_ceil(d, 8), _ceil(c, 8))
            _hold(plan, b, m, d, c)
            # 32-query tiles but where a cluster of 8's slots would not
            # fit; three stages where they fit; one round
            assert plan["queries"] == (16 if r == 8 else 32)
            assert plan["rounds"] == 1
            # each product once over the 2 R slices of 128 columns
            assert plan["recompute"] == pytest.approx(
                5 * 256 * r / (3 * _ceil(d, 8) + 2 * _ceil(c, 8)))


def _hold(plan, b, m, d, c):
    """The plan's groups and slices cover D and C, its bytes fit a block
    and are the kernel's arithmetic, and the two logits products run once
    a column group."""
    dp, cp = _ceil(d, 8), _ceil(c, 8)
    r, g = plan["cluster"], plan["groups"]
    slices = -(-max(dp, cp) // 256)
    assert 1 <= r <= 8 and r * g >= slices and r * (g - 1) < slices
    assert g == max(1, -(-slices // 8))
    assert plan["slices"] == 2 * r * g and plan["width"] == 256
    assert plan["keys"] == 64 and plan["per_sm"] == 1
    assert plan["blocks"] == g * r * -(-m // 64) * b
    assert plan["smem"] <= SMEM_LIMIT
    assert plan["smem"] == tfa.backward_cluster_smem_bytes(
        r, plan["queries"], plan["stages"], plan["extra_stages"],
        plan["rounds"])
    assert plan["extra_stages"] == (2 if g > 1 else 0)
    assert plan["stages"] in (2, 3) and plan["rounds"] in (1, 2)
    assert plan["queries"] in (16, 32)
    if plan["stages"] == 2:
        assert tfa.backward_cluster_smem_bytes(
            r, plan["queries"], 3, plan["extra_stages"],
            plan["rounds"]) > SMEM_LIMIT
    if plan["rounds"] == 2:
        assert all(tfa.backward_cluster_smem_bytes(
            r, rows, 2, plan["extra_stages"], 1) > SMEM_LIMIT
            for rows in (16, 32))
    # the logits G times: each block's own slice and its extra slices r +
    # R j (j != g) of D and of C, beside dV, dK and dQ once
    s_d, s_c = -(-dp // 256), -(-cp // 256)
    extra = sum(1 for gg in range(g) for rr in range(r) for j in range(g)
                for count in (s_d, s_c) if j != gg and rr + r * j < count)
    assert plan["logits"] == g
    assert plan["recompute"] == pytest.approx(
        (5 * g * r + extra) * 256 / (3 * dp + 2 * cp))
    assert plan["recompute"] >= 1.0


@pytest.mark.parametrize("d,c,cluster,queries,stages", [
    (256, 256, 1, 32, 3),      # I3D-NLN's s3: one block a key block
    (512, 512, 2, 32, 3),      # s4: a cluster of two
    (1024, 1024, 4, 32, 2),    # a res5 block: four
    (2048, 2048, 8, 16, 3),    # eight, 16-query tiles
    (64, 2048, 8, 16, 3),      # narrow D, wide C: C sets the cluster
    (2048, 64, 8, 16, 3),
])
def test_split_at_the_zoo_widths(d, c, cluster, queries, stages):
    plan = tfa.backward_cluster_split(8, 3136, 784, d, c)
    assert (plan["cluster"], plan["queries"], plan["stages"]) == (
        cluster, queries, stages)
    assert plan["groups"] == 1 and plan["logits"] == 1
    # no recompute where D and C fill the 2 R slices
    if d == c:
        assert plan["recompute"] == 1.0
    # the grid at s3: 13 key blocks of 8 clips, R blocks each
    assert plan["blocks"] == 104 * cluster


@pytest.mark.parametrize("d", (129, 256, 1024, 2040, 2048, 2049, 2100, 3072,
                               4096))
def test_every_width_has_a_kernel(d):
    # each bf16 call above 128 runs the cluster kernel on its plan, at any
    # width: one column group up to 2048, ceil(S / 8) groups of S
    # 256-column slices beyond
    for c in (8, 129, 256, 2048, 2049, 4096):
        plan = tfa.backward_cluster_split(1, 1000, 250, d, c)
        _hold(plan, 1, 250, d, c)
        assert (plan["groups"] == 1) == (max(_ceil(d, 8), _ceil(c, 8))
                                         <= 2048)
        assert tfa.backward_split(1, 1000, 250, d, c) == plan


def test_widths_the_kernel_cannot_hold_raise():
    # no kernel holds an empty width
    for d, c in ((0, 256), (256, 0)):
        with pytest.raises(ValueError):
            tfa.backward_cluster_split(1, 1000, 250, d, c)
    # D or C beyond 2048: two column groups
    for d, c in ((2056, 64), (64, 2056), (3072, 3072)):
        assert tfa.backward_cluster_split(1, 1000, 250, d, c)["groups"] == 2
    assert not hasattr(tfa, "backward_chunked_widths")
    # every width the forward's cluster kernel holds, in both
    for d, c in itertools.product((129, 600, 1024, 2048, 3072), repeat=2):
        tfa.forward_split(1, 1000, 250, d, c)
        tfa.backward_cluster_split(1, 1000, 250, d, c)


BEYOND = (129, 256, 257, 300, 1024, 2040, 2048, 2049, 2100, 3072, 4096,
          5000)


@pytest.mark.parametrize("d", BEYOND)
def test_every_wide_pair_has_a_plan(d):
    # BEYOND x BEYOND, as the forward's plan file holds it
    for c in BEYOND:
        _hold(tfa.backward_cluster_split(1, 1000, 250, d, c), 1, 250, d, c)


@pytest.mark.parametrize("d,c", [(256, 16448), (64, 20000), (8192, 8192)])
def test_the_widest_have_a_plan(d, c):
    for b, n, m in ROWS:
        plan = tfa.backward_cluster_split(b, n, m, d, c)
        _hold(plan, b, m, d, c)
        assert plan["logits"] == -(-max(d, c) // 2048)
