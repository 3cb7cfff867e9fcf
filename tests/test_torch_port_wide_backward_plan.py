"""The split of the bf16 backward's cluster kernel (``csrc/
flash_attention_bwd.cu``, D or C above 128) that ``backward_cluster_split``
plans, over a grid of widths from 129 to 2048, D and C apart, with ragged N
and M: the cluster's size, the shared memory a block asks for, the query
tile, the ring, the grid, and the tensor-core work against the bound's. The
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
            # the least cluster whose 2 R warpgroups of 128 columns hold D
            # and C
            assert 256 * r >= max(_ceil(d, 8), _ceil(c, 8))
            assert r == 1 or 128 * r < max(_ceil(d, 8), _ceil(c, 8))
            assert plan["slices"] == 2 * r and plan["width"] == 256
            assert plan["keys"] == 64 and plan["per_sm"] == 1
            assert plan["blocks"] == r * -(-m // 64) * b
            assert plan["smem"] <= SMEM_LIMIT
            assert plan["smem"] == tfa.backward_cluster_smem_bytes(
                r, plan["queries"], plan["stages"])
            # 32-query tiles but where a cluster of 8's slots would not
            # fit; three stages where they fit
            assert plan["queries"] == (16 if r == 8 else 32)
            assert plan["stages"] in (2, 3)
            if plan["stages"] == 2:
                assert tfa.backward_cluster_smem_bytes(
                    r, plan["queries"], 3) > SMEM_LIMIT
            # each product once over the 2 R slices of 128 columns
            assert plan["recompute"] == pytest.approx(
                5 * 256 * r / (3 * _ceil(d, 8) + 2 * _ceil(c, 8)))
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
    # no recompute where D and C fill the 2 R slices
    if d == c:
        assert plan["recompute"] == 1.0
    # the grid at s3: 13 key blocks of 8 clips, R blocks each
    assert plan["blocks"] == 104 * cluster


@pytest.mark.parametrize("d", (129, 256, 1024, 2040, 2048, 2049, 2100, 3072,
                               4096))
def test_every_width_has_a_kernel(d):
    # each bf16 call above 128 runs the cluster kernel on its plan or,
    # exactly where no split fits, the chunked kernels
    for c in (8, 129, 256, 2048, 2049, 4096):
        try:
            tfa.backward_cluster_split(1, 1000, 250, d, c)
            planned = True
        except ValueError:
            planned = False
        assert planned != tfa.backward_chunked_widths(d, c), (d, c)
        assert planned == (max(_ceil(d, 8), _ceil(c, 8)) <= 2048)


def test_widths_the_kernel_cannot_hold_raise():
    for d, c in ((2056, 64), (64, 2056), (3072, 3072)):
        with pytest.raises(ValueError):
            tfa.backward_cluster_split(1, 1000, 250, d, c)
    # every width the forward's cluster kernel holds up to 2048 in both
    for d, c in itertools.product((129, 600, 1024, 2048), repeat=2):
        tfa.forward_split(1, 1000, 250, d, c)
        tfa.backward_cluster_split(1, 1000, 250, d, c)
