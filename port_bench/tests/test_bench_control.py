"""The control, the reference computed in float8 in the program's place,
comes out not correct under each cell's limits: at a tiny size on the CPU,
and (marked ``chip``) at the cell's own size on the card."""

import pytest
import torch

from port_bench import manifest, run
from port_bench.tests import tiny

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_a_tiny_size(cell):
    spec, _, _ = manifest.cell_files(cell)
    d = tiny.driver(spec["config"], spec["traffic"], limits=spec["limits"])
    d.prepare()
    assert not run.correct(d.control())


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec, mix, config = manifest.cell_files(cell)
    for seed in (101, 202, 303):
        d = manifest.driver_class(mix["kind"])(spec, mix, config, seed,
                                               torch.device("cuda"))
        d.prepare()
        assert not run.correct(d.control())
        del d
        torch.cuda.empty_cache()
