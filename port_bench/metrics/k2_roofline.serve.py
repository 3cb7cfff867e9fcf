"""K2's share of its roofline in batch inference: the least time of every
``esf_torch::flash_attention`` call in the traced window (the serving path
keeps no log-sum-exp), from its shapes, over the device time of the
kernels the profiler links to those calls."""

from port_bench import formulas

OP = "esf_torch::flash_attention"


def read(run):
    calls = run.trace.ops(lambda name: name == OP)
    device = sum(secs for _, secs in calls)
    if not calls or device <= 0:
        return None
    least = sum(formulas.least_seconds(*formulas.k2(*evt.input_shapes[:3],
                                                    with_lse=False))
                for evt, _ in calls)
    return 100.0 * least / device
