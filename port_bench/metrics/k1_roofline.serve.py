"""K1's share of its roofline in batch inference: the least time of every
``esf_torch::fused_bottleneck`` call in the traced window, from its shapes,
over the device time of the kernels the profiler links to those calls."""

from port_bench import formulas

OP = "esf_torch::fused_bottleneck"


def read(run):
    calls = run.trace.ops(lambda name: name == OP)
    device = sum(secs for _, secs in calls)
    if not calls or device <= 0:
        return None
    least = 0.0
    for evt, _ in calls:
        s = evt.input_shapes
        least += formulas.least_seconds(*formulas.k1(s[0], s[2], s[4], s[6],
                                                     s[8]))
    return 100.0 * least / device
