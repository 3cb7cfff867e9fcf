"""K2-bwd's share of its roofline in training: the least time of the
backward of every ``esf_torch::flash_attention`` call in the traced window
(from the forward call's shapes), over the device time of the kernels the
profiler links to K2's autograd backward node."""

from port_bench import formulas

OP = "esf_torch::flash_attention"
NODE = "AttentionFunctionBackward"


def read(run):
    nodes = run.trace.ops(lambda name: name.endswith(NODE))
    device = sum(secs for _, secs in nodes)
    calls = run.trace.ops(lambda name: name == OP)
    if not nodes or not calls or device <= 0:
        return None
    least = sum(formulas.least_seconds(*formulas.k2_backward(
        *evt.input_shapes[:3])) for evt, _ in calls)
    return 100.0 * least / device
