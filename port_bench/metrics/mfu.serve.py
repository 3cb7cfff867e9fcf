"""Model FLOP utilisation of batch inference: the reference's operations
a clip (forward, at the cell's crop) times the window's clips/s, over the
card's dense bf16 peak."""

from port_bench import formulas


def read(run):
    d = run.driver
    flops = formulas.model_flops_per_clip(d.arch, d.crop, False)
    rate = run.window.units / run.window.seconds
    return 100.0 * flops * rate / formulas.PEAK_FLOPS
