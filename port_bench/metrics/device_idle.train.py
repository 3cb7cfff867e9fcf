"""The device's idle share of the traced window: one less the union of
its kernels', copies' and fills' intervals over the window's length."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
