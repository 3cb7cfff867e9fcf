"""The host's time inside the serving call before it returns, before the
scores are copied: the mean over the window's requests (their sum spans
the window)."""


def read(run):
    n = run.window.iterations
    return 1e3 * sum(run.driver.enqueue[:n]) / n
