"""The 95th percentile of every encode call in the window, start to parity in the stripe."""


def read(run):
    return run.window.p95_ms()
