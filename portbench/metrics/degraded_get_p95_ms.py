"""The 95th percentile of every degraded GET in the window, on the client side."""


def read(run):
    return run.window.p95_ms()
