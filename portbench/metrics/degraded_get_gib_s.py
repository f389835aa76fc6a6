"""Bytes of the degraded GETs completed in the window, per second, over all clients."""


def read(run):
    return run.window.gib_s()
