"""Bytes of lost units rebuilt into host memory in the window, per second."""


def read(run):
    return run.window.gib_s()
