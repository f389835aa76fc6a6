"""User payload bytes of the encode calls completed in the window, per second."""


def read(run):
    return run.window.gib_s()
