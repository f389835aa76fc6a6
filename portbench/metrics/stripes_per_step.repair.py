"""Stripes admitted per device step of the batcher: the worker's decodes."""

from portbench.readers import stripes_per_step as read  # noqa: F401
