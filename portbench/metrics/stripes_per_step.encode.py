"""Stripes admitted per device step of the batcher: the cell's encodes (RS encode, or LRC rows applied)."""

from portbench.readers import stripes_per_step as read  # noqa: F401
