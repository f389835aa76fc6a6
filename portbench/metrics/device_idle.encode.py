"""The share of the traced window with no kernel and no copy on the card, in %."""

from portbench.readers import device_idle as read  # noqa: F401
