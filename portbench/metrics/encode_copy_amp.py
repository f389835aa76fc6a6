"""Bytes the encode calls copied between host and card, per user byte."""

from portbench.readers import copy_amp as read  # noqa: F401
