"""Verify-then-time sweeps of the port's kernel variants."""
