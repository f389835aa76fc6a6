"""Timing helpers of the PyTorch port."""
