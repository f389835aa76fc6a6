"""parallel (the sharded codec step) of the PyTorch port; see the package docstring."""
