"""Host runtime components of the PyTorch port (native, built with g++)."""
