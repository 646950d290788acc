"""Command-line drivers of the PyTorch port (:mod:`.serve`)."""
