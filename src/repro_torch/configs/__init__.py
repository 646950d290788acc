"""Configuration catalogs of the PyTorch port (:mod:`.catalog`: the
lock-simulation sweep specs)."""
