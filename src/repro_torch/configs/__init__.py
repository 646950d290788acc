"""Configuration of the PyTorch port: the model schema (:mod:`.base`) and
the catalogs (:mod:`.catalog`: the registered architectures and the
lock-simulation sweep specs)."""
