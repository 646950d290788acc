"""Policy registries (:mod:`.policy`) and the batched simulator
(:mod:`.xdes`) of the PyTorch port."""
