"""The examples of the PyTorch port, each run with ``python -m
repro_torch.examples.<name>``: :mod:`.quickstart`, :mod:`.train_resume`,
:mod:`.serve_continuous_batching` (on the card unless ``--device cpu``)
and :mod:`.elastic_hot_spares` (host-only)."""
