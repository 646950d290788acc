"""Command-line entry points of the PyTorch port (:mod:`.serve`,
:mod:`.train`)."""
