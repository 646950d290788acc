"""Policy registries (:mod:`.policy`), the batched simulator (:mod:`.xdes`)
and its streamed sweep (:mod:`.stream`) of the PyTorch port, with its copies
of the threaded mutable lock (:mod:`.mutlock`, :mod:`.atomic`,
:mod:`.oracle`, :mod:`.waitpolicy`) and of the spinning-window controller
(:mod:`.window`)."""
