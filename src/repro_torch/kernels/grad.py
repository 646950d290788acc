"""The backward of the scan kernels (K6, K7): differentiate a scan written
as tensor code, recomputed from the inputs a kernel's autograd function
saved.  The reference trains its models through XLA's autodiff of their
chunked scans and has no backward kernel; this is that autodiff's
counterpart."""

from __future__ import annotations

import torch


def scan_grads(scan, inputs, needs, grads):
    """The gradients of ``scan(*inputs)``'s outputs, weighted by ``grads``
    (``None`` where an output got no gradient), for each input: ``None``
    where ``needs`` says the input takes none (or it is ``None``).  ``scan``
    is recomputed under autograd from detached inputs, then
    ``torch.autograd.grad`` runs over it."""
    with torch.enable_grad():
        leaves = [None if x is None else x.detach().requires_grad_(need)
                  for x, need in zip(inputs, needs)]
        outs = scan(*leaves)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wrt = [x for x in leaves if x is not None and x.requires_grad]
        if not pairs or not wrt:
            return [None] * len(inputs)
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
    return [next(got) if x is not None and x.requires_grad else None
            for x in leaves]
