"""The backward of the scan kernels (K6, K7): differentiate a scan written
as tensor code, recomputed from the inputs a kernel's autograd function
saved.  The reference trains its models through XLA's autodiff of their
chunked scans and has no backward kernel; this is that autodiff's
counterpart.

On meta tensors under a cost counter (the dry-run) the backward runs
nothing: a step-by-step scan over a production sequence would dispatch
millions of operations to be counted.  :func:`meta_grads` gives the
gradients' shapes and counts the plain backward by formula."""

from __future__ import annotations

import torch

from repro_torch.launch import costanalysis

#: The plain backward's FLOPs over one forward's: the scan recomputed
#: twice (by :func:`scan_grads`, then chunk by chunk under checkpoint) and
#: differentiated, about twice a forward.
BACKWARD_WORK = 4.0


def counting_meta(inputs) -> bool:
    """Whether a backward's saved ``inputs`` are meta tensors under a cost
    counter."""
    return inputs[0].device.type == "meta" and \
        costanalysis.active() is not None


def meta_grads(name: str, inputs, needs, cost) -> list:
    """The gradients of a scan's ``inputs`` as empty meta tensors (``None``
    where ``needs`` says the input takes none), the plain backward counted
    under ``name``: BACKWARD_WORK x the forward's FLOPs, and twice its
    bytes (the saved inputs and the outputs' gradients read, the inputs'
    gradients written).  ``cost`` is the forward's (FLOPs, bytes)."""
    flops, n_bytes = cost
    costanalysis.add_kernel(name, BACKWARD_WORK * flops, 2.0 * n_bytes)
    return [torch.empty_like(x) if x is not None and need else None
            for x, need in zip(inputs, needs)]


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
