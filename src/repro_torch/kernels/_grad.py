"""The backward of a kernel that has none of its own: the gradient of its
plain version, recomputed from the forward pass's saved inputs.

The reference package trains through its plain versions (its Pallas
kernels have no ``custom_vjp``), so the port keeps the hand-written
kernel in the forward pass and differentiates the plain version in the
backward pass (``flash_attention._FlashAttentionFn``,
``ssd._SSDScanFn``).
"""
from __future__ import annotations

import torch
from torch.profiler import record_function


def plain_backward(name, plain, inputs, needs_grad, grad_out, **kwargs):
    """The gradients of ``plain(*inputs, **kwargs)`` against ``grad_out``
    for each input flagged in ``needs_grad`` (None for the others), each
    in its input's own dtype.  ``name`` labels the work in a
    ``torch.profiler`` trace."""
    with torch.enable_grad(), record_function(name):
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(inputs, needs_grad)]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        if not wanted:
            return (None,) * len(leaves)
        out = plain(*leaves, **kwargs)
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in leaves)
