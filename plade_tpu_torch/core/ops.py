"""Tensor helpers standing in for JAX primitives PyTorch lacks.

* :func:`nonzero_static` is ``jnp.nonzero(x, size=, fill_value=)``: the
  indices of the true entries, in ascending order, cut or padded to a fixed
  size, computed on the device without a host sync.
* :func:`lexsort` is ``jnp.lexsort``: a stable sort by several keys, the
  last key primary, done as successive stable sorts from the least
  significant key.
* :func:`scalar` makes a 0-d float32 device tensor without a host copy.
"""
from __future__ import annotations

import torch


def scalar(x, device) -> torch.Tensor:
    """0-d float32 tensor on ``device`` from a tensor or a Python number.
    A number is filled in on the device: ``torch.tensor(x, device=...)``
    would copy from the host and wait for the device's queue."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def nonzero_static(mask: torch.Tensor, size: int, fill_value: int
                   ) -> torch.Tensor:
    """(size,) int64 indices of the true entries of 1-D ``mask`` in
    ascending order; rows past the number of true entries hold
    ``fill_value``."""
    m = mask.to(torch.int64)
    dest = torch.cumsum(m, 0) - m
    write = mask & (dest < size)
    out = torch.full((size + 1,), fill_value, dtype=torch.int64,
                     device=mask.device)
    src = torch.arange(mask.shape[0], device=mask.device)
    out.scatter_(0, torch.where(write, dest, size), torch.where(write, src,
                                                                fill_value))
    return out[:size]


def lexsort(keys) -> torch.Tensor:
    """Permutation sorting by ``keys[-1]``, then ``keys[-2]``, ...; equal
    keys keep their original order (``jnp.lexsort``)."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        perm = torch.sort(k[order], stable=True).indices
        order = order[perm]
    return order
