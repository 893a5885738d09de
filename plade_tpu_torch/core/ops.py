"""Tensor helpers standing in for JAX primitives PyTorch lacks, and for
``jax.vmap``.

* :func:`nonzero_static` is ``jnp.nonzero(x, size=, fill_value=)``: the
  indices of the true entries, in ascending order, cut or padded to a fixed
  size, computed on the device without a host sync.
* :func:`lexsort` is ``jnp.lexsort``: a stable sort by several keys, the
  last key primary, done as successive stable sorts from the least
  significant key.
* :func:`scalar` makes a 0-d float32 device tensor without a host copy.
* :func:`index_sum` is ``index_add_`` along the first axis that sums in
  the same order on every run, on the card too.

Both sorts work along the last axis, over any leading axes.  The pipeline
carries a leading axis of pairs (or clouds) where the reference vmaps:
:func:`take` is the per-pair gather, :func:`per_pair` a per-pair scalar,
and :func:`lift` / :func:`drop` add and remove the axis for the
single-pair entries, which are the one-pair call of the batched code.
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


def per_pair(x, P: int, device) -> torch.Tensor:
    """(P,) float32 tensor on ``device`` from a Python number, a one-element
    tensor or a (P,) tensor."""
    x = scalar(x, device).reshape(-1)
    return x.expand(P) if x.shape[0] == 1 else x


def nonzero_static(mask: torch.Tensor, size: int, fill_value: int
                   ) -> torch.Tensor:
    """(..., size) int64 indices of the true entries of ``mask`` (...,
    n) along its last axis, in ascending order; entries past the number of
    true entries hold ``fill_value``."""
    m = mask.to(torch.int64)
    dest = torch.cumsum(m, -1) - m
    write = mask & (dest < size)
    out = torch.full(mask.shape[:-1] + (size + 1,), fill_value,
                     dtype=torch.int64, device=mask.device)
    src = torch.arange(mask.shape[-1], device=mask.device).expand(mask.shape)
    out.scatter_(-1, torch.where(write, dest, size),
                 torch.where(write, src, fill_value))
    return out[..., :size]


def index_sum(out: torch.Tensor, index: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """``out.index_add_(0, index, values)``, the rows of ``values`` that
    share an index added in the same order on every run.  On the card
    ``index_add_`` adds with atomics, in whatever order the threads reach
    them, so a float sum's last bits vary from run to run;
    ``index_put_(accumulate=True)`` sorts the indices (stably) and adds
    each index's rows in that order.  On the CPU ``index_add_`` already
    adds them in index order."""
    if out.is_cuda:
        return out.index_put_((index,), values, accumulate=True)
    return out.index_add_(0, index, values)


def lexsort(keys) -> torch.Tensor:
    """Permutation along the last axis sorting by ``keys[-1]``, then
    ``keys[-2]``, ...; equal keys keep their original order
    (``jnp.lexsort``)."""
    k0 = keys[0]
    order = torch.arange(k0.shape[-1], device=k0.device).expand(k0.shape)
    for k in keys:
        perm = torch.sort(torch.gather(k, -1, order), stable=True).indices
        order = torch.gather(order, -1, perm)
    return order


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[p, idx[p]]`` for every pair p: x (P, M, *f), idx (P, *k) integer
    -> (P, *k, *f).  One gather for all pairs (one plain index for one
    pair)."""
    P = x.shape[0]
    if P == 1:
        return x[0][idx[0]][None]
    k, f = idx.shape[1:], x.shape[2:]
    flat = idx.reshape(P, -1).to(torch.int64)
    n = flat.shape[1]
    if f:
        flat = flat.reshape((P, n) + (1,) * len(f)).expand((P, n) + f)
    return torch.gather(x, 1, flat).reshape((P,) + k + f)


def flat_rows(idx: torch.Tensor, width: int) -> torch.Tensor:
    """Indices (P, ...) into rows of ``width`` made indices into the
    flattened (P * width) buffer, flattened (no offset for one pair)."""
    P = idx.shape[0]
    if P == 1:
        return idx.reshape(-1)
    offs = torch.arange(P, device=idx.device) * width
    return (idx + offs.reshape((P,) + (1,) * (idx.dim() - 1))).reshape(-1)


def tree_map(f, x):
    """``f`` applied to every tensor of ``x`` (a tensor, a NamedTuple or a
    tuple or list of them; numbers, strings and None pass unchanged)."""
    if x is None or isinstance(x, (int, float, bool, str)):
        return x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(f, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(f, v) for v in x)
    return f(x)


def lift(x):
    """A leading axis of one pair added to every tensor of ``x`` (a tensor,
    a NamedTuple or a tuple of them; numbers and None pass)."""
    return tree_map(lambda t: t[None], x)


def drop(x):
    """The leading axis of one pair removed from every tensor of ``x``."""
    return tree_map(lambda t: t[0], x)
