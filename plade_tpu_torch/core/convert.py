"""Carry state between ``plade_tpu`` (JAX) and this package, through numpy.

Containers are matched by class name and field name, so a JAX container
(or any NamedTuple with the same fields, holding arrays that ``np.asarray``
accepts) becomes the port's container of the same name.  Nothing here
imports JAX.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from .config import PladeConfig

_CONTAINER_MODULES = ("core.types", "geometry.obb", "match.matching",
                      "verify.penetration", "pipeline")


def _containers() -> dict:
    """Port NamedTuple classes by name (imported lazily: the pipeline
    modules import this package's core)."""
    out = {}
    for mod in _CONTAINER_MODULES:
        m = importlib.import_module(f"plade_tpu_torch.{mod}")
        for name, obj in vars(m).items():
            if isinstance(obj, type) and issubclass(obj, tuple) \
                    and hasattr(obj, "_fields"):
                out[name] = obj
    return out


def _is_container(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def from_numpy(obj, device="cpu"):
    """Port container (or tensor) from a container of arrays of the same
    class name; arrays go through ``np.asarray`` and keep their dtype."""
    if _is_container(obj):
        cls = _containers()[type(obj).__name__]
        return cls(**{f: from_numpy(getattr(obj, f), device)
                      for f in cls._fields})
    if isinstance(obj, (tuple, list)):
        return type(obj)(from_numpy(x, device) for x in obj)
    return torch.as_tensor(np.array(obj), device=device)


def to_numpy(obj):
    """The same container with every tensor as a numpy array."""
    if _is_container(obj):
        return type(obj)(*(to_numpy(x) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy(x) for x in obj)
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    return obj


def config_from(cfg) -> PladeConfig:
    """The port's PladeConfig from any object with the same dataclass
    fields (e.g. ``plade_tpu.core.config.PladeConfig``)."""
    return PladeConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(PladeConfig)})
