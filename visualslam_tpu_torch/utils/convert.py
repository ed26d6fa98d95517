"""State carried across from the JAX package.

The JAX package's NamedTuples (Features/Keypoints, LocalMap, TrackState,
KeyframeRef, BAProblem, ...) have the same fields in the same order as the
port's. `from_numpy` rebuilds one of the port's NamedTuples from such a
state fetched as numpy (e.g. `jax.tree_util.tree_map(np.asarray, state)`),
so both packages can start from identical state.
"""

from __future__ import annotations

import typing
from collections.abc import Mapping

import numpy as np
import torch


def _nested_types(cls) -> dict:
    """Field name -> NamedTuple type for the fields of cls that are
    NamedTuples themselves (Features.keypoints)."""
    hints = typing.get_type_hints(cls)
    return {k: v for k, v in hints.items()
            if isinstance(v, type) and issubclass(v, tuple)
            and hasattr(v, "_fields")}


def from_numpy(cls, arrays, device="cuda"):
    """Port NamedTuple `cls` from numpy arrays in the JAX field order.

    arrays: a mapping by field name, or a tuple (a JAX NamedTuple fetched
    as numpy is one); nested NamedTuples are converted the same way. Each
    leaf is copied into a tensor on `device` (the card unless the caller
    passes device="cpu") with its numpy dtype (bool, int32 and float32 stay
    as they are)."""
    if isinstance(arrays, Mapping):
        values = [arrays[name] for name in cls._fields]
    else:
        values = list(arrays)
        if len(values) != len(cls._fields):
            raise ValueError(f"{cls.__name__} has {len(cls._fields)} fields, "
                             f"got {len(values)} arrays")
    nested = _nested_types(cls)
    out = []
    for name, v in zip(cls._fields, values):
        if name in nested:
            out.append(from_numpy(nested[name], v, device))
        else:
            out.append(torch.tensor(np.asarray(v), device=device))
    return cls(*out)
