"""Carry parameter objects of the JAX package (`sdr_receiver_dvb_t2_tpu`)
into this package without importing it.

The two packages define the same dataclasses and enums (`dvbt2/params.py`)
as separate classes, so a `CodeRate.C2_3` of one is not equal to the
other's and must never reach the other's caches.  Arrays (samples, LLRs, TS
bytes, tracking state) cross as numpy and need nothing; parameter objects
cross through `params_from_reference`, by field and enum *name*.
"""
from __future__ import annotations

import dataclasses
import enum

from ..dvbt2 import params as _params


def from_reference(v):
    """One value of the JAX package -> the port's: an enum member by class
    and member name, a parameter dataclass by `params_from_reference`, a
    tuple element by element; numbers, strings and None as they are."""
    if isinstance(v, enum.Enum):
        own = getattr(_params, type(v).__name__, None)
        if not (isinstance(own, type) and issubclass(own, enum.Enum)):
            raise TypeError(f"no enum {type(v).__name__} in dvbt2.params")
        return own[v.name]
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return params_from_reference(v)
    if isinstance(v, tuple):
        return tuple(from_reference(x) for x in v)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"cannot carry a {type(v).__name__} across packages")


def params_from_reference(obj):
    """A JAX-package `T2Params` / `PLPParams` (any dataclass of enums,
    numbers, strings, None and tuples of those) -> the port's dataclass of
    the same class name with the same field values, enums matched by
    name.  An object that is already the port's is returned as it is."""
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        raise TypeError("expected a parameter dataclass instance, got "
                        f"{type(obj).__name__}")
    own = getattr(_params, type(obj).__name__, None)
    if own is None or not dataclasses.is_dataclass(own):
        raise TypeError(f"no dataclass {type(obj).__name__} in dvbt2.params")
    if isinstance(obj, own):
        return obj
    return own(**{f.name: from_reference(getattr(obj, f.name))
                  for f in dataclasses.fields(obj) if f.init})
