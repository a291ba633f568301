"""A value derived from parameter tensors, kept until any of them changes.

The one cache of the port for weights prepared from parameters (the DPT
tail's packed weights, a ``QuantLinear``'s int8 weight): ``Derived.get``
keys the value on each tensor's device, storage pointer, version counter
(an in-place update, such as ``load_state_dict`` or an optimizer step,
bumps it), shape and stride, plus an extra key such as a compute dtype,
and computes it again when the key changes. Under tracing
(``torch.compiler.is_compiling()``: ``torch.export``) a tensor has no
storage to key on: the value is computed in the traced graph and not kept.
"""
from __future__ import annotations

from typing import Callable, Sequence, TypeVar

import torch

__all__ = ["Derived"]

T = TypeVar("T")


class Derived:
    """One kept value: ``cache.get(tensors, compute, extra)`` returns
    ``compute()``, computed at the first call and again after any of
    ``tensors`` or ``extra`` changed."""

    __slots__ = ("_key", "_value")

    def __init__(self):
        self._key = None
        self._value = None

    def get(self, tensors: Sequence[torch.Tensor], compute: Callable[[], T], extra=None) -> T:
        if torch.compiler.is_compiling():
            return compute()
        key = (extra, *[(t.device, t.data_ptr(), t._version, t.shape, t.stride())
                        for t in tensors])
        if key != self._key:
            self._value = compute()
            self._key = key
        return self._value
