"""A value derived from parameter tensors, kept until any of them changes.

The one cache of the port for weights prepared from parameters (the DPT
tail's packed weights, a ``QuantLinear``'s int8 weight, the encoder's and
head's weights cast to the compute dtype under ``torch.inference_mode()``):
``Derived.get`` keys the value on each tensor's device, storage pointer,
version counter (an in-place update, such as ``load_state_dict`` or an
optimizer step, bumps it), shape and stride, plus an extra key such as a
compute dtype and whether inference mode is on, and computes it again when
the key changes. So a value made under inference mode (an inference tensor,
which autograd refuses to save) is handed out only under inference mode. A
write that bypasses the version counter (through ``.data``) is not seen.
Under tracing (``torch.compiler.is_compiling()``: ``torch.export``) a tensor
has no storage to key on, and an inference tensor keeps no version counter:
the value is computed and not kept.

Under ``utils/profiling.recording()`` each kept lookup counts
``derived/hit`` (the kept value handed out) or ``derived/miss`` (computed
and kept).
"""
from __future__ import annotations

from typing import Callable, Sequence, TypeVar

import torch

from distill_any_depth_tpu_torch.utils.profiling import count

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
        try:
            key = (extra, torch.is_inference_mode_enabled(),
                   *[(t.device, t.data_ptr(), t._version, t.shape, t.stride())
                     for t in tensors])
        except RuntimeError:  # an inference tensor: no version counter to key on
            return compute()
        if key == self._key:
            count("derived/hit", 1)
        else:
            count("derived/miss", 1)
            self._value = compute()
            self._key = key
        return self._value
