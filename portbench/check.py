"""The comparison that decides ``correct``: each number that a driver's
``compare`` gives (what the timed path produced against the plain float32
reference on the same inputs, ``portbench/drivers/``) beside the limit that
the cell's ``portbench/limits/<workload>.json`` sets for it. The reference
runs after the window, once the program's state is freed, on the run's
device with TF32 off (``fp32``)."""
from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["fp32", "judge"]


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each limited number beside its limit (the cell's
    limits name the numbers compared; one that the run did not produce is
    an error of the cell's files)."""
    checks = {}
    for name, limit in limits.items():
        if name not in numbers:
            raise KeyError(f"the run produced no {name!r} to compare")
        checks[name] = {"value": numbers[name], "limit": limit}
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values()), checks


@contextlib.contextmanager
def fp32():
    """True float32 matrix products and convolutions (no TF32)."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
