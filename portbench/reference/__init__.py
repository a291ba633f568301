"""The benchmark's plain float32 reference. It imports torch, numpy and cv2
alone: nothing of the program under test and nothing of the JAX package.

A configuration names its pieces by module: each model entry's
``reference`` (``dinov2_dpt``: Depth-Anything-V2), and a training
configuration's ``reference`` step (``distill``: the distillation loss
stack and the clipped Adam update). ``images`` holds the preprocessing and
the NYU decode. A later configuration that needs another model or step adds
a module here and names it; nothing here lists them.
"""
from __future__ import annotations

import importlib
import re

__all__ = ["module"]


def module(name: str):
    """The reference module ``portbench/reference/<name>.py``."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"not a reference module name: {name!r}")
    return importlib.import_module(f"portbench.reference.{name}")
