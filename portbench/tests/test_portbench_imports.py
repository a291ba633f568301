"""Nothing under ``portbench/`` imports ``jax``, ``jaxlib``, ``flax`` or the
JAX package, compared by whole top-level name (the port's name begins with
the JAX package's); ``portbench/reference/`` imports nothing of the port
either. And a run refuses to report once such a module is loaded."""
from __future__ import annotations

import ast
import os
import sys

import pytest

from portbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "distill_any_depth_tpu"}
PORT = "distill_any_depth_tpu_torch"


def _sources(sub=""):
    for top, _, files in os.walk(os.path.join(spec.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(top, f)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, spec.ROOT))
def test_no_jax_import(path):
    assert not set(_imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, spec.ROOT))
def test_reference_imports_nothing_of_the_port(path):
    assert not set(_imported(path)) & (FORBIDDEN | {PORT})


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + "_probe", sys)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "distill_any_depth_tpu.configs", sys)
    assert run.loaded_forbidden() == ["distill_any_depth_tpu"]
