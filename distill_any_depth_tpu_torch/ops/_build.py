"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds. Libraries are
named by a hash of their source and of the shared headers in ``csrc/``
(``*.cuh``), and go to ``build/`` at the repository root, so an edited
source or header rebuilds and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from distill_any_depth_tpu_torch.utils.profiling import count, span

__all__ = ["SOURCES", "build_all", "load"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"

# library name -> source file in csrc/
SOURCES = {
    "flash_attention": "flash_attention.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "flash_attention_bias": "flash_attention_bias.cu",
    "flash_attention_banded": "flash_attention_banded.cu",
    "flash_attention_bias_bwd": "flash_attention_bias_bwd.cu",
    "flash_attention_banded_bwd": "flash_attention_banded_bwd.cu",
    "dpt_tail": "dpt_tail.cu",
    "kth_select": "kth_select.cu",
    "w8a8_matmul": "w8a8_matmul.cu",
    "swiglu_gate": "swiglu_gate.cu",
}

CUDA_NVCC = "/usr/local/cuda/bin/nvcc"  # used when nvcc is not on PATH

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or CUDA_NVCC
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return found


def _target(name: str) -> Path:
    sha = hashlib.sha256((_CSRC / SOURCES[name]).read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        sha.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{sha.hexdigest()[:12]}.so"


def build_all(names=tuple(SOURCES)) -> dict[str, str]:
    """Compile each library in ``names`` that is not built yet, one ``nvcc``
    process per source, all started together. Returns each new build's
    compiler log (register and shared-memory use from ``-Xptxas -v``);
    raises with the log of every failed build. Under
    ``utils/profiling.recording()`` the span ``kernels/build`` covers the
    concurrent ``nvcc`` runs of a call that builds, and ``kernels/built``
    counts the libraries built."""
    todo = [name for name in names if not _target(name).exists()]
    if not todo:
        return {}
    with span("kernels/build"):
        return _build(todo)


def _build(names) -> dict[str, str]:
    jobs = {}
    for name in names:
        out = _target(name)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(tmp), str(_CSRC / SOURCES[name]),
        ]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = proc, tmp, out
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {SOURCES[name]}:\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
            count("kernels/built", 1)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(_target(name)))
    return lib
