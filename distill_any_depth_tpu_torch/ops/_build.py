"""Build, load and launch the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds. Libraries are
named by a hash of their source and of the shared headers in ``csrc/``
(``*.cuh``), and go to ``build/`` at the repository root, so an edited
source or header rebuilds and an unchanged one is reused.

Every entry point is called through one ``Kernel``: its argument types
from one kind string, the launch under the first tensor's device with the
current stream appended last, the error check, and the count
``kernels/<name>`` (``utils/profiling.count``), once per op call. A kernel
wrapper in ``ops/`` keeps only its route, its checks and its buffers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from distill_any_depth_tpu_torch.utils.profiling import count, span

__all__ = ["SOURCES", "DTYPES", "build_all", "load", "host_int", "Kernel"]

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
    "peg_conv": "peg_conv.cu",
}

CUDA_NVCC = "/usr/local/cuda/bin/nvcc"  # used when nvcc is not on PATH

DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # every kernel's dtype code
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_int64, "f": ctypes.c_float}

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


_host_fns: dict = {}  # (library, symbol) -> its typed ctypes function


def host_int(lib: str, symbol: str, *args: int) -> int:
    """The int64 that the host function ``symbol`` of library ``lib``
    returns for ``args`` (each a C int): a size a wrapper needs before a
    launch. Launches nothing and counts nothing."""
    fn = _host_fns.get((lib, symbol))
    if fn is None:
        fn = getattr(load(lib), symbol)
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = ctypes.c_int64
        _host_fns[lib, symbol] = fn
    return fn(*args)


class Kernel:
    """The entry point ``symbol`` of library ``lib``. ``kinds`` names its
    arguments before the stream, one letter each: "p" a tensor's data (or
    None, a null pointer), "i" int, "l" int64, "f" float; the pointers come
    first. ``kernel([tensors], *scalars)`` launches it under the first
    tensor's device on the current stream, raises with ``what`` on a
    non-zero return, and counts ``kernels/<counter>`` (no ``counter``: the
    launch is a part of an op call that another entry point counts). The
    library is loaded, built if need be, and the function typed at the
    first launch."""

    __slots__ = ("lib", "symbol", "kinds", "what", "counter", "_fn")

    def __init__(self, lib: str, symbol: str, kinds: str, what: str, counter: str | None):
        self.lib, self.symbol, self.kinds, self.what = lib, symbol, kinds, what
        self.counter = None if counter is None else f"kernels/{counter}"
        self._fn = None

    def _resolve(self):
        fn = getattr(load(self.lib), self.symbol)
        fn.argtypes = [_CTYPES[k] for k in self.kinds] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def __call__(self, tensors: list, *scalars) -> None:
        fn = self._fn
        if fn is None:
            fn = self._resolve()
        with torch.cuda.device(tensors[0].device):
            err = fn(*[None if t is None else t.data_ptr() for t in tensors], *scalars,
                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.what} kernel launch failed (error {err})")
        if self.counter is not None:
            count(self.counter, 1)
