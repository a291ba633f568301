"""Import guard: the port and ``chip_smoke.py`` import nothing of JAX and
nothing of the JAX package, and not the ``safetensors`` package (the card
machine has none: the port reads and writes the format itself), found by
scanning the import statements of their source files; and every module of
the port imports cleanly."""
import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "distill_any_depth_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "distill_any_depth_tpu")


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_sources_found():
    assert len(SOURCES) > 10
    for source in ("flash_attention.cu", "flash_attention_bwd.cu", "dpt_tail.cu",
                   "kth_select.cu", "w8a8_matmul.cu", "attention_tiles.cuh"):
        assert (PORT / "csrc" / source).exists(), source


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [name for name in _imported_modules(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_safetensors_imports(path):
    bad = [name for name in _imported_modules(path) if name.split(".")[0] == "safetensors"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_new_modules_scanned():
    for module in ("eval/metrics.py", "eval/evaluate.py", "cli/evaluate.py", "cli/convert.py",
                   "data/registry.py", "utils/checkpoint.py"):
        assert PORT / module in SOURCES, module


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if p.parent != ROOT],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_module_imports(path):
    mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
    importlib.import_module(mod)
