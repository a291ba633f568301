"""Import guard: the port and ``chip_smoke.py`` import nothing of JAX and
nothing of the JAX package, and not the ``safetensors`` package (the card
machine has none: the port reads and writes the format itself), found by
scanning the import statements of their source files; every module of
the port imports cleanly; and the port's native C++ source (its own copy,
``native/dad_loader.cpp``) names no path of the JAX package.

The ops layer's structure, by the same scan: only ``ops/_build.py`` types a
ctypes function (``argtypes``) or reads a stream (``cuda_stream``), no
module of ``ops/`` keeps a ``.launches`` counter, and none imports
``models/``."""
import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "distill_any_depth_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
OPS = sorted(p for p in (PORT / "ops").glob("*.py") if p.name != "_build.py")
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
                   "data/registry.py", "utils/checkpoint.py", "utils/export.py",
                   "train/tuner.py", "data/native_loader.py", "cli/hdn_demo.py"):
        assert PORT / module in SOURCES, module


def test_native_source_is_the_ports_own():
    source = PORT / "native" / "dad_loader.cpp"
    text = source.read_text()
    assert "distill_any_depth_tpu/" not in text and "jax" not in text.lower()
    from distill_any_depth_tpu_torch.data import native_loader

    assert native_loader.SOURCE == source
    assert native_loader.BUILD_DIR == ROOT / "build"


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if p.parent != ROOT],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_module_imports(path):
    mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
    importlib.import_module(mod)


@pytest.mark.parametrize("path", OPS, ids=lambda p: p.name)
def test_ops_launch_only_through_the_build_layer(path):
    """Kernel wrappers call ``ops/_build.Kernel``: none sets ``argtypes``,
    reads ``cuda_stream`` or assigns a ``.launches`` attribute."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Attribute) and node.attr in ("argtypes", "cuda_stream"):
            bad.append(f"{node.attr} at line {node.lineno}")
        if isinstance(node, ast.Attribute) and node.attr == "launches" \
                and isinstance(node.ctx, ast.Store):
            bad.append(f".launches set at line {node.lineno}")
    assert not bad, f"{path.relative_to(ROOT)}: {bad}"


@pytest.mark.parametrize("path", OPS + [PORT / "ops" / "_build.py"], ids=lambda p: p.name)
def test_ops_import_nothing_of_models(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name in _imported_modules(path)
           if name.startswith("distill_any_depth_tpu_torch.models")]
    bad += [f"from {'.' * n.level}{n.module or ''}" for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.level and "models" in (n.module or "")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_ops_scan_sees_the_kernel_wrappers():
    names = {p.name for p in OPS}
    for module in ("flash_attention.py", "dpt_tail.py", "stats.py", "quant_matmul.py",
                   "swiglu.py", "quant.py", "derived.py"):
        assert module in names, module


def test_vit_imports_at_module_top():
    """``models/vit.py`` imports ``ops/quant`` at the top: no import inside a
    function to dodge a cycle."""
    path = PORT / "models" / "vit.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    inner = [(f.name, n.lineno) for f in ast.walk(tree)
             if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
             for n in ast.walk(f) if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not inner, inner
