"""The port's ``utils/export`` on the CPU, on tiny models.

- The exported graph holds one op node per attention and per tail call
  (``dad::packed_attention``, ``dad::bias_attention`` or
  ``dad::banded_attention``, ``dad::dpt_tail``), in a windowed model one
  ``dad::peg_conv`` (the PEG conv with its bias and identity) and, in an
  ``int8_pallas`` model, one ``dad::w8a8_matmul`` per block GEMM: the
  kernels stay single nodes, not their decompositions.
- Every program, loaded in a subprocess that imports only
  ``utils/export`` (which registers the ops) and nothing of ``models/``,
  gives the live port forward's depth bit for bit (the ops' CPU
  implementations are the plain versions the live forward runs).
- The weights-as-arguments artifact is under half the weights' bytes (the
  JAX package's ``tests/test_launch_and_io.py`` bound), and its weights file
  holds them all.
- Both artifacts against the JAX package's ``export_forward`` /
  ``load_exported`` (and the weights-as-arguments pair) on the same weights
  (``params_from_jax``): |err| <= 1e-5 * (1 + |ref|), the JAX test's 1e-5
  with the cross-framework summation order of ``tests/test_torch_model.py``.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distill_any_depth_tpu.configs import MODELS as JAX_MODELS
from distill_any_depth_tpu.models.factory import create_model as jax_create_model
from distill_any_depth_tpu.utils import export as jax_export
from distill_any_depth_tpu_torch.configs import MODELS
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.ops import flash_attention as fa
from distill_any_depth_tpu_torch.utils import export
from distill_any_depth_tpu_torch.utils.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
DEPTH = 2
# name -> (preset, image size, quant); "banded" runs the banded op at a tiny
# grid (the port's threshold lowered while it is traced)
CASES = {
    "plain": ("depthanything-base", 56, "none"),
    "window_bias": ("depthanything-base-window", 126, "none"),
    "window_banded": ("depthanything-base-window", 126, "none"),
    "int8_pallas": ("depthanything-base", 56, "int8_pallas"),
}
# op nodes a forward holds: attention and tail calls, and 4 GEMMs a block
WANT_OPS = {
    "plain": {"dad.packed_attention.default": DEPTH, "dad.dpt_tail.default": 1},
    "window_bias": {"dad.bias_attention.default": DEPTH, "dad.dpt_tail.default": 1,
                    "dad.peg_conv.default": 1},
    "window_banded": {"dad.banded_attention.default": DEPTH, "dad.dpt_tail.default": 1,
                      "dad.peg_conv.default": 1},
    "int8_pallas": {"dad.packed_attention.default": DEPTH, "dad.dpt_tail.default": 1,
                    "dad.w8a8_matmul.default": 4 * DEPTH},
}

LOADER = """
import json, sys, torch
from distill_any_depth_tpu_torch.utils.export import load_exported, load_exported_with_params
d = sys.argv[1]
out = {}
for name in %r:
    x = torch.load(f"{d}/{name}_x.pt")
    want = torch.load(f"{d}/{name}_depth.pt")
    got = load_exported(open(f"{d}/{name}.pt2", "rb").read())(x)
    out[name] = bool(torch.equal(got, want))
    if name == "plain":
        fn = load_exported_with_params(open(f"{d}/plain_args.pt2", "rb").read(),
                                       f"{d}/plain_args.safetensors", "cpu")
        out["plain_args"] = bool(torch.equal(fn(x), want))
out["modules"] = sorted(m for m in sys.modules if m.startswith("distill_any_depth_tpu"))
print(json.dumps(out))
"""


def _tiny(models, preset: str):
    cfg = models[preset]
    enc = dataclasses.replace(cfg.encoder, embed_dim=128, depth=DEPTH, num_heads=2,
                              out_indices=(0, 1, 1, 1),
                              **({"window_size": 3} if cfg.encoder.window_size else {}))
    return dataclasses.replace(cfg, encoder=enc, features=64, out_channels=(16, 32, 48, 64))


def _model(name: str):
    preset, size, quant = CASES[name]
    model = create_model(_tiny(MODELS, preset), device="cpu", quant=quant)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, size, size).astype(np.float32))
    return model, x


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Each case's program (and the plain model's weights-as-arguments one),
    its input and the live depth, written to a directory; then one
    subprocess loads them all."""
    d = tmp_path_factory.mktemp("export")
    graphs, sizes = {}, {}
    mp = pytest.MonkeyPatch()
    try:
        for name in CASES:
            model, x = _model(name)
            if name == "window_banded":
                mp.setattr(fa, "_BANDED_MIN_SEQ", 0)
            with torch.no_grad():
                program = torch.export.export(export._Depth(model), (x,))
                blob = export.export_forward(model, x.shape[-1], x.shape[0])
                depth = model(x)[0]
            mp.undo()
            graphs[name] = [str(n.target) for n in program.graph.nodes
                            if n.op == "call_function"]
            (d / f"{name}.pt2").write_bytes(blob)
            torch.save(x, d / f"{name}_x.pt")
            torch.save(depth, d / f"{name}_depth.pt")
            if name == "plain":
                args = export.export_forward_with_params(model, str(d / "plain_args.safetensors"),
                                                         x.shape[-1], x.shape[0])
                (d / "plain_args.pt2").write_bytes(args)
                sizes = {"program": len(args), "embedded": len(blob),
                         "weights": sum(p.numel() * 4 for p in model.parameters()),
                         "file": (d / "plain_args.safetensors").stat().st_size}
    finally:
        mp.undo()
    proc = subprocess.run([sys.executable, "-c", LOADER % (list(CASES),), str(d)],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {"graphs": graphs, "sizes": sizes, "loaded": json.loads(proc.stdout.splitlines()[-1]),
            "dir": d}


@pytest.mark.parametrize("name", list(CASES))
def test_graph_holds_one_op_per_kernel_call(artifacts, name):
    ops = {}
    for target in artifacts["graphs"][name]:
        if target.startswith("dad."):
            ops[target] = ops.get(target, 0) + 1
    assert ops == WANT_OPS[name]
    # and no attention traced through beside them: the plain versions'
    # exponentials would show
    assert not [t for t in artifacts["graphs"][name] if t.startswith("aten.exp.")]


@pytest.mark.parametrize("name", list(CASES) + ["plain_args"])
def test_loaded_program_equals_live_forward(artifacts, name):
    assert artifacts["loaded"][name] is True


def test_loader_imports_no_model_code(artifacts):
    modules = artifacts["loaded"]["modules"]
    assert "distill_any_depth_tpu_torch.utils.export" in modules
    assert not [m for m in modules if m.startswith("distill_any_depth_tpu_torch.models")
                or m.split(".")[0] == "distill_any_depth_tpu"], modules


def test_params_artifact_under_half_the_weights(artifacts):
    sizes = artifacts["sizes"]
    assert sizes["program"] < sizes["weights"] / 2, sizes
    assert sizes["embedded"] > sizes["weights"], sizes  # it does hold them
    assert sizes["file"] >= sizes["weights"], sizes


def _jax_pair():
    jcfg, tcfg = _tiny(JAX_MODELS, "depthanything-base"), _tiny(MODELS, "depthanything-base")
    jmodel = jax_create_model(jcfg, attn_impl="reference")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    model = create_model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return jmodel, params, model


@pytest.mark.parametrize("flavour", ["embedded", "weights_as_arguments"])
def test_export_matches_jax_export(tmp_path, flavour):
    """The port's loaded program against the JAX package's loaded program
    on the same weights and images (NCHW against NHWC)."""
    jmodel, params, model = _jax_pair()
    x = np.random.RandomState(1).rand(2, 56, 56, 3).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    if flavour == "embedded":
        want = jax_export.load_exported(jax_export.export_forward(jmodel, params, 56, 2))(
            jnp.asarray(x))
        got = export.load_exported(export.export_forward(model, 56, 2))(xt)
    else:
        jblob = jax_export.export_forward_with_params(jmodel, params, str(tmp_path / "j.st"),
                                                      56, 2)
        want = jax_export.load_exported_with_params(jblob, str(tmp_path / "j.st"))(
            jnp.asarray(x))
        blob = export.export_forward_with_params(model, str(tmp_path / "t.st"), 56, 2)
        got = export.load_exported_with_params(blob, str(tmp_path / "t.st"), "cpu")(xt)
    want, got = np.asarray(want, np.float64), got.numpy().astype(np.float64)
    assert got.shape == want.shape == (2, 56, 56)
    assert np.all(np.abs(got - want) <= TOL * (1 + np.abs(want))), np.abs(got - want).max()
