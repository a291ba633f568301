"""The windowed student's distillation step against the benchmark's plain
reference, fp32 on the CPU, at a tiny windowed size; and the program spans
of the windowed backward.

- ``portbench/reference/dinov2_window_dpt_grad`` (each block, each image's
  attention and each image's head recomputed in the backward) against
  autograd through ``dinov2_window_dpt.depth_forward``, in float64 so that
  the two differ by summation order alone (readings about 1e-15 of the
  gradient's norm; 5e-7 in float32, where the per-image products sum in
  another order): to 1e-6 of the norm.
- The port's ``train_step`` with the windowed student (``attn_impl
  ="reference"``, float32) through the benchmark's ``train`` driver against
  ``reference/distill.train_steps`` for 2 steps: every step's loss
  components (``loss_gap``), and each parameter's change over its kept
  elements (``change_gap``, ``change_median_gap``; ``drivers/train.compare``).
  Limits 2e-3 on the losses and 0.2 / 0.05 on the changes. Both sides
  compute float32, so the gaps are not round-off alone: a pixel whose depth
  sits on a hybrid-normalization segment's or an HDN context's edge goes to
  the other side with a last-bit difference, which moves a loss of 7056
  pixels a step by about 1e-4, and the second step's loss moves with the
  first update, in which Adam divides each element's gradient by its own
  magnitude. Readings over three seeds: 0-3.8e-4, 2.2e-4-0.051,
  5.5e-5-0.013.
- A planted fault fails those limits: global attention in the reference
  student (``loss_gap`` 0.046), or the port's PEG gradient dropped
  (``change_gap`` 0.98: the PEG bias stays at 0 where the reference moves
  it).
- ``vit/pos_conv_bwd`` and ``vit/window_attention_bwd``: one backward of a
  one-block windowed forward records each once, with its counter; nothing
  outside ``recording()``.

The tiny student is ``depthanything-base-window`` at 2 blocks, width 64 (one
head), window 3, DPT 16 / 8-64, on a 6 x 7 grid (6 x 6 in the step; the
border rows' and columns' windows clamp inward); the teacher
``depthanything-large`` at 4 blocks, width 64, DPT 16 / 8-64.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import time

import pytest
import torch

from distill_any_depth_tpu_torch.configs import MODELS
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.ops import peg_conv as peg
from distill_any_depth_tpu_torch.utils import profiling
from portbench import harness, inputs, readings
from portbench.reference import dinov2_window_dpt, dinov2_window_dpt_grad
from portbench.spec import HERE, Cell

SEED = 2 ** 31 + 41
GH, GW = 6, 7
LOSS_TOL, CHANGE_TOL, CHANGE_MEDIAN_TOL = 2e-3, 0.2, 0.05
STUDENT, TEACHER = "tiny-window-student", "tiny-window-teacher"
SIZES = {"embed_dim": 64, "depth": 2, "num_heads": 1, "features": 16,
         "out_channels": [8, 16, 32, 64]}
STUDENT_ENTRY = {"reference": "dinov2_window_dpt_grad", "preset": STUDENT, **SIZES,
                 "mlp_ratio": 4.0, "base_img_size": 224, "window_size": 3,
                 "use_pos_conv": True, "use_cls_token": False, "final_taps": True,
                 "layerscale_init": 1.0, "trailing_head_relu": False, "interp_to_input": True}
TEACHER_ENTRY = {"reference": "dinov2_dpt", "preset": TEACHER, **SIZES, "depth": 4,
                 "mlp_ratio": 4.0, "base_img_size": 518, "out_indices": [0, 1, 2, 3],
                 "interpolate_offset": 0.1,
                 "layerscale_init": 1.0, "trailing_head_relu": False, "interp_to_input": True}


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: Tier-1 runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _preset(name: str, window: int | None, depth: int = 2):
    base = MODELS["depthanything-base-window" if window else "depthanything-large"]
    enc = dataclasses.replace(base.encoder, embed_dim=64, depth=depth, num_heads=1,
                              **({"window_size": window} if window else
                                 {"out_indices": tuple(range(depth))}))
    return dataclasses.replace(base, arch_name=name, encoder=enc, features=16,
                               out_channels=(8, 16, 32, 64))


@pytest.fixture
def presets(monkeypatch):
    monkeypatch.setitem(MODELS, STUDENT, _preset(STUDENT, 3))
    monkeypatch.setitem(MODELS, TEACHER, _preset(TEACHER, None, depth=4))


def _cell() -> Cell:
    with open(os.path.join(HERE, "configs", "dad-distill-l2b-window.json")) as f:
        config = json.load(f)
    config.update(student=dict(STUDENT_ENTRY), teacher=copy.deepcopy(TEACHER_ENTRY))
    config["train"].update(batch_size=2, image_size=14 * GH, teacher_chunk=1,
                           student_compute_dtype="float32", teacher_dtype="float32",
                           teacher_fused_tail="off", attn_impl="reference")
    traffic = {"driver": "train", "source": "memory", "pool_batches": 2, "check_steps": 2,
               "trace_steps": 1}
    return Cell("tiny-window-distill", 1, config, traffic, {}, [], [])


def _gaps(cell: Cell) -> dict:
    drv, _, outcome = harness.run(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    ref = drv.reference(cell, SEED, outcome, torch.device("cpu"))
    return {**drv.compare(outcome, ref), **readings.train_readings(outcome, ref)}


def test_the_gradient_reference_is_autograd_of_the_window_reference():
    weights = {k: v.double() for k, v in inputs.make_weights(STUDENT_ENTRY, SEED, "student",
                                                              "cpu").items()}
    x = torch.randn(2, 3, 14 * GH, 14 * GW, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    grads, outs = [], []
    for module in (dinov2_window_dpt, dinov2_window_dpt_grad):
        w = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
        depth, feat = module.depth_forward(w, STUDENT_ENTRY, x)
        ramp = torch.linspace(0, 1, depth.numel(), dtype=torch.float64).reshape(depth.shape)
        loss = (depth * ramp).sum() + feat.square().mean()
        g = torch.autograd.grad(loss, list(w.values()), allow_unused=True,
                                materialize_grads=True)
        grads.append(torch.cat([t.flatten() for t in g]))
        outs.append(torch.cat([depth.flatten(), feat.flatten()]).detach())
    assert float((outs[1] - outs[0]).norm() / outs[0].norm()) < 1e-6
    assert float((grads[1] - grads[0]).norm() / grads[0].norm()) < 1e-6
    assert float(grads[0].norm()) > 0


def test_the_ports_step_matches_the_reference(presets):
    gaps = _gaps(_cell())
    assert gaps["loss_gap"] < LOSS_TOL, gaps
    assert gaps["change_gap"] < CHANGE_TOL, gaps
    assert gaps["change_median_gap"] < CHANGE_MEDIAN_TOL, gaps


class _NoPegGradient(torch.autograd.Function):
    """The PEG conv's plain forward with its gradient dropped."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        return peg.F.conv2d(x, weight, bias, padding=peg.PAD, groups=x.shape[1]) + x

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g), None, None


@pytest.mark.parametrize("fault", ["global_attention", "peg_gradient_dropped"])
def test_a_planted_fault_fails_the_limits(presets, monkeypatch, fault):
    if fault == "global_attention":
        monkeypatch.setattr(dinov2_window_dpt, "window_mask",
                            lambda gh, gw, window, device=None: torch.ones(
                                gh * gw, gh * gw, dtype=torch.bool, device=device))
    else:
        monkeypatch.setattr(peg, "peg_conv_reference", _NoPegGradient.apply)
    gaps = _gaps(_cell())
    assert (gaps["loss_gap"] >= LOSS_TOL or gaps["change_gap"] >= CHANGE_TOL
            or gaps["change_median_gap"] >= CHANGE_MEDIAN_TOL), gaps


def test_the_windowed_backward_spans():
    model = create_model(_preset(STUDENT, 3, depth=1), dtype=torch.float32, device="cpu",
                         seed=0)
    x = torch.randn(2, 3, 14 * GH, 14 * GW, generator=torch.Generator().manual_seed(5))
    with profiling.recording() as rec:
        depth, _ = model(x)
        fwd = len(rec.spans)
        depth.sum().backward()
    names = [s.name for s in rec.spans[fwd:]]
    assert sorted(names) == ["vit/pos_conv_bwd", "vit/window_attention_bwd"]
    pairs = 2 * 1 * (GH * 3) * (GW * 3)  # 2 images x 1 head x (6 rows x 3) x (7 columns x 3)
    assert rec.counts["vit/window_bwd_pairs"] == rec.counts["vit/window_pairs"] == pairs
    # d(x) and d(weight): 2 images x 64 channels x 37^2 taps x 42 pixels, 2 operations each
    assert rec.counts["vit/pos_conv_bwd_flops"] == 2 * 2 * 2 * 64 * 37 * 37 * GH * GW
    assert rec.counts["vit/pos_conv_bwd_flops"] == 2 * rec.counts["vit/pos_conv_flops"]
    with profiling.recording() as rec:
        depth, _ = model(x)
    depth.sum().backward()  # the recording closed before the backward
    assert [s.name for s in rec.spans] == ["vit/pos_conv", "vit/window_attention"]
    assert "vit/pos_conv_bwd_flops" not in rec.counts
    with profiling.recording() as outer:
        pass
    depth, _ = model(x)
    with profiling.recording() as rec:  # the forward ran outside any recording
        depth.sum().backward()
    assert not rec.spans and not rec.counts and not outer.spans
