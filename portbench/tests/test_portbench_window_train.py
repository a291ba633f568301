"""The ``window-distill-1036`` cell: its files, both model entries taken by
their presets, the counts of ``portbench/window_train_flops`` pinned by
hand and against the program's own kernel bounds, and the cell's three new
readers on a synthetic trace."""
from __future__ import annotations

import pytest

from portbench import flops, harness, spec, tracing, window_flops, window_train_flops

CELL = "window-distill-1036"
# the kernels' names as an H100 trace of the cell's step shows them
BANDED_BWD = ["void dad_masked_wg::dkdv_wgmma<dad_attn::WindowMask>(CUtensorMap_st, float const*)",
              "void dad_masked_wg::dq_wgmma<dad_attn::WindowMask>(CUtensorMap_st, float const*)"]
DELTA = "void dad_attn::delta_kernel<__nv_bfloat16>(__nv_bfloat16 const*, float*, int, long)"
PEG = ["void (anonymous namespace)::dad_peg_conv_depthwise2d_wgmma<80, 3>(__nv_bfloat16 const*)",
       "void at::native::(anonymous namespace)::conv_depthwise2d_backward_kernel<0, 1, "
       "c10::BFloat16, int>(torch::headeronly::detail::GenericPackedTensorAccessor)",
       "void at::native::(anonymous namespace)::conv_depthwise2d_grad_weight_kernel<"
       "c10::BFloat16, unsigned int>(torch::headeronly::detail::GenericPackedTensorAccessor)"]
READERS = ("k8_roofline.train", "peg_roofline.train", "window_mfu.train")


def test_the_cell_resolves_to_its_files():
    cell = spec.load_cell(CELL)
    c = cell.config
    assert c["name"] == "dad-distill-l2b-window" and c["reference"] == "distill"
    assert c["student"]["reference"] == "dinov2_window_dpt_grad"
    assert c["student"]["preset"] == "depthanything-base-window"
    assert c["teacher"] == spec.load_cell("distill-392").config["teacher"]
    assert c["train"] == {**spec.load_cell("distill-392").config["train"], "image_size": 1036}
    assert cell.traffic == {"driver": "train", "source": "memory", "pool_batches": 4,
                            "check_steps": 3, "trace_steps": 3}
    assert set(cell.limits) == {"loss0_gap", "change_gap", "change_median_gap"}
    assert cell.chips == 1
    assert {x["name"] for x in cell.end_to_end} == {"train_img_s", "train_peak_gib", "setup_s"}
    assert {x["name"] for x in cell.per_layer} == {
        "step_enqueue_ms.train", "teacher_fwd_ms.train", "device_idle.train",
        "k4_roofline.train", *READERS}


def test_both_model_entries_are_their_presets():
    c = spec.load_cell(CELL).config
    for role in ("student", "teacher"):
        harness.check_preset(c[role])
    with pytest.raises(ValueError, match="window_size"):
        harness.check_preset({**c["student"], "preset": "depthanything-base"})


def test_the_counts_pinned_by_hand():
    from distill_any_depth_tpu_torch.cli import kernel_bounds

    # kernel 8 at bs16 1036^2: qkv [16, 5476, 2304], out and d(out) [16, 5476,
    # 768] read and d(qkv) written, in bf16: 1.077 GB at 3.35 TB/s
    ops, nbytes = window_train_flops.banded_attention_backward(16, 74, 74, 12, 7)
    assert nbytes == 16 * 5476 * (2304 + 768 + 768 + 2304) * 2
    assert ops == 10 * 64 * 16 * 12 * 5476 * 49
    row = kernel_bounds.bounds()["8 banded attention bwd, window student 1036^2 bs16"]
    assert flops.bound_s(ops, nbytes) == (pytest.approx(0.3214e-3, rel=1e-3), "bytes")
    assert flops.bound_s(ops, nbytes)[0] * 1e3 == pytest.approx(row["bound_ms"], rel=1e-12)
    # the PEG conv's forward, d(x) and d(weight) at bs16 1036^2: three times
    # 184.2 GFLOP, bound by the operations
    ops, nbytes = window_train_flops.pos_conv_step(16, 768, 74, 74)
    assert ops == 3 * window_flops.pos_conv(16, 768, 74, 74)[0] == 6 * 16 * 768 * 37 ** 2 * 5476
    assert flops.bound_s(ops, nbytes) == (pytest.approx(0.5589e-3, rel=1e-3), "operations")
    # a step's FLOPs an image: the ViT-L teacher's forward at 1036^2 (7.378 T)
    # and three windowed students' (1.2544 T each)
    c = spec.load_cell(CELL).config
    assert window_train_flops.step_flops(c) == pytest.approx(7.3782e12 + 3 * 1.25436e12,
                                                             rel=1e-4)


def _ctx(names):
    cell = spec.load_cell(CELL)
    spans = tracing.Spans(True)
    for span in ("step.enqueue", "teacher.forward"):
        spans.add(span, 0, 10)
    trace = tracing.Trace(ops=[(n, 20 + 10 * i, 25 + 10 * i) for i, n in enumerate(names)],
                          start_ns=0, end_ns=10 * len(names) + 20, units=1, spans=spans.items,
                          launch_ns=[5] * len(names))
    return harness.Ctx(cell=cell, setup_s=1.0, window_s=1.0, images=16, units=1,
                       ends_s=[1.0], peak_window_bytes=2 ** 30, spans=spans, trace=trace)


def test_the_new_readers_read_a_synthetic_trace():
    assert [tracing.classify(n) for n in BANDED_BWD + [DELTA] + PEG] == (
        ["banded attention backward kernel"] * 2
        + ["attention backward kernel (packed; all deltas)"]
        + ["depthwise conv (PEG, ATen)"] * 3)
    ctx = _ctx(BANDED_BWD + [DELTA] + PEG + ["kth_select_kernel", "nvjet_gemm"])
    for name in READERS:
        value = spec.metric_reader(name)(ctx)
        assert isinstance(value, float) and value > 0, (name, value)
    # four kernel-8 operations of 5 ns for 12 bounds of 0.3214 ms, three PEG
    # operations of 5 ns for one bound of 0.5589 ms
    assert spec.metric_reader("k8_roofline.train")(ctx) == pytest.approx(
        100 * 12 * 0.32138e-3 / 15e-9, rel=1e-4)
    assert spec.metric_reader("peg_roofline.train")(ctx) == pytest.approx(
        100 * 0.55886e-3 / 15e-9, rel=1e-4)


def test_the_new_readers_read_none_without_their_kernels():
    ctx = _ctx(["kth_select_kernel", "nvjet_gemm"])
    for name in ("k8_roofline.train", "peg_roofline.train"):
        assert spec.metric_reader(name)(ctx) is None
        assert spec.metric_reader(name)(harness.Ctx(cell=ctx.cell, setup_s=1.0)) is None
    # kernel 3 in the trace: its deltas and kernel 8's are one class
    ctx = _ctx(BANDED_BWD + [DELTA, "(anonymous namespace)::hop::dq_wgmma(CUtensorMap_st, int)"])
    packed = "attention backward kernel (packed; all deltas)"
    assert tracing.classify(ctx.trace.ops[-1][0]) == packed
    assert spec.metric_reader("k8_roofline.train")(ctx) is None
