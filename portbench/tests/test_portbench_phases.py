"""``portbench.phases``: the device's idle time, launches and copies under
the program's spans, on a hand-made Chrome trace, and the per-phase split
of a run from its context and the program's recording."""
from __future__ import annotations

import pytest

from portbench import harness, phases, tracing

BASE = 1_000_000_000_000
US = 1000


def _chrome():
    """Two kernels launched at 10 and 20 us, a copy at 60 (its runtime call
    traced) and a kernel at 95; on the device the first two overlap."""
    def ev(cat, name, ts, dur, corr):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    return {"baseTimeNanoseconds": BASE, "traceEvents": [
        ev("cuda_runtime", "cudaLaunchKernel", 10.0, 2.0, 1),
        ev("cuda_driver", "cuLaunchKernel", 20.0, 2.0, 2),
        ev("cuda_runtime", "cudaMemcpyAsync", 60.0, 2.0, 3),
        ev("cuda_runtime", "cudaLaunchKernel", 95.0, 2.0, 4),
        ev("kernel", "packed_attn_wgmma<...>", 40.0, 30.0, 1),
        ev("kernel", "nvjet_gemm", 65.0, 20.0, 2),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 90.0, 8.0, 3),
        ev("kernel", "kth_select_kernel", 100.0, 10.0, 4),
    ]}


def _trace(spans=()):
    return tracing.from_chrome(_chrome(), BASE, BASE + 130 * US, 1, list(spans))


def _span(name, start_us, end_us, parent=None, root=1):
    from distill_any_depth_tpu_torch.utils.profiling import Span

    return Span(name, BASE + start_us * US, BASE + end_us * US, parent, root, 1)


def test_idle_launches_and_copies_under_intervals():
    t = _trace()
    # busy: [40, 85], [90, 98] and [100, 110] us
    assert phases.idle_in(t, [(BASE + 5 * US, BASE + 30 * US)]) == 25 * US / 1e9
    late = [(BASE + 30 * US, BASE + 200 * US)]  # past the window's end
    assert phases.idle_in(t, late) == (10 + 5 + 2 + 20) * US / 1e9
    two = phases.merge([(BASE + 50 * US, BASE + 99 * US), (BASE, BASE + 45 * US)])
    assert phases.idle_in(t, two) == (40 + 5 + 1) * US / 1e9
    first = [(BASE + 5 * US, BASE + 30 * US)]
    assert phases.launches(t, first) == 2
    assert phases.launches(t, [(BASE + 55 * US, BASE + 100 * US)]) == 1  # not the copy
    assert phases.copy_seconds(t, [(BASE + 55 * US, BASE + 65 * US)], "HtoD") == 8 * US / 1e9
    assert phases.copy_seconds(t, [(BASE + 55 * US, BASE + 65 * US)], "DtoH") == 0
    assert phases.copy_seconds(t, first, "HtoD") == 0
    assert [n for n, _, _ in phases.launched_in(t, [(BASE + 90 * US, BASE + 96 * US)])] == [
        "kth_select_kernel"]


def test_union_of_spans_by_name():
    spans = [_span("a", 0, 10), _span("a", 5, 20), _span("b", 15, 30), _span("a", 40, 50)]
    assert phases.union(spans, "a") == [(BASE, BASE + 20 * US),
                                        (BASE + 40 * US, BASE + 50 * US)]
    assert phases.union(spans, "a", "b") == [(BASE, BASE + 30 * US),
                                             (BASE + 40 * US, BASE + 50 * US)]


@pytest.mark.parametrize("kind", ["train", "infer"])
def test_split_of_a_run(kind):
    """One unit in the measured window (the harness's span first, at -100
    us) and one in the traced window, whose phases cover its launches."""
    from distill_any_depth_tpu_torch.utils.profiling import Recording

    root, upload, phase, nbytes = (("train/step", "train/upload", "train/teacher_fwd",
                                    "train/upload_bytes") if kind == "train" else
                                   ("predict", "predict/upload", "predict/readback",
                                    "predict/upload_bytes"))
    rec = Recording()
    rec.spans += [_span(root, -90, -50, root=1), _span(phase, -80, -60, root, 1),
                  _span(root, 2, 128, root=2), _span(upload, 55, 65, root, 2),
                  _span(phase, 5, 30, root, 2)]
    rec.counted += [(nbytes, 8000, BASE + 60 * US), (nbytes, 99, BASE - 70 * US)]
    harness_spans = tracing.Spans(True)
    harness_spans.add("step.enqueue", BASE - 100 * US, BASE - 40 * US)
    ctx = harness.Ctx(cell=None, setup_s=1.0, spans=harness_spans, trace=_trace())
    out = phases.split(ctx, rec, kind)
    assert out["units"] == {"measured": 1, "traced": 1}
    assert out["host_ms"][phase] == pytest.approx(20 * US / 1e6)
    assert out["idle_ms"][phase] == pytest.approx(25 * US / 1e6)
    assert out["counts"] == {"measured": {nbytes: 99}, "traced": {nbytes: 8000}}
    # idle 130 - 63 = 67 us, of which [0, 2] and [128, 130] lie under no span
    assert out["idle_uncovered_share"] == pytest.approx(4 / 67)
    m = out["metrics"]
    if kind == "train":
        assert m["teacher_fwd_enqueue_ms.train"] == pytest.approx(0.02)
        assert m["teacher_fwd_idle_ms.train"] == pytest.approx(0.025)
        assert m["student_fwd_enqueue_ms.train"] is None  # no such span
        assert m["launches.train"] == 3
        assert m["upload_gb_s.train"] == pytest.approx(8000 / 8e-6 / 1e9)
    else:
        assert m["readback_idle_ms.infer"] == pytest.approx(0.025)
        assert m["upload_gb_s.infer"] == pytest.approx(1.0)
        assert m["readback_gb_s.infer"] is None  # no readback bytes counted
        assert m["upload_idle_ms.infer"] == 0.0

