"""The reduction of a device trace: busy time, idle gaps named by the host
span open across them, and the device work that a host span enqueued,
matched to its launches by correlation id."""
from __future__ import annotations

from portbench import tracing

BASE = 1_000_000_000_000


def _chrome():
    """Two launches inside a ``teacher.forward`` span and one after it; the
    kernels run later than their launches, as on a card."""
    def ev(cat, name, ts, dur, corr):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    return {"baseTimeNanoseconds": BASE, "traceEvents": [
        ev("cuda_runtime", "cudaLaunchKernel", 10.0, 2.0, 1),
        ev("cuda_driver", "cuLaunchKernel", 20.0, 2.0, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 60.0, 2.0, 3),
        ev("kernel", "packed_attn_wgmma<...>", 40.0, 30.0, 1),
        ev("kernel", "nvjet_gemm", 65.0, 20.0, 2),  # overlaps the first: a union
        ev("kernel", "kth_select_kernel", 100.0, 10.0, 3),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 120.0, "dur": 5.0,
         "args": {}},
    ]}


def test_launched_in_takes_the_union_of_what_a_span_enqueued():
    us = 1000
    spans = [("teacher.forward", BASE + 5 * us, BASE + 30 * us),
             ("step.enqueue", BASE + 30 * us, BASE + 130 * us)]
    t = tracing.from_chrome(_chrome(), BASE, BASE + 130 * us, 1, spans)
    assert t.launch_ns[:3] == [BASE + 10 * us, BASE + 20 * us, BASE + 60 * us]
    assert t.launch_ns[3] is None  # the copy has no launch in this trace
    assert t.launched_in("teacher.forward") == (85 - 40) * us / 1e9
    assert t.launched_in("step.enqueue") == 10 * us / 1e9
    assert t.launched_in("loader.wait") is None
    assert t.busy_s == (45 + 10 + 5) * us / 1e9
    # each idle gap is named by the span that covers most of it
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps == {"teacher.forward": 40 * us / 1e9, "step.enqueue": (15 + 10 + 5) * us / 1e9}


def test_another_clock_is_aligned_with_the_window():
    us = 1000
    t = tracing.from_chrome(_chrome(), 7 * BASE, 7 * BASE + 130 * us, 1, [])
    assert t.ops[0][1] == 7 * BASE and t.launch_ns[0] == 7 * BASE - 30 * us
