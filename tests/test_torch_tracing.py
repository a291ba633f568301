"""The port's program spans and counters (``utils/profiling``) on the CPU.

- Off, the default: ``span`` hands back one shared no-op and nothing is
  kept; a ``recording()`` block keeps spans with their parent, their root
  (shared by one call's or step's spans) and their thread.
- One ``predict`` call records its six spans in order and counts the
  frames' and the depth's bytes; its output is the same with recording on.
- One train step, as ``Trainer._epochs`` drives it (``_views`` then
  ``train_step``), records ``train/step`` with its phases as siblings, and
  the same loss as with recording off.
- ``trace()`` (``--profile_dir``) writes the spans into ``trace.json``
  inside the time range of the profiler's own events.
"""
import contextlib
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from distill_any_depth_tpu_torch.cli import infer
from distill_any_depth_tpu_torch.configs import MODELS, TrainConfig
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.train import loop
from distill_any_depth_tpu_torch.utils import profiling
from distill_any_depth_tpu_torch.utils.profiling import count, recording, span

TINY, SIZE = "tracing-tiny", 56
STEP_PHASES = ["train/student_fwd", "train/teacher_fwd", "train/loss", "train/backward",
               "train/optimizer", "train/metrics"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: Tier-1 runs several test files at once, and the
    losses compared bit for bit need one order of summation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """A tiny ViT preset of the port, student and teacher alike."""
    cfg = MODELS["depthanything-base"]
    enc = dataclasses.replace(cfg.encoder, embed_dim=64, depth=2, num_heads=1,
                              out_indices=(0, 0, 1, 1))
    MODELS[TINY] = dataclasses.replace(cfg, encoder=enc, features=32,
                                       out_channels=(16, 32, 48, 64))
    yield TINY
    del MODELS[TINY]


def _names_in_order(spans) -> list[str]:
    """Span names by their first start."""
    first: dict[str, int] = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        first.setdefault(s.name, s.start_ns)
    return list(first)


def test_nothing_is_recorded_while_off():
    assert profiling._recording is None
    assert span("a") is span("b")  # one shared no-op context
    with span("a"):
        count("bytes", 5)
    with recording() as rec:
        pass
    assert rec.spans == [] and rec.counted == [] and rec.counts == {}
    with recording() as rec:
        with span("on"):
            count("bytes", 3)
    with span("off"):
        count("bytes", 4)
    assert [s.name for s in rec.spans] == ["on"] and rec.counts == {"bytes": 3}
    assert profiling._recording is None


def test_nested_recordings_each_see_every_count_and_span():
    """A count and a span inside a nested ``recording()`` block reach both
    blocks; what ran before the inner block opened reaches the outer one
    alone."""
    with recording() as outer:
        count("kernels/attention", 1)
        with span("before"):
            pass
        with recording() as inner:
            with span("inside"):
                count("kernels/attention", 2)
                count("kernels/tail", 1)
        assert profiling._recording == (outer,)
    assert profiling._recording is None
    assert inner.counts == {"kernels/attention": 2, "kernels/tail": 1}
    assert outer.counts == {"kernels/attention": 3, "kernels/tail": 1}
    assert [s.name for s in inner.spans] == ["inside"]
    assert [s.name for s in outer.spans] == ["before", "inside"]
    assert inner.spans[0] is outer.spans[1]


def test_nesting_parent_root_and_threads():
    entered, release = threading.Event(), threading.Event()

    def other():
        entered.wait(5)
        with span("worker"):
            with span("worker/inner"):
                pass
        release.set()

    thread = threading.Thread(target=other)
    with recording() as rec:
        thread.start()
        with span("a"):
            entered.set()  # the worker's spans begin while "a" is open here
            assert release.wait(5)
            with span("a/b"):
                with span("a/b/c"):
                    pass
            with span("a/d"):
                pass
        with span("e"):
            pass
    thread.join(5)
    assert not thread.is_alive()
    by = {s.name: s for s in rec.spans}
    assert set(by) == {"a", "a/b", "a/b/c", "a/d", "e", "worker", "worker/inner"}
    assert [by[n].parent for n in ("a", "a/b", "a/b/c", "a/d", "e")] == [
        None, "a", "a/b", "a", None]
    assert by["a/b"].root == by["a/b/c"].root == by["a/d"].root == by["a"].root
    assert by["e"].root != by["a"].root
    # the second thread's spans keep their own nesting
    assert by["worker"].parent is None and by["worker/inner"].parent == "worker"
    assert by["worker/inner"].root == by["worker"].root
    assert by["worker"].root not in (by["a"].root, by["e"].root)
    assert by["worker"].thread != by["a"].thread == by["e"].thread
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
    assert by["a"].start_ns <= by["a/b"].start_ns and by["a/d"].end_ns <= by["a"].end_ns


def test_predict_records_its_phases(tiny):
    model = create_model(MODELS[tiny], device="cpu").eval()
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, size=(40 + 4 * i, 60, 3), dtype=np.uint8) for i in range(3)]
    plain = infer.predict(model, frames, SIZE, batch_size=2)
    with recording() as rec:
        got = infer.predict(model, frames, SIZE, batch_size=2)
    np.testing.assert_array_equal(got, plain)
    assert _names_in_order(rec.spans) == ["predict", "predict/upload", "predict/preprocess",
                                          "predict/forward", "predict/readback",
                                          "predict/concat"]
    (root,) = [s for s in rec.spans if s.name == "predict"]
    for s in rec.spans:
        assert s.root == root.root
        assert s.parent == (None if s is root else "predict")
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    per = {n: sum(s.name == n for s in rec.spans) for n in _names_in_order(rec.spans)}
    # three frames; a cat; two batches of 2 (the second padded)
    assert per == {"predict": 1, "predict/upload": 3, "predict/preprocess": 4,
                   "predict/forward": 2, "predict/readback": 2, "predict/concat": 1}
    assert rec.counts == {"predict/upload_bytes": sum(f.nbytes for f in frames),
                          "predict/readback_bytes": got.nbytes}


def _trainer(tiny, out) -> loop.Trainer:
    cfg = TrainConfig(student=MODELS[tiny], teachers=(tiny,), batch_size=2, image_size=SIZE,
                      output_dir=str(out), teacher_dtype="float32",
                      student_compute_dtype="float32", teacher_chunk=0, log_interval=2)
    return loop.Trainer(cfg, "cpu")


def _batches(n: int) -> list[dict]:
    rng = np.random.RandomState(0)
    return [{"image": rng.rand(2, SIZE, SIZE, 3).astype(np.float32)} for _ in range(n)]


def test_train_step_records_its_phases_as_siblings(tiny, tmp_path):
    (batch,) = _batches(1)
    losses = []
    for record in (False, True):
        trainer = _trainer(tiny, tmp_path / str(record))
        trainer._build_steps(views_shared=True)
        with recording() if record else contextlib.nullcontext() as rec:
            g, l = trainer._views(batch)
            metrics = trainer.train_step(trainer.state, 0, g, l)
        losses.append({k: float(v) for k, v in metrics.items()})
    assert losses[0] == losses[1]
    assert _names_in_order(rec.spans) == ["train/views", "train/upload", "train/step",
                                          *STEP_PHASES]
    (step,) = [s for s in rec.spans if s.name == "train/step"]
    phases = sorted((s for s in rec.spans if s.root == step.root and s is not step),
                    key=lambda s: s.start_ns)
    assert [s.name for s in phases] == STEP_PHASES
    assert all(s.parent == "train/step" for s in phases)
    for a, b in zip(phases, phases[1:]):
        assert a.end_ns <= b.start_ns
    views = [s for s in rec.spans if s.name.startswith("train/") and s.root != step.root]
    assert sorted(s.name for s in views) == ["train/upload", "train/views"]
    assert rec.counts == {"train/upload_bytes": batch["image"].nbytes}


def test_trace_writes_the_spans_beside_the_profilers_events(tiny, tmp_path):
    """``Trainer.run(profile_dir=...)``: the traced steps' spans in
    ``trace.json``, on the profiler's clock."""
    trainer = _trainer(tiny, tmp_path / "run")
    trainer.run(lambda epoch: _batches(4), max_steps=4, profile_dir=str(tmp_path / "prof"))
    events = json.loads((tmp_path / "prof" / profiling.TRACE_FILE).read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "program_span"]
    theirs = [e for e in events if "dur" in e and e.get("cat") != "program_span"]
    names = {e["name"] for e in ours}
    assert {"train/step", "train/views", "train/upload", "train/batch", "train/log",
            *STEP_PHASES} <= names
    assert sum(e["name"] == "train/step" for e in ours) == loop.PROFILE_STEPS
    lo = min(e["ts"] for e in theirs)
    hi = max(e["ts"] + e["dur"] for e in theirs)
    for e in ours:
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, e
        assert e["pid"] == profiling.SPANS_PID
    assert any(e.get("name") == "process_name" and e.get("pid") == profiling.SPANS_PID
               and e["args"]["name"] == "program spans" for e in events)
