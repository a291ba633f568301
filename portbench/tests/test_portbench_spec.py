"""Every cell of ``BENCHMARK.json`` resolves to its files, and the file
keeps to the benchmark's contract where a test can see it."""
from __future__ import annotations

import json
import os
import re

import pytest

from portbench import reference, spec

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_resolves(name):
    cell = spec.load_cell(name)
    assert cell.chips == 1 and cell.limits
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        if "moves" in m:
            assert m["moves"] in e2e
    models = [cell.config[k] for k in ("model", "student", "teacher") if k in cell.config]
    for m in models:
        assert reference.module(m["reference"]).param_specs(m)
    assert cell.config["reduced"] == []


def test_names_units_and_entries():
    seen = set()
    for key, allowed in (("configs", {"name", "source", "file", "reduced", "why"}),
                         ("workloads", {"name", "config", "traffic", "chips", "why"}),
                         ("end_to_end", {"name", "unit", "better", "bound", "source",
                                         "workloads"}),
                         ("per_layer", {"name", "unit", "better", "source", "layer", "moves",
                                        "workloads"})):
        for entry in BENCH[key]:
            assert set(entry) <= allowed, entry
            assert NAME.match(entry["name"]) and entry["name"] not in seen
            seen.add(entry["name"])
            if "unit" in entry:
                assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", entry["unit"])
                assert entry["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
            if key == "configs":
                assert entry["file"].startswith("portbench/")
    bounds = {m["name"]: m["bound"] for m in BENCH["end_to_end"]}
    assert bounds["setup_s"] <= 0.25 and all(0.01 <= b <= 0.25 for b in bounds.values())
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(WORKLOADS)
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_every_file_under_paths_is_named_from_name_characters():
    for top, _, files in os.walk(os.path.join(spec.ROOT, "portbench")):
        if "__pycache__" in top or "cache" in top.split(os.sep):
            continue
        for f in files:
            assert re.match(r"^[A-Za-z0-9_.-]+$", f), f


def _refused(cell, match):
    import time

    from portbench import harness

    with pytest.raises((ValueError, TypeError), match=match):
        harness.run(cell, 1, 0.1, False, "cpu", time.perf_counter())


def test_a_configuration_key_that_no_one_reads_is_refused():
    from portbench.tests import tiny

    cell = tiny.infer_cell()
    cell.config["compute_dtype"] = "bfloat16"
    _refused(cell, "no one reads")
    cell = tiny.train_cell()
    cell.config["train"]["teacher_quant_mode"] = "int8"  # not a TrainConfig field
    _refused(cell, "teacher_quant_mode")


@pytest.mark.parametrize("change, match", [
    ({"embed_dim": 768}, "embed_dim"),
    ({"qkv_bias": True}, "read by neither"),
    ({"preset": "depthanything-base-window", "embed_dim": 768, "num_heads": 12, "features": 128,
      "out_channels": [96, 192, 384, 768], "base_img_size": 224}, "use_pos_conv"),
], ids=["size", "unknown key", "another model"])
def test_a_model_entry_the_preset_or_reference_does_not_match_is_refused(change, match):
    from portbench.tests import tiny

    cell = tiny.infer_cell()
    cell.config["model"].update(change)
    _refused(cell, match)


@pytest.mark.parametrize("path, value, match", [
    (("teacher_quant",), "int8_pallas", "does not compute"),
    (("loss", "hdn_variant"), "ds", "does not compute"),
    (("optimizer", "warmup_steps"), 10, "does not compute"),
], ids=["int8 teacher", "hdn variant", "warmup"])
def test_the_reference_step_refuses_what_it_does_not_compute(path, value, match):
    from portbench.tests import tiny

    cell = tiny.train_cell()
    node = cell.config["train"]
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    _refused(cell, match)


def test_adam_must_be_the_configured_one():
    from portbench.tests import tiny

    cell = tiny.train_cell()
    cell.config["adam"]["beta2"] = 0.99
    _refused(cell, "betas")


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_reader_of_a_cell_reads_its_files(name):
    """Each metric of the cell read from a run's context and a trace that
    holds one operation of every kernel the readers look for."""
    from portbench import harness, tracing

    cell = spec.load_cell(name)
    spans = tracing.Spans(True)
    for span in ("predict.forward", "step.enqueue", "loader.wait", "teacher.forward"):
        spans.add(span, 0, 10)
    names = ["packed_attn_wgmma<bf16>", "dq_wgmma<bf16>", "kth_select_kernel",
             "tail_conv_wgmma<128>", "nvjet_gemm"]
    trace = tracing.Trace(ops=[(n, 20 + 10 * i, 25 + 10 * i) for i, n in enumerate(names)],
                          start_ns=0, end_ns=100, units=1, spans=spans.items,
                          launch_ns=[5] * len(names))
    ctx = harness.Ctx(cell=cell, setup_s=1.0, window_s=1.0, images=8, units=1,
                      latencies_ms=[1.0, 2.0], ends_s=[0.5, 1.0], peak_window_bytes=2 ** 30,
                      spans=spans, trace=trace)
    for m in cell.end_to_end + cell.per_layer:
        value = spec.metric_reader(m["name"])(ctx)
        assert isinstance(value, float) and value > 0, (m["name"], value)
