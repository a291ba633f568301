"""One run of a cell: its driver, the correctness check, and the context the
metric readers read.

A traffic mix names its driver, ``portbench/drivers/<driver>.py``. The
driver builds the program from the cell's configuration, runs the measured
window (and with ``--trace 1`` the traced one), frees the program and hands
back what the timed path produced, its outcome. Its ``reference`` works the
same out again with the plain reference, and its ``compare`` gives the
numbers that the cell's limits judge. A driver states the configuration
keys it reads (``CONFIG_KEYS``): a configuration with a key that no one
reads is refused, and so is a model entry that the program's preset or the
entry's reference (``check_preset``) does not account for.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import os
import statistics
import time

import torch

from portbench import inputs, reference
from portbench.spec import ROOT, Cell

__all__ = ["Ctx", "Program", "driver", "check_preset", "build_model", "run", "run_cell"]

CACHE = os.path.join(ROOT, "portbench", "cache")  # under the checkout; git-ignored
COMMON_KEYS = ("name", "source", "described_as", "reduced", "assumed")


@dataclasses.dataclass
class Ctx:
    """What a metric reader reads (``portbench/metrics/<name>.py``)."""

    cell: Cell
    setup_s: float
    window_s: float = 0.0
    images: int = 0
    units: int = 0  # predict calls or train steps in the window
    failed: int = 0
    latencies_ms: list = dataclasses.field(default_factory=list)
    ends_s: list = dataclasses.field(default_factory=list)  # each call's or step's end
    peak_window_bytes: int = 0  # the window's peak allocation
    peak_bytes: int = 0  # the program's peak allocation over the run, before the reference
    spans: object = None  # tracing.Spans of the measured window
    trace: object = None  # tracing.Trace of the traced window
    phases: dict = dataclasses.field(default_factory=dict)  # set-up's parts, s (stderr only)

    def model(self, role: str = "model") -> dict:
        return self.cell.config[role]

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


@dataclasses.dataclass
class Program:
    """How the program is run: a test or a reading may break or watch a
    piece of it."""

    step_wrapper: object = None  # wraps the train step (faults)
    predict_wrapper: object = None  # wraps predict (faults)
    keep_grad0: bool = False  # keep the first gradient's tensors (readings)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def reset_peak(device) -> int:
    """The peak so far; then a new peak starts."""
    so_far = peak(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    return so_far


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def driver(name: str):
    """The driver module ``portbench/drivers/<name>.py``."""
    if not name.isidentifier():
        raise ValueError(f"not a driver name: {name!r}")
    return importlib.import_module(f"portbench.drivers.{name}")


def _preset_attributes(cfg) -> dict:
    have = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    have.update({f.name: getattr(cfg.encoder, f.name) for f in dataclasses.fields(cfg.encoder)})
    return {k: list(v) if isinstance(v, tuple) else v for k, v in have.items()}


def check_preset(m: dict) -> None:
    """The program's preset ``m["preset"]`` is the model that the entry ``m``
    states and that its reference computes: each attribute of the preset is
    one the reference reads (and equal to ``m``'s), one it computes at a
    fixed value only (``REQUIRES``), or one that changes nothing
    (``IGNORES``); and ``m`` has no key that neither side reads."""
    from distill_any_depth_tpu_torch.configs import model_config

    ref = reference.module(m["reference"])
    wrong = {}
    for k, v in _preset_attributes(model_config(m["preset"])).items():
        if k in ref.READS:
            if v != m[k]:
                wrong[k] = (v, m[k])
        elif k in ref.REQUIRES:
            if v != ref.REQUIRES[k]:
                wrong[k] = (v, ref.REQUIRES[k])
        elif k not in ref.IGNORES:
            wrong[k] = (v, f"unknown to reference {m['reference']}")
    for k in set(m) - set(ref.READS) - set(ref.WEIGHT_KEYS) - {"preset", "reference"}:
        wrong[k] = (m[k], "read by neither the program nor the reference")
    if wrong:
        raise ValueError(f"preset {m['preset']} is not the configured model: {wrong}")


def check_options(m: dict, options: dict) -> None:
    """``options`` of ``create_model`` are ones that ``m``'s reference computes."""
    ref = reference.module(m["reference"])
    wrong = {k: options[k] for k, v in ref.OPTIONS.items() if options.get(k, v) != v}
    if wrong:
        raise ValueError(f"reference {m['reference']} does not compute {wrong}")


def build_model(m: dict, create: dict, device, seed: int, salt: str):
    """The program's ``DepthModel`` for ``m``, built on ``device`` by
    ``create_model(**create)`` without its own seeded init (``create``'s
    ``dtype`` by name), holding the benchmark's weights."""
    from distill_any_depth_tpu_torch.models.factory import create_model

    check_preset(m)
    check_options(m, create)
    kw = {**create, "dtype": getattr(torch, create.get("dtype", "float32"))}
    with torch.device(device):
        model = create_model(m["preset"], device=device, seed=None, **kw)
    model.load_state_dict(inputs.make_weights(m, seed, salt, device), strict=True)
    return model


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        program: Program | None = None):
    """Set up and measure one run of ``cell``; returns its driver, the
    readers' context and the outcome of the timed path."""
    drv = driver(cell.traffic["driver"])
    extra = set(cell.config) - set(COMMON_KEYS) - set(drv.CONFIG_KEYS)
    if extra:
        raise ValueError(f"configuration keys that no one reads: {sorted(extra)}")
    t_run = time.perf_counter()
    ctx, outcome = drv.run(cell, seed, seconds, trace, torch.device(device), t_start,
                           program or Program())
    ctx.phases = {"start": t_run - t_start, **ctx.phases}
    return drv, ctx, outcome


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             program: Program | None = None):
    """One run and its check: the readers' context and the numbers that the
    cell's limits judge."""
    drv, ctx, outcome = run(cell, seed, seconds, trace, device, t_start, program)
    return ctx, drv.compare(outcome, drv.reference(cell, seed, outcome, torch.device(device)))


class Phases:
    """Seconds of each part of set-up, each from the end of the last."""

    def __init__(self):
        self.last, self.seconds = time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now


def quarters(ctx: Ctx) -> list[float]:
    """Calls or steps a second in each quarter of the window, by their ends
    (a step's end on the host is its enqueue's): how steady the window was."""
    q = ctx.window_s / 4
    return [sum(1 for e in ctx.ends_s if k * q <= e < (k + 1) * q) / q for k in range(4)]


def p95(values: list) -> float:
    """The 95th percentile, inclusive of the ends (n=20 cut points)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]
