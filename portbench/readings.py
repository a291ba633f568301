"""The readings that a cell's correctness limits are set from, on the card.

    python3 -m portbench.readings --workload <name> --seeds 1,2,3 [--seconds 3]
        [--fault_seeds N] [--leaves K] [--set train.teacher_dtype="float32" ...]

For each seed, in one process: the program's numbers (a run of the cell
with a short window; a training cell's come from the set-up's steps) and
the control's: the reference computed with float8 products (the reference
model's ``quant="fp8"``) in the program's place. Besides the numbers that
the driver's ``compare`` gives, a training cell reads ``loss_gap`` (every
step's loss), the worst and the median parameter's gap of the first
gradient as the optimizer took it (``grad_gap``, ``grad_median_gap``; a gap
of norms is taken against the larger of that parameter's reference norm and
the median parameter's). With ``--fault_seeds N`` a training cell also reads each of
``faults.STEP`` on its first N seeds; with ``--leaves K`` the K parameters
with the widest change and first-gradient gaps, each with its size, the
elements kept for its change, its norms on both sides and the share of its
elements whose first gradient has the other sign than the reference's.
``--set`` overrides a configuration
value (a dotted path and a JSON value), to read the program another way.
Prints one JSON line a seed and a summary: the largest program reading and
the smallest control reading of each number. The benchmark's runs never
run this.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import statistics
import sys
import time

import torch

from portbench import faults, harness, spec

__all__ = ["readings", "override", "train_readings", "leaves"]


def override(cell, sets: list[str]):
    """``cell`` with each ``path=json`` of ``sets`` set in its configuration."""
    config = copy.deepcopy(cell.config)
    for item in sets:
        path, value = item.split("=", 1)
        *parents, last = path.split(".")
        node = config
        for key in parents:
            node = node[key]
        if last not in node:
            raise KeyError(f"the configuration has no {path!r}")
        node[last] = json.loads(value)
    return dataclasses.replace(cell, config=config)


def _worst_leaf(prog: dict, ref: dict, names) -> float:
    median = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], median) for n in names)


def train_readings(outcome: dict, ref: dict) -> dict:
    """The readings-only numbers of a training cell."""
    from portbench.drivers.train import COMPONENTS

    gaps = [max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-6) for k in COMPONENTS)
            for p, r in zip(outcome["losses"], ref["losses"])]
    names = list(ref["taken0"])
    return {"loss_gap": max(gaps),
            "grad_gap": _worst_leaf(outcome["taken0"], ref["taken0"], names),
            "grad_median_gap": statistics.median(
                abs(outcome["taken0"][n] - ref["taken0"][n]) / ref["taken0"][n] for n in names)}


def leaves(cell, outcome: dict, ref: dict, k: int) -> dict:
    """The ``k`` parameters with the widest change gap (over their kept
    elements) and the ``k`` with the widest first-gradient gap
    (``_worst_leaf``'s measure), and the median parameter by the change gap,
    each with its numbers."""
    from portbench.drivers.train import masked_norms

    prog, refc = masked_norms(outcome["change_tensors"], ref["masks"]), ref["change"]
    med_change = statistics.median(refc.values())
    med_grad = statistics.median(ref["taken0"].values())
    lr, steps = cell.config["train"]["optimizer"]["lr"], len(outcome["losses"])

    def row(n):
        g, r = outcome.get("taken0_tensors", {}).get(n), ref.get("taken0_tensors", {}).get(n)
        mask = ref["masks"].get(n)
        kept = int(mask.sum()) if mask is not None else 0
        out = {"name": n, "size": int(outcome["change_tensors"][n].numel()), "kept": kept,
               "change": [prog.get(n, 0.0), refc.get(n, 0.0)],
               "change_gap": abs(prog.get(n, 0.0) - refc.get(n, 0.0))
               / max(refc.get(n, 0.0), med_change),
               "grad": [outcome["taken0"][n], ref["taken0"][n]],
               "grad_gap": abs(outcome["taken0"][n] - ref["taken0"][n])
               / max(ref["taken0"][n], med_grad)}
        if kept:
            # Adam moves each element about lr a step: a change of lr * steps
            # * sqrt(size) keeps one sign throughout, sqrt(steps) of it a random walk
            out["coherence"] = [c / (lr * steps * math.sqrt(kept)) for c in out["change"]]
        if g is not None and r is not None:
            out["sign_flip"] = float((torch.sign(g) != torch.sign(r)).float().mean())
        return out

    by_change = sorted(refc, key=lambda n: -abs(prog[n] - refc[n]) / max(refc[n], med_change))
    by_grad = sorted(ref["taken0"], key=lambda n: -abs(outcome["taken0"][n] - ref["taken0"][n])
                     / max(ref["taken0"][n], med_grad))
    return {"change": [row(n) for n in by_change[:k]],
            "median": row(by_change[len(by_change) // 2]),
            "grad": [row(n) for n in by_grad[:k]]}


def readings(cell, seeds, seconds: float, device: str = "cuda", fault_seeds: int = 0,
             k_leaves: int = 0) -> dict:
    rows = []
    train = cell.traffic["driver"] == "train"
    dev = torch.device(device)
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        drv, _, outcome = harness.run(cell, seed, seconds, False, device, t,
                                      harness.Program(keep_grad0=bool(k_leaves)))
        keep = {"keep_grad0": True} if k_leaves and train else {}
        ref = drv.reference(cell, seed, outcome, dev, **keep)

        def numbers(out):
            return {**drv.compare(out, ref), **(train_readings(out, ref) if train else {})}

        row = {"seed": seed, "program": numbers(outcome)}
        if k_leaves and train:
            row["leaves"] = leaves(cell, outcome, ref, k_leaves)
        if train:
            outcome.pop("taken0_tensors", None)
            ref.pop("taken0_tensors", None)
        row["control"] = numbers(drv.reference(cell, seed, outcome, dev, "fp8"))
        del outcome
        if train and i < fault_seeds:
            for name in sorted(faults.STEP):
                _, _, out = harness.run(cell, seed, seconds, False, device, time.perf_counter(),
                                        harness.Program(step_wrapper=faults.STEP[name]))
                row[name] = numbers(out)
        rows.append({**row, "s": time.perf_counter() - t})
        print(json.dumps(rows[-1]), flush=True)
    names = rows[0]["program"]
    out = {"lower": {n: max(r["program"][n] for r in rows) for n in names},
           "upper": {n: min(r["control"][n] for r in rows) for n in rows[0]["control"]},
           "seeds": len(rows)}
    for name in faults.STEP:
        read = [r[name] for r in rows if name in r]
        if read:
            out[name] = {n: min(x[n] for x in read) for n in read[0]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault_seeds", type=int, default=0,
                   help="a training cell: read the step's faults on the first N seeds")
    p.add_argument("--leaves", type=int, default=0,
                   help="a training cell: the K parameters with the widest gaps")
    p.add_argument("--set", action="append", default=[], metavar="PATH=JSON",
                   help="override a configuration value")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.readings needs a CUDA card", file=sys.stderr)
        return 3
    cell = override(spec.load_cell(args.workload), args.set)
    summary = readings(cell, [int(s) for s in args.seeds.split(",")], args.seconds,
                       fault_seeds=args.fault_seeds, k_leaves=args.leaves)
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
