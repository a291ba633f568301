"""The control comes out not correct: the reference computed with float8
products in the program's place fails one of a cell's numbers.

On the CPU at a tiny size against the tiny cells' limits; on the card
(marked ``cuda``) at each cell's own configuration and traffic against its
own limits, on two seeds with a short window (``python -m pytest
portbench/tests -m cuda`` on a machine with a card; the limits' readings over
a dozen seeds come from ``python3 -m portbench.readings``)."""
from __future__ import annotations

import pytest
import torch

from portbench import check, readings, spec
from portbench.tests import tiny


@pytest.mark.parametrize("cell", [tiny.infer_cell(), tiny.train_cell()], ids=["infer", "train"])
def test_the_control_fails_a_tiny_cell(cell):
    torch.set_num_threads(4)
    out = readings.readings(cell, [2 ** 31 + 21], 0.3, "cpu")
    assert check.judge(out["lower"], cell.limits)[0]
    assert not check.judge(out["upper"], cell.limits)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_the_control_fails_each_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the port's CUDA kernels")
    cell = spec.load_cell(name)
    out = readings.readings(cell, [4_000_000_001, 4_000_000_002], 2.0, "cuda")
    upper = {k: v for k, v in out["upper"].items() if k in cell.limits}
    if "batch_gap" in cell.limits:  # the control decodes no files: the loader's batch is exact
        upper["batch_gap"] = out["lower"]["batch_gap"]
    assert check.judge(out["lower"], cell.limits)[0], out
    assert not check.judge(upper, cell.limits)[0], out
