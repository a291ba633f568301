"""A run on the CPU at a tiny size, past the look for a card: sound, it is
correct; with the timed path broken underneath, ``correct`` comes out false,
once for each fault a one-card cell can have (no cell exchanges data between
cards)."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import check, faults, harness
from portbench.tests import tiny

SEED = 2 ** 31 + 77


def _run(cell, program=None, seconds=0.5):
    torch.set_num_threads(4)
    _, numbers = harness.run_cell(cell, SEED, seconds, False, "cpu", time.perf_counter(),
                                  program)
    return check.judge(numbers, cell.limits)


def test_sound_runs_are_correct():
    for cell in (tiny.infer_cell(), tiny.train_cell()):
        correct, checks = _run(cell)
        assert correct, checks


@pytest.mark.parametrize("fault", sorted(faults.PREDICT))
def test_an_infer_fault_is_not_correct(fault):
    correct, checks = _run(tiny.infer_cell(), harness.Program(predict_wrapper=faults.PREDICT[fault]))
    assert not correct, checks


@pytest.mark.parametrize("fault", sorted(faults.STEP))
def test_a_train_fault_is_not_correct(fault):
    correct, checks = _run(tiny.train_cell(), harness.Program(step_wrapper=faults.STEP[fault]))
    assert not correct, checks


def test_a_wrong_batch_from_the_loader_is_not_correct(monkeypatch):
    from distill_any_depth_tpu_torch.data import nyu

    load = nyu.NYUDataset._load

    def shifted(self, index):  # the loader reads the next pair instead of the asked one
        return load(self, (index + 1) % len(self))

    monkeypatch.setattr(nyu.NYUDataset, "_load", shifted)
    correct, checks = _run(tiny.train_cell("nyu"))
    assert not correct and checks["batch_gap"]["value"] > 0, checks
