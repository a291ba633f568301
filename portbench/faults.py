"""Faults planted under the timed path, for the readings that set a
training cell's limits (``readings --fault_seeds``) and for the CPU tests
that see ``correct`` come out false: each wraps the program's ``predict`` or
train step (``harness.Program``'s wrappers)."""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["answer_altered", "half_answered", "state_unchanged", "half_batch",
           "loss_altered", "PREDICT", "STEP"]


def answer_altered(predict):
    """One image's answer altered where ``predict`` produces it: the last
    image given the first one's depth."""
    @functools.wraps(predict)
    def wrapped(*args, **kw):
        out = predict(*args, **kw)
        out[-1] = out[0]
        return out
    return wrapped


def half_answered(predict):
    """Half of the images left out, answered by the other half's depths."""
    @functools.wraps(predict)
    def wrapped(model, images, res, batch_size):
        half = predict(model, images[:len(images) // 2], res, batch_size=batch_size)
        return np.concatenate([half, half])
    return wrapped


def state_unchanged(step):
    """A step that returns the parameters as it found them."""
    def wrapped(state, *args):
        before = [p.detach().clone() for p in state.params]
        metrics = step(state, *args)
        with torch.no_grad():
            for p, b in zip(state.params, before):
                p.copy_(b)
        return metrics
    return wrapped


def half_batch(step):
    """Half of the batch left out, the losses' means taken over the rest."""
    def wrapped(state, idx, g, l):
        return step(state, idx, g[:g.shape[0] // 2], l[:l.shape[0] // 2])
    return wrapped


def loss_altered(step):
    """A loss component altered where the step produces it (by 10%)."""
    def wrapped(*args):
        metrics = step(*args)
        metrics["hdn"] = metrics["hdn"] * 1.1
        return metrics
    return wrapped


PREDICT = {f.__name__: f for f in (answer_altered, half_answered)}
STEP = {f.__name__: f for f in (state_unchanged, half_batch, loss_altered)}
