"""Training visualisation: depth panels and loss and learning-rate curves.

Counterpart of distill_any_depth_tpu/utils/visualize.py
(``visualize_depth_predictions``, ``plot_history``), with the same files:
``visualizations/depth_step_{step}.png`` (a row of student | teacher |
abs-error panels for each of at most 2 samples) and ``plots/loss_curves.png``
and ``plots/lr_schedule.png``. They are drawn with cv2 and the port's own
colormap tables (``utils/image_util``), not matplotlib: each panel is
colorized over its own range (Spectral_r for depth, magma for the error)
with a title above it and a color bar at its right, marked with the range's
ends.
"""
from __future__ import annotations

import os

import numpy as np

from distill_any_depth_tpu_torch.utils.image_util import colorize_depth_maps

__all__ = ["visualize_depth_predictions", "plot_history"]

_TITLE_H, _BAR_W, _LABEL_W = 28, 14, 72  # pixels
_BLACK = (0, 0, 0)
_FONT_SCALE = 0.5
# curve colors (BGR) of train and validation: matplotlib's first two defaults
_BLUE, _ORANGE = (180, 119, 31), (14, 127, 255)


def _text(canvas: np.ndarray, text: str, org: tuple[int, int]) -> None:
    import cv2

    cv2.putText(canvas, text, org, cv2.FONT_HERSHEY_SIMPLEX, _FONT_SCALE, _BLACK, 1,
                cv2.LINE_AA)


def _bgr(rgb01: np.ndarray) -> np.ndarray:
    """[3, H, W] floats in [0, 1] -> [H, W, 3] uint8 BGR."""
    return np.ascontiguousarray((rgb01[::-1].transpose(1, 2, 0) * 255.0 + 0.5).astype(np.uint8))


def _panel(img: np.ndarray, cmap: str, title: str) -> np.ndarray:
    """``img`` [H, W] colorized over its range, the title above it and a
    color bar with the range's ends at its right."""
    h, w = img.shape
    lo, hi = float(np.nanmin(img)), float(np.nanmax(img))
    canvas = np.full((_TITLE_H + h, w + _BAR_W + _LABEL_W, 3), 255, np.uint8)
    canvas[_TITLE_H:, :w] = _bgr(colorize_depth_maps(img, lo, hi, cmap)[0])
    ramp = np.linspace(1.0, 0.0, h)[:, None].repeat(_BAR_W - 4, 1)
    canvas[_TITLE_H:, w + 4:w + _BAR_W] = _bgr(colorize_depth_maps(ramp, 0, 1, cmap)[0])
    _text(canvas, title, (4, _TITLE_H - 9))
    _text(canvas, f"{hi:.3g}", (w + _BAR_W + 2, _TITLE_H + 12))
    _text(canvas, f"{lo:.3g}", (w + _BAR_W + 2, _TITLE_H + h - 2))
    return canvas


def visualize_depth_predictions(student_depth, teacher_depth, step: int, output_dir: str,
                                max_samples: int = 2) -> str:
    """Save side-by-side student | teacher | abs-error panels of the first
    ``max_samples`` depth maps (``[B, H, W]`` each) as
    ``output_dir/visualizations/depth_step_{step}.png``; returns the path."""
    import cv2

    s = np.asarray(student_depth, np.float32)
    t = np.asarray(teacher_depth, np.float32)
    rows = []
    for i in range(min(max_samples, s.shape[0])):
        rows.append(np.concatenate([_panel(s[i], "Spectral_r", "student"),
                                    _panel(t[i], "Spectral_r", "teacher"),
                                    _panel(np.abs(s[i] - t[i]), "magma", "abs error")], 1))
    out_dir = os.path.join(output_dir, "visualizations")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"depth_step_{step}.png")
    if not cv2.imwrite(path, np.concatenate(rows, 0)):
        raise OSError(f"could not write {path}")
    return path


def _curves(series: list[tuple[list, str, tuple]], xlabel: str, ylabel: str,
            size: tuple[int, int] = (640, 400)) -> np.ndarray:
    """A line plot of each ``(values, label, color)`` against its index on
    shared axes, with the y range's ends, the axis names and a legend."""
    import cv2

    w, h = size
    left, right, top, bottom = 70, 20, 30, 40
    canvas = np.full((h, w, 3), 255, np.uint8)
    values = np.concatenate([np.asarray(v, np.float64) for v, _, _ in series])
    finite = values[np.isfinite(values)]
    lo, hi = (float(finite.min()), float(finite.max())) if finite.size else (0.0, 1.0)
    if hi == lo:  # one value: a band around it
        pad = 0.05 * abs(lo) or 0.5
        lo, hi = lo - pad, hi + pad
    n = max(len(v) for v, _, _ in series)
    cv2.rectangle(canvas, (left, top), (w - right, h - bottom), _BLACK, 1)
    for v, label, color in series:
        v = np.asarray(v, np.float64)
        x = left + (np.arange(len(v)) / max(n - 1, 1)) * (w - left - right)
        y = (h - bottom) - (v - lo) / (hi - lo) * (h - top - bottom)
        pts = np.stack([x, y], -1)[np.isfinite(y)].round().astype(np.int32)
        if len(pts) > 1:
            cv2.polylines(canvas, [pts], False, color, 2, cv2.LINE_AA)
        for px, py in pts:
            cv2.circle(canvas, (int(px), int(py)), 3, color, -1, cv2.LINE_AA)
    _text(canvas, f"{hi:.3g}", (4, top + 10))
    _text(canvas, f"{lo:.3g}", (4, h - bottom))
    _text(canvas, ylabel, (left, top - 10))
    _text(canvas, xlabel, (w // 2 - 20, h - 12))
    for i, (_, label, color) in enumerate(series):
        if label:
            y = top + 20 + 18 * i
            cv2.line(canvas, (w - right - 90, y - 4), (w - right - 70, y - 4), color, 2)
            _text(canvas, label, (w - right - 64, y))
    return canvas


def plot_history(history: dict, output_dir: str) -> list[str]:
    """Loss curves (train, and validation where there is one) by epoch and
    the learning rate by logged step, as PNGs under ``output_dir/plots``;
    returns the paths written."""
    import cv2

    out_dir = os.path.join(output_dir, "plots")
    os.makedirs(out_dir, exist_ok=True)
    plots = []
    if history.get("train_loss"):
        series = [(history["train_loss"], "train", _BLUE)]
        if history.get("val_loss"):
            series.append((history["val_loss"], "val", _ORANGE))
        plots.append(("loss_curves.png", _curves(series, "epoch", "loss")))
    if history.get("lr"):
        plots.append(("lr_schedule.png",
                      _curves([(history["lr"], "", _BLUE)], "step", "learning rate")))
    written = []
    for name, img in plots:
        path = os.path.join(out_dir, name)
        if not cv2.imwrite(path, img):
            raise OSError(f"could not write {path}")
        written.append(path)
    return written
