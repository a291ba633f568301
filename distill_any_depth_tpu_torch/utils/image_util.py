"""Depth visualization and file helpers used by the CLIs and the
evaluation registry: the port's own copy of ``normalize_disparity``,
``colorize_depth_maps``, ``chw2hwc``, ``read_pfm`` and ``write_pfm`` from
distill_any_depth_tpu/utils/image_util.py. The default colormap's table is
the port's own, so the inference CLI runs where matplotlib is absent."""
from __future__ import annotations

import re

import numpy as np

__all__ = ["colorize_depth_maps", "chw2hwc", "normalize_disparity", "read_pfm", "write_pfm"]


# matplotlib's "Spectral" colormap (ColorBrewer): its 11 control colors
_SPECTRAL = ((0.6196078431372549, 0.00392156862745098, 0.25882352941176473),
             (0.8352941176470589, 0.24313725490196078, 0.30980392156862746),
             (0.9568627450980393, 0.42745098039215684, 0.2627450980392157),
             (0.9921568627450981, 0.6823529411764706, 0.3803921568627451),
             (0.996078431372549, 0.8784313725490196, 0.5450980392156862),
             (1.0, 1.0, 0.7490196078431373),
             (0.9019607843137255, 0.9607843137254902, 0.596078431372549),
             (0.6705882352941176, 0.8666666666666667, 0.6431372549019608),
             (0.4, 0.7607843137254902, 0.6470588235294118),
             (0.19607843137254902, 0.5333333333333333, 0.7411764705882353),
             (0.3686274509803922, 0.30980392156862746, 0.6352941176470588))
_LUT_SIZE = 256


def _spectral_lut(reverse: bool) -> np.ndarray:
    """The ``[256, 3]`` lookup table of ``Spectral`` (``Spectral_r`` when
    ``reverse``), computed as matplotlib's ``LinearSegmentedColormap``
    computes it (equal bit for bit), so that the CLIs colorize on a machine
    without matplotlib."""
    n = _LUT_SIZE
    ctrl = np.array(_SPECTRAL)
    vals = np.linspace(0, 1, len(ctrl))
    lut = []
    for c in range(3):
        data = np.column_stack([vals, ctrl[:, c], ctrl[:, c]])
        if reverse:
            data = np.array([(1.0 - x, y1, y0) for x, y0, y1 in reversed(data)])
        x, y0, y1 = data[:, 0] * (n - 1), data[:, 1], data[:, 2]
        xind = (n - 1) * np.linspace(0, 1, n)
        ind = np.searchsorted(x, xind)[1:-1]
        dist = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut.append(np.clip(np.concatenate(
            [[y1[0]], dist * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]]), 0.0, 1.0))
    return np.stack(lut, -1)


def colorize_depth_maps(depth_map, min_depth: float, max_depth: float,
                        cmap: str = "Spectral_r") -> np.ndarray:
    """Colorize ``[H, W]``, ``[B, H, W]`` or ``[B, 1, H, W]`` depth as
    ``[B, 3, H, W]`` float in [0, 1]. ``Spectral`` and ``Spectral_r`` use
    the port's copy of matplotlib's table; other maps need matplotlib."""
    depth = np.asarray(depth_map).astype(np.float32)
    if depth.ndim == 2:
        depth = depth[None]
    elif depth.ndim == 4:
        depth = depth[:, 0]
    if depth.ndim != 3:
        raise ValueError(f"depth must be 2-, 3- or 4-D, got shape {depth.shape}")
    span = max(max_depth - min_depth, 1e-8)
    norm = np.clip((depth - min_depth) / span, 0, 1)
    if cmap in ("Spectral", "Spectral_r"):
        # matplotlib's float lookup: x * N truncated, 1.0 onto the last entry
        xa = norm * _LUT_SIZE
        xa[xa == _LUT_SIZE] = _LUT_SIZE - 1
        bad = np.isnan(xa)
        colored = _spectral_lut(cmap.endswith("_r"))[np.where(bad, 0, xa).astype(int)]
        colored[bad] = 0.0  # matplotlib's "bad" color
    else:
        import matplotlib

        colored = matplotlib.colormaps[cmap](norm, bytes=False)[:, :, :, 0:3]  # [B,H,W,3]
    return np.rollaxis(colored, 3, 1)


def chw2hwc(chw: np.ndarray) -> np.ndarray:
    return np.moveaxis(np.asarray(chw), 0, -1)


def normalize_disparity(disp: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0, 1]."""
    disp = np.asarray(disp, np.float32)
    span = disp.max() - disp.min()
    return (disp - disp.min()) / (span + 1e-8)


def read_pfm(path: str) -> tuple[np.ndarray, float]:
    """A PFM depth or disparity file -> (array, scale); rows top first."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"not a PFM file: {path}")
        color = header == "PF"
        dims = f.readline().decode("latin-1")
        m = re.match(r"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"malformed PFM dimensions: {dims!r}")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("latin-1").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    data = data.reshape((h, w, 3) if color else (h, w))
    return np.flipud(data), abs(scale)


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 ``[H, W]`` or ``[H, W, 3]`` array as little-endian PFM."""
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        header = b"PF\n"
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        header = b"Pf\n"
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError(f"unsupported PFM shape {image.shape}")
    with open(path, "wb") as f:
        f.write(header)
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())  # negative: little-endian
        np.flipud(image).astype("<f4").tofile(f)
