"""Depth visualization and file helpers used by the CLIs and the
evaluation registry: the port's own copy of ``normalize_disparity``,
``colorize_depth_maps``, ``chw2hwc``, ``read_pfm``, ``write_pfm``,
``depth_to_point_cloud`` and ``write_ply`` from
distill_any_depth_tpu/utils/image_util.py. The tables of the default
colormap and of ``magma`` (the visualisation's error panels) are the port's
own, so the CLIs and the training visualisation run where matplotlib is
absent."""
from __future__ import annotations

import re

import numpy as np

__all__ = ["colorize_depth_maps", "chw2hwc", "normalize_disparity", "read_pfm", "write_pfm",
           "depth_to_point_cloud", "write_ply"]


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
# matplotlib's "magma" at 17 of its 256 entries (0, 16, 32, ..., 239, 255):
# linear interpolation between them stays within 0.01 of matplotlib's table
_MAGMA = ((0.0015, 0.0005, 0.0139), (0.0396, 0.0311, 0.1335), (0.1131, 0.0655, 0.2768),
          (0.2117, 0.0620, 0.4186), (0.3167, 0.0717, 0.4854), (0.4147, 0.1104, 0.5047),
          (0.5128, 0.1482, 0.5076), (0.6136, 0.1818, 0.4985), (0.7164, 0.2150, 0.4753),
          (0.8109, 0.2529, 0.4393), (0.8996, 0.3146, 0.3910), (0.9585, 0.4113, 0.3600),
          (0.9857, 0.5281, 0.3794), (0.9958, 0.6463, 0.4414), (0.9970, 0.7624, 0.5288),
          (0.9928, 0.8772, 0.6331), (0.9871, 0.9914, 0.7495))


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


def _magma_lut() -> np.ndarray:
    """The ``[256, 3]`` table of ``magma`` from ``_MAGMA``."""
    ctrl = np.array(_MAGMA)
    at = np.round(np.linspace(0, _LUT_SIZE - 1, len(ctrl)))
    return np.stack([np.interp(np.arange(_LUT_SIZE), at, ctrl[:, c]) for c in range(3)], -1)


def colorize_depth_maps(depth_map, min_depth: float, max_depth: float,
                        cmap: str = "Spectral_r") -> np.ndarray:
    """Colorize ``[H, W]``, ``[B, H, W]`` or ``[B, 1, H, W]`` depth as
    ``[B, 3, H, W]`` float in [0, 1]. ``Spectral``, ``Spectral_r`` and
    ``magma`` use the port's tables; other maps need matplotlib."""
    depth = np.asarray(depth_map).astype(np.float32)
    if depth.ndim == 2:
        depth = depth[None]
    elif depth.ndim == 4:
        depth = depth[:, 0]
    if depth.ndim != 3:
        raise ValueError(f"depth must be 2-, 3- or 4-D, got shape {depth.shape}")
    span = max(max_depth - min_depth, 1e-8)
    norm = np.clip((depth - min_depth) / span, 0, 1)
    if cmap in ("Spectral", "Spectral_r", "magma"):
        lut = _magma_lut() if cmap == "magma" else _spectral_lut(cmap.endswith("_r"))
        # matplotlib's float lookup: x * N truncated, 1.0 onto the last entry
        xa = norm * _LUT_SIZE
        xa[xa == _LUT_SIZE] = _LUT_SIZE - 1
        bad = np.isnan(xa)
        colored = lut[np.where(bad, 0, xa).astype(int)]
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


def depth_to_point_cloud(depth: np.ndarray, fx: float, fy: float, cx: float | None = None,
                         cy: float | None = None, rgb: np.ndarray | None = None,
                         mask: np.ndarray | None = None):
    """Back-project a depth map ``[H, W]`` through a pinhole camera: ``(points
    [N, 3], colors [N, 3] or None)``, the principal point at the image
    centre by default; ``mask`` keeps the pixels where it is true."""
    depth = np.asarray(depth, np.float32)
    h, w = depth.shape
    cx = (w - 1) / 2 if cx is None else cx
    cy = (h - 1) / 2 if cy is None else cy
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z = depth
    x = (xs - cx) * z / fx
    y = (ys - cy) * z / fy
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    colors = None if rgb is None else np.asarray(rgb).reshape(-1, 3)
    if mask is not None:
        m = np.asarray(mask, bool).reshape(-1)
        pts = pts[m]
        if colors is not None:
            colors = colors[m]
    return pts, colors


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Write an ASCII PLY point cloud, with uint8 colors if given (float
    colors in [0, 1] are scaled by 255)."""
    points = np.asarray(points, np.float32)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {points.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            for p in points:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
            return
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = np.clip(c * 255 if c.max() <= 1.0 else c, 0, 255).astype(np.uint8)
        for p, col in zip(points, c):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {col[0]} {col[1]} {col[2]}\n")
