"""Everything a run feeds the program, made from ``--seed``: weights,
images, in-memory training batches and NYU-Depth-V2 files.

Weights and images are drawn on the run's device by a generator seeded from
``(seed, salt)``, in a few large calls. The same seed gives the same
tensors, and the reference draws its copy the same way, so nothing the
program holds is read back as an input.
"""
from __future__ import annotations

import csv
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench import reference
from portbench.reference.images import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["generator", "rng", "make_weights", "synthetic_images", "memory_batches", "nyu_files"]

SALTS = {"student": 1, "teacher": 2, "images": 3, "order": 4, "files": 5, "sample": 6}


def _seed_of(seed: int, salt: str) -> int:
    return int(np.random.SeedSequence([seed % 2 ** 64, SALTS[salt]]).generate_state(
        1, np.uint64)[0] >> 1)


def generator(seed: int, salt: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_seed_of(seed, salt))


def rng(seed: int, salt: str) -> np.random.Generator:
    return np.random.default_rng(_seed_of(seed, salt))


def make_weights(m: dict, seed: int, salt: str, device) -> dict:
    """Every parameter of the model ``m`` (its reference's ``param_specs``):
    one normal draw for all the random ones (clamped at 2 standard
    deviations, each leaf scaled to its own), constants for norms, biases
    and LayerScale."""
    specs = reference.module(m["reference"]).param_specs(m)
    total = sum(int(np.prod(shape)) for _, shape, kind, _ in specs if kind != "const")
    flat = torch.randn(total, generator=generator(seed, salt, device), device=device)
    flat.clamp_(-2.0, 2.0).mul_(1.0 / 0.9594462)  # unit variance after the clamp
    out, off = {}, 0
    for name, shape, kind, value in specs:
        if kind != "const":
            n = int(np.prod(shape))
            out[name] = flat[off:off + n].view(shape) * value
            if kind == "abs_normal":
                out[name].abs_()
            off += n
        else:
            out[name] = torch.full(shape, float(value), device=device)
    return out


def synthetic_images(gen: torch.Generator, n: int, hw, device) -> torch.Tensor:
    """``n`` uint8 RGB frames ``[n, H, W, 3]`` on ``device``: per frame, a
    few plane waves per channel at frequencies drawn over a wide range,
    a few soft blobs, its own contrast and brightness, and sensor-like noise,
    so that frames differ from one another as scenes do and the depth heads
    and the codecs see structure at several scales."""
    h, w = hw
    yy = torch.linspace(0, 1, h, device=device)[:, None]
    xx = torch.linspace(0, 1, w, device=device)[None, :]
    r = torch.rand(n, 3, 4, 4, generator=gen, device=device)
    freq = torch.exp(r[..., :2] * 3.4) * (2.0 * r[..., 2:3] > 0.5)  # 1-30 cycles, some off
    phase = r[..., 3] * 6.2832
    img = torch.zeros(n, 3, h, w, device=device)
    for k in range(4):
        arg = (freq[:, :, k, 0, None, None] * yy + freq[:, :, k, 1, None, None] * xx
               + phase[:, :, k, None, None])
        img += torch.sin(arg) / (k + 1)
    blobs = torch.rand(n, 6, 4, generator=gen, device=device)
    for k in range(6):
        cy, cx = blobs[:, k, 0, None, None], blobs[:, k, 1, None, None]
        rad = 0.03 + 0.25 * blobs[:, k, 2, None, None]
        amp = 3.0 * (blobs[:, k, 3, None, None] - 0.5)
        img += (amp * torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (rad * rad)))[:, None]
    look = torch.rand(n, 3, generator=gen, device=device)
    img = img * (0.1 + 0.25 * look[:, 0, None, None, None]) + 0.2 + 0.6 * look[:, 1, None,
                                                                               None, None]
    img += (0.005 + 0.03 * look[:, 2, None, None, None]) * torch.randn(
        img.shape, generator=gen, device=device)
    img = img.clamp(0, 1) * 255.0
    return img.round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def memory_batches(seed: int, count: int, batch: int, res: int, device) -> list[np.ndarray]:
    """``count`` NHWC float32 batches of distinct normalized ``res`` images,
    in host memory: what ``data/nyu.NYUDataset`` hands the step."""
    gen = generator(seed, "images", device)
    mean = torch.from_numpy(IMAGENET_MEAN).to(device)
    std = torch.from_numpy(IMAGENET_STD).to(device)
    out = []
    for _ in range(count):
        x = synthetic_images(gen, batch, (res, res), device).float() / 255.0
        out.append(((x - mean) / std).cpu().numpy())
    return out


def _depth_maps(gen: torch.Generator, n: int, hw, device) -> torch.Tensor:
    """Smooth uint8 depth maps ``[n, H, W]``: a random plane plus a few
    blobs, as an indoor scene's depth in DenseDepth's 8-bit training PNGs."""
    h, w = hw
    yy = torch.linspace(0, 1, h, device=device)[:, None]
    xx = torch.linspace(0, 1, w, device=device)[None, :]
    p = torch.rand(n, 8, generator=gen, device=device)
    d = 0.3 + 0.4 * p[:, 0, None, None] * yy + 0.3 * p[:, 1, None, None] * xx
    for k in range(3):
        cy, cx, r = p[:, 2 + k, None, None], p[:, 5 + k, None, None], 0.05 + 0.1 * p[:, k,
                                                                                    None, None]
        d = d - 0.2 * torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (r * r))
    return (d.clamp(0.02, 1.0) * 255.0).round().to(torch.uint8)


def nyu_files(root: str, seed: int, pairs: int, hw, device, threads: int = 8) -> str:
    """NYU-Depth-V2 training pairs in the DenseDepth layout under
    ``root/nyu-<seed>/``: ``data/nyu2_train/scene_k/i.jpg`` (RGB JPEG at
    quality 90) and
    ``i.png`` (8-bit depth PNG) listed in ``nyu2_train.csv``, written once
    per seed (a ``done`` file marks a whole set); other seeds' sets are
    removed first, so a checkout holds one. Returns the set's directory."""
    import cv2

    out = os.path.join(root, f"nyu-{seed}")
    if os.path.exists(os.path.join(out, "done")):
        return out
    if os.path.isdir(root):
        for name in os.listdir(root):
            if name.startswith("nyu-"):
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    gen = generator(seed, "files", device)
    rows = []
    with ThreadPoolExecutor(threads) as pool:
        for start in range(0, pairs, 256):
            n = min(256, pairs - start)
            rgb = synthetic_images(gen, n, hw, device).cpu().numpy()
            depth = _depth_maps(gen, n, hw, device).cpu().numpy()
            jobs = []
            for j in range(n):
                i = start + j
                rel = f"data/nyu2_train/scene_{i // 500:03d}/{i % 500}"
                os.makedirs(os.path.join(out, os.path.dirname(rel)), exist_ok=True)
                bgr = np.ascontiguousarray(rgb[j][..., ::-1])
                jobs.append(pool.submit(cv2.imwrite, os.path.join(out, rel + ".jpg"), bgr,
                                        [cv2.IMWRITE_JPEG_QUALITY, 90]))
                jobs.append(pool.submit(cv2.imwrite, os.path.join(out, rel + ".png"), depth[j]))
                rows.append((rel + ".jpg", rel + ".png"))
            for job in jobs:
                if not job.result():
                    raise OSError(f"cv2.imwrite failed under {out}")
    with open(os.path.join(out, "nyu2_train.csv"), "w", newline="") as f:
        csv.writer(f).writerows(rows)
    open(os.path.join(out, "done"), "w").close()
    return out
