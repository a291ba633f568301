"""Single-image depth inference CLI on the card.

Counterpart of distill_any_depth_tpu/cli/infer.py, in two parts:

- ``predict(model, images_u8, processing_res)``: device preprocessing, the
  batched forward under ``torch.no_grad()`` and the padding of the tail
  batch. It needs numpy and torch only.
- ``main``: the file I/O shell (glob, cv2 decode, min-max normalize,
  colorize, save), which imports cv2, PIL and matplotlib lazily.

Run: ``python -m distill_any_depth_tpu_torch.cli.infer --device cuda
--arch_name depthanything-base --input IMAGES --output_dir OUT``; the
windowed high-resolution teacher is ``--arch_name depthanything-base-window
--processing_res 1036`` (518 runs the biased attention kernel, 1036 the
banded one). ``--quant int8`` or ``int8_pallas`` runs the encoder GEMMs as
dynamic W8A8 int8 (the latter through kernel 9 on the card). Not ported
yet: ``--fused_tail`` (the tail kernel always runs on the card) and
multi-device sharding of the batch.
"""
from __future__ import annotations

import argparse
import logging
import os
from glob import glob
from typing import Sequence

import numpy as np
import torch

__all__ = ["argument_parser", "predict", "main"]


def argument_parser() -> argparse.ArgumentParser:
    from distill_any_depth_tpu_torch.configs import MODELS

    p = argparse.ArgumentParser(description="Run single-image depth estimation.")
    p.add_argument("--arch_name", default="depthanything-large", choices=sorted(MODELS))
    p.add_argument("--checkpoint", default=None,
                   help="safetensors checkpoint (reference layout); random init if omitted")
    p.add_argument("--input", default="data/input", help="image file or directory")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--processing_res", type=int, default=392,
                   help="square processing resolution; 0 = each image's native "
                        "resolution snapped to the multiple-of-14 grid")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--quant", default="none", choices=["none", "int8", "int8_pallas"],
                   help="int8: the encoder GEMMs as dynamic W8A8 int8 (plain PyTorch around "
                        "torch._int_mm); int8_pallas: the same through the W8A8 kernel, "
                        "which quantizes activations inside the kernel")
    p.add_argument("--cmap", default="Spectral_r")
    p.add_argument("--host_preprocess", action="store_true",
                   help="resize + normalize on the host with cv2 instead of on the "
                        "device; implied by --processing_res 0")
    p.add_argument("--save_npy", action="store_true",
                   help="also write the min-max-normalized disparity as .npy")
    p.add_argument("--batch_size", type=int, default=8,
                   help="images per forward at a fixed --processing_res")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def _forward_batches(model, xs: torch.Tensor, batch_size: int) -> np.ndarray:
    """Depth for ``xs [n, 3, H, W]`` in batches of ``batch_size``; the last
    batch is padded with copies of its final image to the full size, so
    every forward sees one shape."""
    preds = []
    with torch.no_grad():
        for i in range(0, xs.shape[0], batch_size):
            chunk = xs[i : i + batch_size]
            n = chunk.shape[0]
            if n < batch_size:
                chunk = torch.cat([chunk, chunk[-1:].expand(batch_size - n, -1, -1, -1)])
            depth = model(chunk)[0]
            preds.append(depth[:n].float().cpu().numpy())
    return np.concatenate(preds)


def predict(model, images_u8: Sequence[np.ndarray], processing_res: int,
            batch_size: int = 8) -> np.ndarray:
    """Depth at ``processing_res`` for decoded RGB uint8 ``[H, W, 3]``
    images (any sizes): each is resized, /255-scaled and normalized on the
    model's device, then they run through the model in batches of
    ``batch_size``. Returns float32 ``[n, processing_res, processing_res]``."""
    from distill_any_depth_tpu_torch.ops.preprocess import preprocess_on_device

    if processing_res <= 0:
        raise ValueError("predict needs a fixed processing_res > 0")
    device = next(model.parameters()).device
    xs = torch.cat([
        preprocess_on_device(torch.from_numpy(np.ascontiguousarray(im))[None].to(device),
                             processing_res, dtype=model.dtype)
        for im in images_u8
    ])
    return _forward_batches(model, xs, max(batch_size, 1))


def main(args=None) -> list[str]:
    import cv2
    from PIL import Image

    from distill_any_depth_tpu_torch.data.transforms import (
        Compose, NormalizeImage, PrepareForNet, Resize, standard_transform,
    )
    from distill_any_depth_tpu_torch.models.factory import create_model
    from distill_any_depth_tpu_torch.utils.checkpoint import load_state_dict_file
    from distill_any_depth_tpu_torch.utils.image_util import (
        chw2hwc, colorize_depth_maps, normalize_disparity,
    )

    if args is None:
        args = argument_parser().parse_args()
    logging.basicConfig(level=logging.INFO)

    model = create_model(args.arch_name, dtype=getattr(torch, args.dtype), device=args.device,
                         seed=None if args.checkpoint else 0, quant=args.quant)
    if args.checkpoint:
        load_state_dict_file(model, args.checkpoint)
    else:
        logging.warning("no checkpoint: using random init (smoke-test mode)")

    res = args.processing_res
    device_prep = res > 0 and not args.host_preprocess
    paths = sorted(glob(os.path.join(args.input, "*"))) if os.path.isdir(args.input) else [args.input]
    out_dir = os.path.join(args.output_dir, "image_logs")
    os.makedirs(out_dir, exist_ok=True)

    def host_transform(h: int, w: int):
        if res > 0:
            return standard_transform(res)
        return Compose([
            Resize(w, h, ensure_multiple_of=14),
            NormalizeImage(),
            PrepareForNet(),
        ])

    def save_one(path: str, pred: np.ndarray, h: int, w: int) -> str:
        disp = normalize_disparity(pred)
        stem = os.path.splitext(os.path.basename(path))[0]
        if args.save_npy:
            np.save(os.path.join(out_dir, f"depth_{stem}.npy"), disp)
        colored = colorize_depth_maps(disp[None], 0, 1, cmap=args.cmap)[0]
        colored = (chw2hwc(colored) * 255).astype(np.uint8)
        colored = cv2.resize(colored, (w, h), interpolation=cv2.INTER_LINEAR)
        out_path = os.path.join(out_dir, f"depth_{stem}.jpg")
        Image.fromarray(colored).save(out_path)
        logging.info("%s -> %s", path, out_path)
        return out_path

    # fixed resolution batches images; native resolution runs one at a time
    batch = max(args.batch_size, 1) if res > 0 else 1
    written: list[str] = []
    pending: list[tuple[str, np.ndarray, int, int]] = []

    def flush():
        if not pending:
            return
        if device_prep:
            preds = predict(model, [p[1] for p in pending], res, batch)
        else:
            xs = torch.from_numpy(np.stack([p[1] for p in pending])).permute(0, 3, 1, 2)
            preds = _forward_batches(model, xs.to(next(model.parameters()).device), batch)
        for (path, _, h, w), pred in zip(pending, preds):
            written.append(save_one(path, pred, h, w))
        pending.clear()

    for path in paths:
        raw = cv2.imread(path)
        if raw is None:
            logging.warning("skipping unreadable %s", path)
            continue
        rgb = cv2.cvtColor(raw, cv2.COLOR_BGR2RGB)
        h, w = rgb.shape[:2]
        if not device_prep:
            rgb = host_transform(h, w)({"image": rgb.astype(np.float32) / 255.0})["image"]
        pending.append((path, rgb, h, w))
        if len(pending) >= batch:
            flush()
    flush()
    return written


if __name__ == "__main__":
    main()
