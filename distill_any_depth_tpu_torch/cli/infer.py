"""Single-image depth inference CLI on the card.

Counterpart of distill_any_depth_tpu/cli/infer.py, in two parts:

- ``predict(model, images_u8, processing_res)``: device preprocessing, the
  batched forward under ``torch.inference_mode()`` (so the model keeps its
  weights cast to the compute dtype from one call to the next,
  ``models/vit.cast_weights``) and the padding of the tail batch. It needs
  numpy and torch only.
- ``main``: the file I/O shell (glob, cv2 decode, min-max normalize,
  colorize, save), which imports cv2, PIL and matplotlib lazily.

Run: ``python -m distill_any_depth_tpu_torch.cli.infer --device cuda
--arch_name depthanything-base --input IMAGES --output_dir OUT``; the
windowed high-resolution teacher is ``--arch_name depthanything-base-window
--processing_res 1036`` (518 runs the biased attention kernel, 1036 the
banded one); ViT-g is ``--arch_name depthanything-giant --processing_res
518`` (SwiGLU, DPT features 384). ``--quant int8`` or ``int8_pallas`` runs
the encoder GEMMs as dynamic W8A8 int8 (the latter through kernel 9 on the
card). ``--fused_tail off`` runs the plain unfused DPT tail (the student's
chain) instead of kernel 2; ``auto`` (the default) and ``on`` run the kernel
on the card and its plain version on the CPU. Under ``torchrun --nproc_per_node N -m
distill_any_depth_tpu_torch.cli.infer ...`` each rank runs on
``cuda:{LOCAL_RANK}`` and takes the paths ``paths[rank::N]`` of the sorted
input, writing its own outputs (named by the input's stem, so no rank
writes another's files).
"""
from __future__ import annotations

import argparse
import logging
import os
from glob import glob
from typing import Sequence

import numpy as np
import torch

from distill_any_depth_tpu_torch.utils.profiling import count, span

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
    p.add_argument("--fused_tail", default="auto", choices=["auto", "on", "off"],
                   help="the DPT tail as one kernel (auto, on) or as the plain chain of "
                        "convs and resizes (off)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def _forward_batches(model, xs: torch.Tensor, batch_size: int) -> np.ndarray:
    """Depth for ``xs [n, 3, H, W]`` in batches of ``batch_size``; the last
    batch is padded with copies of its final image to the full size, so
    every forward sees one shape. Each batch's depth is copied into its rows
    of one float32 host tensor, made for this call once the first forward
    gives the depth's shape. A CUDA depth goes into page-locked memory from
    torch's caching host allocator by non-blocking copies, which are waited
    for before the tensor's NumPy view is returned."""
    out = None
    with torch.inference_mode():
        for i in range(0, xs.shape[0], batch_size):
            chunk = xs[i : i + batch_size]
            n = chunk.shape[0]
            if n < batch_size:
                chunk = torch.cat([chunk, chunk[-1:].expand(batch_size - n, -1, -1, -1)])
            with span("predict/forward"):
                depth = model(chunk)[0]
            with span("predict/readback"):
                if out is None:
                    pinned = depth.is_cuda
                    out = torch.empty((xs.shape[0], *depth.shape[1:]), dtype=torch.float32,
                                      pin_memory=pinned)
                rows = out[i : i + n]
                rows.copy_(depth[:n].float(), non_blocking=pinned)
                count("predict/readback_bytes", rows.nbytes)
                if pinned:
                    count("predict/readback_pinned_bytes", rows.nbytes)
    # the span keeps the name of the concatenation it replaced: its readers
    # (portbench.phases' concat_idle_ms.infer) compare across commits by it
    with span("predict/concat"):
        if pinned:
            torch.cuda.current_stream(depth.device).synchronize()
        return out.numpy()


def predict(model, images_u8: Sequence[np.ndarray], processing_res: int,
            batch_size: int = 8) -> np.ndarray:
    """Depth at ``processing_res`` for decoded RGB uint8 ``[H, W, 3]``
    images (any sizes): each is resized, /255-scaled and normalized on the
    model's device, then they run through the model in batches of
    ``batch_size``. Returns float32 ``[n, processing_res, processing_res]``,
    a new array each call. On CUDA it lives in page-locked memory from
    torch's caching host allocator: a caller that keeps many outputs keeps
    that memory (``main`` saves and drops each call's output).

    Under ``utils/profiling.recording()`` a call is the span ``predict``
    over ``predict/upload`` (each frame's copy to the device),
    ``predict/preprocess``, ``predict/forward``, ``predict/readback`` (each
    batch's depth copied into the output, non-blocking on CUDA) and
    ``predict/concat`` (the wait for those copies), and counts
    ``predict/upload_bytes``, ``predict/readback_bytes`` and, of those, the
    bytes that went into page-locked memory, ``predict/readback_pinned_bytes``."""
    from distill_any_depth_tpu_torch.ops.preprocess import preprocess_on_device

    if processing_res <= 0:
        raise ValueError("predict needs a fixed processing_res > 0")
    device = next(model.parameters()).device
    with span("predict"):
        xs = []
        for im in images_u8:
            with span("predict/upload"):
                frame = torch.from_numpy(np.ascontiguousarray(im))[None]
                count("predict/upload_bytes", frame.nbytes)
                frame = frame.to(device)
            with span("predict/preprocess"):
                xs.append(preprocess_on_device(frame, processing_res, dtype=model.dtype))
        with span("predict/preprocess"):
            xs = torch.cat(xs)
        return _forward_batches(model, xs, max(batch_size, 1))


def main(args=None) -> list[str]:
    from distill_any_depth_tpu_torch.parallel import launch

    if args is None or isinstance(args, list):
        args = argument_parser().parse_args(args)
    logging.basicConfig(level=logging.INFO)
    with launch.process_group(args.device):
        return _infer(args, launch.local_device(args.device), launch.process_index(),
                      launch.process_count())


def _infer(args, device: torch.device, rank: int, world: int) -> list[str]:
    import cv2
    from PIL import Image

    from distill_any_depth_tpu_torch.data.transforms import (
        Compose, NormalizeImage, PrepareForNet, Resize, standard_transform,
    )
    from distill_any_depth_tpu_torch.models.factory import create_model, resolve_fused_tail
    from distill_any_depth_tpu_torch.utils.checkpoint import load_state_dict_file
    from distill_any_depth_tpu_torch.utils.image_util import (
        chw2hwc, colorize_depth_maps, normalize_disparity,
    )

    model = create_model(args.arch_name, dtype=getattr(torch, args.dtype), device=device,
                         seed=None if args.checkpoint else 0, quant=args.quant,
                         fused_tail=resolve_fused_tail(args.fused_tail))
    if args.checkpoint:
        load_state_dict_file(model, args.checkpoint)
    else:
        logging.warning("no checkpoint: using random init (smoke-test mode)")

    res = args.processing_res
    device_prep = res > 0 and not args.host_preprocess
    paths = sorted(glob(os.path.join(args.input, "*"))) if os.path.isdir(args.input) else [args.input]
    paths = paths[rank::world]  # this rank's share
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
