"""Batched teacher pseudo-label inference on the card.

Counterpart of distill_any_depth_tpu/cli/pseudo_label.py: the ViT-L teacher
at 518^2 over an image folder in batches, writing a float32 depth map per
image (and, if asked, a min-max 16-bit PNG) for a later distillation. In two
parts:

- ``label_batches(model, images_u8, target, batch_size)``: device
  preprocessing and the batched forward under ``torch.inference_mode()``
  (the model keeps its bf16 weights between batches), the last batch
  padded with zero images as the JAX CLI pads it. It needs numpy and torch
  only.
- ``main``: the file I/O shell (glob, cv2 decode, BGR -> RGB, the host
  ``INTER_CUBIC`` resize to the bucket, ``{stem}_depth.npy`` and
  ``{stem}_depth.png``), which imports cv2 lazily.

Run: ``python -m distill_any_depth_tpu_torch.cli.pseudo_label --device cuda
--input IMAGES --output_dir OUT [--quant int8_pallas]``; ``--quant
int8_pallas`` runs the encoder's 96 GEMMs a forward through kernel 9.
``--arch_name depthanything-giant-reg`` labels with the ViT-g register
teacher (160 GEMMs a forward under ``int8_pallas``).
``--fused_tail off`` runs the plain unfused DPT tail instead of kernel 2;
``auto`` (the default) and ``on`` run the kernel on the card.
Under ``torchrun --nproc_per_node N -m
distill_any_depth_tpu_torch.cli.pseudo_label ...`` (the JAX CLI's split of
the batch over one process's devices, with one process per device here)
each rank runs on ``cuda:{LOCAL_RANK}`` and labels the images
``paths[rank::N]`` of the sorted folder, once each; the union of the
ranks' files is a single-process run's.
"""
from __future__ import annotations

import argparse
import logging
import os
from glob import glob

import numpy as np
import torch

__all__ = ["argument_parser", "label_batches", "main"]


def argument_parser() -> argparse.ArgumentParser:
    from distill_any_depth_tpu_torch.configs import MODELS

    p = argparse.ArgumentParser(description="Batched teacher pseudo-label inference.")
    p.add_argument("--arch_name", default="depthanything-large", choices=sorted(MODELS))
    p.add_argument("--checkpoint", default=None,
                   help="safetensors checkpoint (reference layout); random init if omitted")
    p.add_argument("--input", required=True, help="image folder")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--processing_res", type=int, default=518,
                   help="square resolution, snapped up to a multiple-of-14 bucket")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--quant", default="none", choices=["none", "int8", "int8_pallas"],
                   help="int8: the encoder GEMMs as dynamic W8A8 int8 (plain PyTorch around "
                        "torch._int_mm); int8_pallas: the same through the W8A8 kernel, "
                        "which quantizes activations inside the kernel")
    p.add_argument("--save_png16", action="store_true", help="also save min-max uint16 PNGs")
    p.add_argument("--fused_tail", default="auto", choices=["auto", "on", "off"],
                   help="the DPT tail as one kernel (auto, on) or as the plain chain of "
                        "convs and resizes (off)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def label_batches(model, images_u8: np.ndarray, target: int, batch_size: int = 8) -> np.ndarray:
    """fp32 depth ``[n, target, target]`` (the teacher resizes to its input)
    for ``images_u8 [n, target, target, 3]`` uint8 RGB: each batch goes to
    the model's device raw, is normalized there and runs under inference mode;
    the last batch is padded with zero images to ``batch_size``."""
    from distill_any_depth_tpu_torch.ops.preprocess import preprocess_on_device

    device = next(model.parameters()).device
    bs = max(batch_size, 1)
    out = []
    with torch.inference_mode():
        for start in range(0, len(images_u8), bs):
            chunk = np.asarray(images_u8[start:start + bs])
            n = len(chunk)
            if n < bs:
                chunk = np.concatenate([chunk, np.zeros((bs - n, *chunk.shape[1:]), np.uint8)])
            raw = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
            depth, _ = model(preprocess_on_device(raw, target, dtype=model.dtype))
            out.append(depth[:n].float().cpu().numpy())
    return np.concatenate(out)


def main(args=None) -> list[str]:
    from distill_any_depth_tpu_torch.parallel import launch

    if args is None or isinstance(args, list):
        args = argument_parser().parse_args(args)
    logging.basicConfig(level=logging.INFO)
    with launch.process_group(args.device):
        return _label(args, launch.local_device(args.device), launch.process_index(),
                      launch.process_count())


def _label(args, device: torch.device, rank: int, world: int) -> list[str]:
    import cv2

    from distill_any_depth_tpu_torch.models.factory import create_model, resolve_fused_tail
    from distill_any_depth_tpu_torch.ops.preprocess import snap_to_bucket
    from distill_any_depth_tpu_torch.utils.checkpoint import load_state_dict_file

    model = create_model(args.arch_name, dtype=getattr(torch, args.dtype), device=device,
                         seed=None if args.checkpoint else 0, quant=args.quant,
                         fused_tail=resolve_fused_tail(args.fused_tail))
    if args.checkpoint:
        load_state_dict_file(model, args.checkpoint)
    else:
        logging.warning("no checkpoint: random init (smoke-test mode)")
    target = snap_to_bucket(args.processing_res)

    paths = sorted(p for p in glob(os.path.join(args.input, "*"))
                   if p.lower().endswith((".jpg", ".jpeg", ".png")))[rank::world]
    os.makedirs(args.output_dir, exist_ok=True)
    bs = max(args.batch_size, 1)
    written = []
    for start in range(0, len(paths), bs):
        kept, raws = [], []
        for path in paths[start:start + bs]:
            img = cv2.imread(path)
            if img is None:
                logging.warning("skipping unreadable %s", path)
                continue
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            # a square host resize keeps the batch stackable; the device
            # resize to the same size is then the identity
            raws.append(cv2.resize(img, (target, target), interpolation=cv2.INTER_CUBIC))
            kept.append(path)
        if not raws:
            continue
        for path, d in zip(kept, label_batches(model, np.stack(raws), target, bs)):
            stem = os.path.splitext(os.path.basename(path))[0]
            npy_path = os.path.join(args.output_dir, f"{stem}_depth.npy")
            np.save(npy_path, d)
            written.append(npy_path)
            if args.save_png16:
                span = max(float(d.max() - d.min()), 1e-8)
                png = ((d - d.min()) / span * 65535).astype(np.uint16)
                cv2.imwrite(os.path.join(args.output_dir, f"{stem}_depth.png"), png)
        logging.info("pseudo-labelled %d/%d", min(start + bs, len(paths)), len(paths))
    return written


if __name__ == "__main__":
    main()
