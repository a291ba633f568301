"""Depth evaluation CLI: NYU test and the registry benchmarks.

Counterpart of distill_any_depth_tpu/cli/evaluate.py, with its flags one
for one and ``--device`` (default ``cuda``): evaluates one or two
checkpoints (distilled and original) with mean-ratio alignment and the
8-metric set, and writes a report (``--output``, text, and JSON beside it).
``--dataset nyu_csv`` reads ``nyu2_test.csv`` under ``--data_dir``; a
registry name (nyu, kitti, eth3d, diode, scannet) reads its split list
(``data/registry``), at the benchmark's native resolution by default
(every benchmark but NYU). The model is built as ``cli.infer`` builds it:
on the card, attention kernel 1 and the DPT tail kernel 2. Without a
checkpoint it warns and uses the seed-0 random init.

Run: ``python -m distill_any_depth_tpu_torch.cli.evaluate --arch_name
depthanything-base --model_path student_final.safetensors --data_dir
data/nyu``.
"""
from __future__ import annotations

import argparse
import logging

import torch

__all__ = ["argument_parser", "build_model", "build_dataset", "main"]


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate depth models on NYU test.")
    p.add_argument("--arch_name", default="depthanything-base")
    p.add_argument("--model_path", default=None, help="distilled checkpoint")
    p.add_argument("--original_model_path", default=None,
                   help="optional second checkpoint to compare against")
    p.add_argument("--dataset", default="nyu_csv",
                   help="'nyu_csv' (the nyu2_test.csv layout, default) or a registered "
                        "benchmark: nyu/kitti/eth3d/diode/scannet (split-list layouts; "
                        "data/registry.py)")
    p.add_argument("--filenames", default=None,
                   help="override the registry's split-list path")
    p.add_argument("--eval_resolution", default="default",
                   choices=["default", "native", "square"],
                   help="registry datasets only: 'native' evaluates at GT resolution "
                        "(keep-aspect image, prediction upsampled; the default for every "
                        "benchmark except NYU); 'square' resizes both to image_size x "
                        "image_size")
    p.add_argument("--mask_crop", default="default",
                   choices=["default", "eigen", "garg", "none"],
                   help="registry datasets only: override the valid-mask crop policy "
                        "(KITTI: eigen or garg)")
    p.add_argument("--data_dir", default="data/nyu")
    p.add_argument("--image_size", type=int, default=392)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--output", default="evaluation_report.txt")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--raw_255", action="store_true",
                   help="feed raw 0-255 images (the reference loader's behaviour) instead "
                        "of ImageNet-normalized ones, for cross-framework parity runs")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def build_model(args, path: str | None) -> torch.nn.Module:
    """The ``--arch_name`` model in ``--dtype`` on ``--device`` with the
    weights of ``path`` (seed-0 random init when None)."""
    from distill_any_depth_tpu_torch.models.factory import create_model
    from distill_any_depth_tpu_torch.utils.checkpoint import load_state_dict_file

    model = create_model(args.arch_name, dtype=getattr(torch, args.dtype), device=args.device,
                         seed=0 if path is None else None)
    if path is None:
        logging.warning("no checkpoint: random init")
    else:
        load_state_dict_file(model, path)
    return model


def build_dataset(args):
    """The evaluation dataset ``--dataset`` names."""
    if args.dataset == "nyu_csv":
        from distill_any_depth_tpu_torch.data.nyu import NYUDataset

        return NYUDataset("test", dataset_dir=args.data_dir, image_size=args.image_size,
                          raw_255=args.raw_255)
    from distill_any_depth_tpu_torch.data.registry import FileListDataset

    native = {"default": None, "native": True, "square": False}[args.eval_resolution]
    crop = ("default" if args.mask_crop == "default"
            else None if args.mask_crop == "none" else args.mask_crop)
    return FileListDataset(args.dataset, args.data_dir, image_size=args.image_size,
                           filenames=args.filenames, native_resolution=native,
                           valid_mask_crop=crop)


def main(args=None) -> dict:
    from distill_any_depth_tpu_torch.data.nyu import iterate_batches
    from distill_any_depth_tpu_torch.eval.evaluate import (compare_models, evaluate_model,
                                                           write_report)

    if not isinstance(args, argparse.Namespace):
        args = argument_parser().parse_args(args)
    logging.basicConfig(level=logging.INFO)

    ds = build_dataset(args)

    def batches():
        return iterate_batches(ds, args.batch_size, shuffle=False)

    distilled = build_model(args, args.model_path)
    if args.original_model_path:
        both = compare_models(distilled, build_model(args, args.original_model_path), batches)
        results = {"distilled": both["model_a"], "original": both["model_b"]}
    else:
        results = {"distilled": evaluate_model(distilled, batches())}
    write_report(args.output, results)
    for name, m in results.items():
        logging.info("%s: %s", name, {k: round(v, 4) for k, v in m.items()})
    return results


if __name__ == "__main__":
    main()
