"""Distillation training CLI.

Counterpart of distill_any_depth_tpu/cli/train.py, for one process and one
device: ``python -m distill_any_depth_tpu_torch.cli.train --device cuda
--output_dir OUT [--dataset_dir data/nyu ...]`` runs ``train/loop.train_nyu``
(a ViT-L teacher and a ViT-B student at bs16 392^2 by default; ``--student_arch
depthanything-base-window`` trains the windowed student, whose attention
backward is kernel 6 at fewer than 3000 tokens, e.g. ``--image_size 518``,
and kernel 8 above, e.g. ``--image_size 1036``). ``--teacher_quant int8``
or ``int8_pallas`` runs the teachers' encoder GEMMs as dynamic W8A8 int8
(the latter through kernel 9 on the card); the student trains unquantized.
``--teacher_checkpoints`` loads teacher i from a reference-layout
safetensors file; ``--checkpoint_interval`` (default 1000) writes
``student_checkpoint_{step}.safetensors`` and ``train_state/`` every that
many steps; ``--resume DIR`` continues the run saved in ``DIR`` (its output
directory or its ``train_state``). The flags of features not ported yet are
accepted by name and refuse any value but their default: visualisation,
the profiler, the dp/tp mesh, image-folder data, LoRA/SSF adapters and
device preprocessing.
"""
from __future__ import annotations

import argparse
import logging

__all__ = ["argument_parser", "main"]

# flag -> (its default, what is not ported)
_NOT_PORTED = {
    "visualize_interval": (0, "visualisation"),
    "profile_dir": (None, "the profiler hook"),
    "dp": (1, "data parallelism"),
    "tp": (1, "tensor parallelism"),
    "data_mode": ("nyu", "image-folder data"),
    "lora_rank": (0, "LoRA adapters"),
    "use_ssf": (False, "SSF adapters"),
    "adapter_only": (False, "adapter-only training"),
    "device_preprocess": (False, "device preprocessing"),
}


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train depth distillation on one device.")
    p.add_argument("--dataset_dir", default="data/nyu")
    p.add_argument("--teacher_models", nargs="+", default=["depthanything-large"])
    p.add_argument("--teacher_checkpoints", nargs="+", default=[],
                   help="safetensors weights of each teacher, in --teacher_models order")
    p.add_argument("--student_arch", default="depthanything-base")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--num_epochs", type=int, default=50)
    p.add_argument("--num_iterations", type=int, default=0)
    p.add_argument("--image_size", type=int, default=392)
    p.add_argument("--normalization", default="hybrid",
                   choices=["global", "hybrid", "local", "none"])
    p.add_argument("--num_segments", type=int, default=4)
    p.add_argument("--lambda_sc", type=float, default=0.5)
    p.add_argument("--lambda_lg", type=float, default=0.5)
    p.add_argument("--lambda_feat", type=float, default=1.0)
    p.add_argument("--lambda_grad", type=float, default=0.2)
    p.add_argument("--use_hdn_loss", action="store_true")
    p.add_argument("--hdn_variant", default="dr", choices=["dr", "dp", "ds"])
    p.add_argument("--hdn_level", type=int, default=3)
    p.add_argument("--lambda_hdn", type=float, default=0.8)
    p.add_argument("--weight_decay", type=float, default=1e-5)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--scheduler_type", default="cosine", choices=["cosine", "step", "none"])
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--checkpoint_interval", type=int, default=1000,
                   help="save the student and the train state every this many steps "
                        "(0 = only at the end)")
    p.add_argument("--resume", default=None,
                   help="a train_state directory (or the output_dir holding one) to "
                        "resume from")
    p.add_argument("--val_split", type=float, default=0.1)
    p.add_argument("--early_stopping", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--teacher_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--teacher_quant", default="none", choices=["none", "int8", "int8_pallas"],
                   help="int8: the teachers' encoder GEMMs as dynamic W8A8 int8 (plain "
                        "PyTorch around torch._int_mm); int8_pallas: the same through the "
                        "W8A8 kernel, which quantizes activations inside the kernel")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--debug", action="store_true")
    for flag, (default, what) in _NOT_PORTED.items():
        kw = {"action": "store_true"} if default is False else {"default": default}
        if isinstance(default, int) and default is not False:
            kw["type"] = int
        p.add_argument(f"--{flag}", help=f"not ported yet ({what}): only the default", **kw)
    return p


def main(args=None) -> dict:
    from distill_any_depth_tpu_torch.configs import (
        LossConfig,
        OptimizerConfig,
        TrainConfig,
        model_config,
    )
    from distill_any_depth_tpu_torch.train.loop import train_nyu

    if args is None or isinstance(args, list):
        args = argument_parser().parse_args(args)
    for flag, (default, what) in _NOT_PORTED.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(f"--{flag}: {what} is not ported to the PyTorch "
                                      f"package yet")
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)

    total_steps = args.num_iterations or args.num_epochs * 1000
    cfg = TrainConfig(
        student=model_config(args.student_arch),
        teachers=tuple(args.teacher_models),
        teacher_checkpoints=tuple(args.teacher_checkpoints),
        loss=LossConfig(
            normalization=args.normalization, num_segments=args.num_segments,
            lambda_sc=args.lambda_sc, lambda_lg=args.lambda_lg, lambda_feat=args.lambda_feat,
            lambda_grad=args.lambda_grad, use_hdn=args.use_hdn_loss,
            hdn_variant=args.hdn_variant, hdn_level=args.hdn_level, lambda_hdn=args.lambda_hdn,
        ),
        optimizer=OptimizerConfig(
            lr=args.lr, weight_decay=args.weight_decay, warmup_steps=args.warmup_steps,
            schedule=args.scheduler_type, total_steps=total_steps,
            max_grad_norm=args.max_grad_norm,
        ),
        batch_size=args.batch_size,
        image_size=args.image_size,
        num_epochs=args.num_epochs,
        num_iterations=args.num_iterations,
        seed=args.seed,
        val_split=args.val_split,
        log_interval=args.log_interval,
        checkpoint_interval=args.checkpoint_interval,
        early_stopping=args.early_stopping,
        output_dir=args.output_dir,
        dataset_dir=args.dataset_dir,
        teacher_dtype=args.teacher_dtype,
        teacher_quant=args.teacher_quant,
    )
    return train_nyu(cfg, device=args.device, resume=args.resume)


if __name__ == "__main__":
    main()
