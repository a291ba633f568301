"""Distillation training CLI.

Counterpart of distill_any_depth_tpu/cli/train.py: ``python -m distill_any_depth_tpu_torch.cli.train --device cuda
--output_dir OUT [--dataset_dir data/nyu ...]`` runs ``train/loop.train_nyu``
(a ViT-L teacher and a ViT-B student at bs16 392^2 by default; ``--student_arch
depthanything-base-window`` trains the windowed student, whose attention
backward is kernel 6 at fewer than 3000 tokens, e.g. ``--image_size 518``,
and kernel 8 above, e.g. ``--image_size 1036``). ``--teacher_quant int8``
or ``int8_pallas`` runs the teachers' encoder GEMMs as dynamic W8A8 int8
(the latter through kernel 9 on the card); the student trains unquantized.
``--teacher_models`` takes any preset: ``depthanything-large-reg`` and
``depthanything-giant-reg`` are the reference's register teachers.
``--teacher_checkpoints`` loads teacher i from a reference-layout
safetensors file; ``--checkpoint_interval`` (default 1000) writes
``student_checkpoint_{step}.safetensors`` and ``train_state/`` every that
many steps; ``--resume DIR`` continues the run saved in ``DIR`` (its output
directory or its ``train_state``). ``--data_mode images`` distils on an
unlabeled folder of ``.jpg``/``.png`` files (``--dataset_dir``) with a
global view and a random local crop of each (``train/loop.train_images``;
the student runs on both views). ``--lora_rank R`` and ``--use_ssf`` add
LoRA (on the student's attention qkv and proj) and SSF adapters to the
student, and ``--adapter_only`` trains those alone. ``--device_preprocess``
sends the decoded uint8 NYU frames to the device, which resizes and
normalizes them. ``--profile_dir DIR`` writes a ``torch.profiler`` trace of
the first 3 steps to ``DIR/trace.json``; ``--visualize_interval N`` (default
500, 0 = never) draws the student's and the teacher's depth every N steps
under ``visualizations/``, and the loss and LR curves are drawn under
``plots/`` at the end. ``--dp D --tp T`` under ``torchrun --nproc_per_node
D*T`` trains on a rank grid (``parallel/``). NYU batches come from the
native C++ loader where it builds (``data/native_loader``), else from the
Python loader, with a logged warning.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging

__all__ = ["argument_parser", "main"]


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train depth distillation.")
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
    p.add_argument("--data_mode", default="nyu", choices=["nyu", "images"],
                   help="'nyu' CSV pairs, or 'images': an unlabeled folder with a global "
                        "view and a random local crop of each image")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the first 3 steps to "
                        "PROFILE_DIR/trace.json")
    p.add_argument("--visualize_interval", type=int, default=500,
                   help="draw the student's and the teacher's depth every this many steps "
                        "(0 = never)")
    p.add_argument("--lora_rank", type=int, default=0,
                   help="LoRA rank on the student's attention qkv/proj (0 = off)")
    p.add_argument("--use_ssf", action="store_true",
                   help="SSF scale/shift adapters on the student")
    p.add_argument("--adapter_only", action="store_true",
                   help="train only the student's LoRA/SSF adapters; the rest stays frozen")
    p.add_argument("--device_preprocess", action="store_true",
                   help="send the decoded uint8 NYU frames to the device and resize and "
                        "normalize them there")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cuda:{LOCAL_RANK} under torchrun)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks (under torchrun); --batch_size is the global batch")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (under torchrun): the blocks' heads and FFN "
                        "columns split over them")
    p.add_argument("--debug", action="store_true")
    return p


def main(args=None) -> dict:
    from distill_any_depth_tpu_torch.parallel import launch

    if args is None or isinstance(args, list):
        args = argument_parser().parse_args(args)
    ranks = args.dp * args.tp
    if ranks > 1 and not launch.launched():
        raise RuntimeError(f"--dp {args.dp} --tp {args.tp} runs {ranks} processes, one per "
                           f"device: launch it with torchrun --nproc_per_node {ranks} -m "
                           f"distill_any_depth_tpu_torch.cli.train --dp {args.dp} --tp "
                           f"{args.tp} ...")
    with launch.process_group(args.device):
        quiet = not launch.is_main_process() and not args.debug
        logging.basicConfig(level=logging.WARNING if quiet else
                            logging.DEBUG if args.debug else logging.INFO)
        return _train(args, launch.local_device(args.device))


def _train(args, device) -> dict:
    from distill_any_depth_tpu_torch.configs import (
        LossConfig,
        OptimizerConfig,
        TrainConfig,
        model_config,
    )
    from distill_any_depth_tpu_torch.train.loop import train_images, train_nyu

    student = model_config(args.student_arch)
    if args.lora_rank or args.use_ssf:
        student = dataclasses.replace(student, encoder=dataclasses.replace(
            student.encoder, lora_rank=args.lora_rank, use_ssf=args.use_ssf))
    total_steps = args.num_iterations or args.num_epochs * 1000
    cfg = TrainConfig(
        student=student,
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
        visualize_interval=args.visualize_interval,
        device_preprocess=args.device_preprocess,
        adapter_only=args.adapter_only,
        dp=args.dp,
        tp=args.tp,
    )
    run = train_images if args.data_mode == "images" else train_nyu
    return run(cfg, device=device, resume=args.resume, profile_dir=args.profile_dir)


if __name__ == "__main__":
    main()
