"""Checkpoint conversion CLI: ``pretrained.*`` -> ``backbone.*``, so that a
DepthAnything-V2 checkpoint loads into the teacher architecture.

Counterpart of distill_any_depth_tpu/cli/convert.py, with the same
arguments and return value: ``python -m
distill_any_depth_tpu_torch.cli.convert IN.safetensors OUT.safetensors``
returns the number of renamed keys (``main`` takes an argument list or a
parsed ``Namespace``). It reads and writes through the port's
own safetensors I/O (``utils/checkpoint``).
"""
from __future__ import annotations

import argparse
import logging

__all__ = ["main"]


def main(args=None) -> int:
    p = argparse.ArgumentParser(description="Convert checkpoint key namespace.")
    p.add_argument("input", help="input .safetensors")
    p.add_argument("output", help="output .safetensors")
    if not isinstance(args, argparse.Namespace):
        args = p.parse_args(args)
    logging.basicConfig(level=logging.INFO)

    from distill_any_depth_tpu_torch.utils.checkpoint import convert_checkpoint

    n = convert_checkpoint(args.input, args.output)
    logging.info("remapped %d keys -> %s", n, args.output)
    return n


if __name__ == "__main__":
    main()
