"""HDN loss self-test.

Counterpart of distill_any_depth_tpu/cli/hdn_demo.py: fixed random
prediction, ground truth and mask (numpy, seeded), and the three HDN
variants (dr, dp, ds) of the loss between them, printed one a line as
``hdn_{variant}: {value:.6f}``. On the card the SSI's masked medians and
the dp contexts' quantiles run through the order-statistic kernel (kernel
4, ``ops/stats``); ``--device cpu`` runs its plain version.

Run: ``python -m distill_any_depth_tpu_torch.cli.hdn_demo [--size 384]
[--batch 2] [--seed 0] [--device cuda]``.
"""
from __future__ import annotations

import argparse

import numpy as np

__all__ = ["main"]


def main(size: int = 384, batch: int = 2, seed: int = 0, device: str = "cuda") -> dict:
    """The three HDN losses at ``[batch, size, size]`` on ``device``."""
    import torch

    from distill_any_depth_tpu_torch.losses.hdn import (
        get_contexts_dp,
        get_contexts_dr,
        get_contexts_ds,
        hdn_loss,
    )
    from distill_any_depth_tpu_torch.models.factory import resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    pred = torch.from_numpy(rng.rand(batch, size, size).astype(np.float32)).to(dev)
    gt = torch.from_numpy(rng.rand(batch, size, size).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.rand(batch, size, size) > 0.5).to(dev)

    out = {}
    for name, ctx in (
        ("dr", get_contexts_dr(3, gt, mask)),
        ("dp", get_contexts_dp(3, gt, mask)),
        ("ds", get_contexts_ds(3, mask)),
    ):
        out[name] = float(hdn_loss(pred, gt, ctx))
        print(f"hdn_{name}: {out[name]:.6f}")
    return out


def _cli() -> None:
    p = argparse.ArgumentParser(description="HDN loss self-test.")
    p.add_argument("--size", type=int, default=384)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args()
    main(args.size, args.batch, args.seed, args.device)


if __name__ == "__main__":
    _cli()
