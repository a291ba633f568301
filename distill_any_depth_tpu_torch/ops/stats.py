"""Masked order statistics with static shapes, and the select kernel.

Counterpart of distill_any_depth_tpu/ops/stats.py. fp32 values map to
order-isomorphic uint32 bits (negative -> ~bits, else bits | sign; masked
entries -> 0xFFFFFFFF, so they sort last); the k-th smallest valid element
is found by index (first occurrence of its value), and the value is a
``torch.gather`` from the ORIGINAL ``x`` at that index, so the gradient is
a one-element scatter per row, as the JAX ``_gather_at``.

``_kth_valid_index`` runs the CUDA kernel ``csrc/kth_select.cu`` (the port
of the TPU kernel ``_kth_valid_index_fused``: a radix select with a row
spread over a cluster of blocks) for every CUDA tensor,
whatever the row length: the TPU's 32768-column cutover to its jnp
bisection was a VMEM/launch trade. A CPU tensor takes the plain version: a
stable sort of the order bits, the value at position k, then the first
index equal to it (the position of k in the sort is not the first
occurrence when the value repeats).

Semantics, as torch's:

- ``masked_median``: lower median, index ``(count-1)//2`` of the sorted
  valid values; 0.0 when no entry is valid;
- ``masked_quantile``: linear interpolation at ``q*(count-1)``
  (``nanquantile``); NaN when no entry is valid;
- ``median_all``: ``torch.median`` over all entries (lower median).
"""
from __future__ import annotations

import torch

from distill_any_depth_tpu_torch.ops._build import Kernel

__all__ = ["masked_median", "masked_quantile", "median_all", "masked_mean",
           "kth_select", "kth_select_reference"]

_SELECT = Kernel("kth_select", "dad_kth_select", "pppii", "select", "select")  # u, k, out; R, N


def _order_bits(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """fp32 -> the order-isomorphic uint32 bit pattern, held in an int32
    tensor (x < y  <=>  bits(x) < bits(y) as unsigned); masked entries are
    0xFFFFFFFF (-1 as int32)."""
    b = x.detach().float().contiguous().view(torch.int32)
    u = torch.where(b < 0, ~b, b | torch.iinfo(torch.int32).min)
    if mask is not None:
        u = torch.where(mask, u, -1)
    return u


def kth_select_reference(u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain version of the select: ``u [R, N]`` order bits (int32 holding
    the uint32 pattern), ``k [R]`` -> ``[R]`` int64, the first index of the
    k-th smallest value (k clamped to [0, N-1], as the kernel does). The
    bits are compared as int64 (torch's uint32 lacks comparisons on the
    CPU)."""
    w = u.to(torch.int64) & 0xFFFFFFFF
    k = k.to(torch.int64).clamp(0, u.shape[-1] - 1)
    value = torch.sort(w, dim=-1, stable=True).values.gather(-1, k[:, None])
    return (w == value).to(torch.uint8).argmax(dim=-1)


def kth_select(u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The select on ``u [R, N]`` (int32 order bits) and ``k [R]``: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor. Returns
    ``[R]`` int64 indices."""
    if u.ndim != 2 or k.shape != u.shape[:1]:
        raise ValueError(f"kth_select takes u [R, N] and k [R]; got {tuple(u.shape)}, "
                         f"{tuple(k.shape)}")
    if u.device.type == "cpu":
        return kth_select_reference(u, k)
    if u.device.type != "cuda":
        raise ValueError(f"no select kernel for device {u.device}")
    if u.dtype != torch.int32:
        raise TypeError(f"select kernel takes int32 order bits, not {u.dtype}")
    u = u.contiguous()
    k = k.to(device=u.device, dtype=torch.int32).contiguous()
    out = torch.empty(u.shape[0], dtype=torch.int32, device=u.device)
    _SELECT([u, k, out], u.shape[0], u.shape[1])
    return out.long()


def _kth_valid_index(u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """First index of the k-th smallest order-bit value along the last axis
    of ``u``; ``k`` broadcasts against ``u``'s leading axes."""
    lead = u.shape[:-1]
    return kth_select(u.reshape(-1, u.shape[-1]), k.expand(lead).reshape(-1)).reshape(lead)


def _gather_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along the last axis: the differentiable read."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower median of ``x[mask]`` along the last axis; 0 where no entry is
    valid."""
    count = mask.sum(dim=-1)
    idx = _kth_valid_index(_order_bits(x, mask), (count - 1).clamp(min=0) // 2)
    return torch.where(count > 0, _gather_at(x, idx), 0.0)


def median_all(x: torch.Tensor) -> torch.Tensor:
    """``torch.median`` along the last axis (lower middle element)."""
    k = torch.full(x.shape[:-1], (x.shape[-1] - 1) // 2, dtype=torch.int64, device=x.device)
    return _gather_at(x, _kth_valid_index(_order_bits(x, None), k))


def masked_quantile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """``torch.nanquantile`` along the last axis (linear interpolation);
    NaN where no entry is valid."""
    count = mask.sum(dim=-1)
    pos = (q * (count.float() - 1.0)).clamp(min=0.0)
    lo_k = pos.floor().long().clamp(0, x.shape[-1] - 1)
    hi_k = pos.ceil().long().clamp(0, x.shape[-1] - 1)
    u = _order_bits(x, mask)
    v_lo = _gather_at(x, _kth_valid_index(u, lo_k))
    v_hi = _gather_at(x, _kth_valid_index(u, hi_k))
    val = v_lo + (pos - pos.floor()) * (v_hi - v_lo)
    return torch.where(count > 0, val, torch.nan)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Mean of ``x[mask]`` along the last axis, with an optional ``+eps`` on
    the count."""
    s = torch.where(mask, x, 0.0).sum(dim=-1)
    return s / (mask.sum(dim=-1).to(x.dtype) + eps)
