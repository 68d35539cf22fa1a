"""Deterministic Lloyd's k-means on torch tensors.

Counterpart of snesimage_tpu/ops/kmeans.py, with the same contract:
centers start at the first ``k`` valid points in a caller-supplied
priority order, assignment ties go to the lowest cluster index, empty
clusters keep their previous center, and the assignment step uses
``||c||^2 - 2 x.c``.

Precision (the bf16 k-means bug of the JAX package's history, 19b3158):
the distance terms are float32 products and sums taken one coordinate at a
time, in a fixed order, with no matrix product, so no TF32 or reduced
precision path can enter and the card computes the same bits as the CPU.
The centers' squared norms add each square with one rounding (a fused
multiply-add, `_square_add`), which is what the JAX package's CPU code
does: with two roundings a pixel between two centers can change sides, and
the 256x240 bench image then converges to another palette.
The per-cluster sums are float64 products cast to float32. On image data
(integer pixel coordinates, tile means of them) every float64 partial sum
is exact, so the sums do not depend on the order a device adds in.

The arguments may carry leading batch axes (``data`` (..., N, D), ``mask``
(..., N)); each batch member iterates as if run alone, stopping at its own
convergence, like ``jax.vmap`` over the JAX function.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class KmeansResult(NamedTuple):
    centers: torch.Tensor  # (..., k, D) float32
    assignments: torch.Tensor  # (..., N) int32; arbitrary for invalid points
    iterations: torch.Tensor  # (...) int32
    converged: torch.Tensor  # (...) bool


def _square_add(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fl32(a * a + c) with one rounding, a fused multiply-add of float32
    operands. The float64 product is exact; the float64 sum is rounded to
    odd (where it is inexact and its last bit is even, it moves one step
    toward the exact sum), so that the rounding to float32 that follows is
    the only one that counts."""
    p = a.double() * a.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)  # the exact p + c - s
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    odd = torch.where((err != 0) & (bits & 1 == 0), bits + step, bits)
    return odd.view(torch.float64).to(torch.float32)


def _assign(data: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-center index per point, first minimum wins. (..., N) int32."""
    x = data.unsqueeze(-2)  # (..., N, 1, D)
    c = centers.unsqueeze(-3)  # (..., 1, k, D)
    dots = x[..., 0] * c[..., 0]
    c2 = centers[..., 0] * centers[..., 0]
    for j in range(1, data.shape[-1]):
        dots = dots + x[..., j] * c[..., j]
        # A fused multiply-add, as the JAX package's CPU compilation sums
        # the squares.
        c2 = _square_add(centers[..., j], c2)
    return torch.argmin(c2.unsqueeze(-2) - 2.0 * dots, dim=-1).to(torch.int32)


def lloyd_kmeans(
    data: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    *,
    init_order: torch.Tensor | None = None,
    max_iter: int = 100,
    tol: float = 1e-6,
) -> KmeansResult:
    """Run Lloyd's k-means on masked points; see the module docstring."""
    data = data.to(torch.float32)
    mask = mask.to(torch.bool)
    n = data.shape[-2]
    batch = mask.shape[:-1]
    data = data.expand(*batch, n, data.shape[-1])
    order = (
        torch.arange(n, device=data.device)
        if init_order is None
        else init_order.long()
    )

    # First k valid points in priority order (stable sort of invalidity);
    # surplus centers are zero when fewer than k points are valid.
    ordered_mask = mask[..., order]
    ranks = torch.sort((~ordered_mask).to(torch.uint8), dim=-1, stable=True)
    init_idx = order[ranks.indices[..., :k]]  # (..., k)
    rank_valid = torch.arange(k, device=data.device) < mask.sum(-1, keepdim=True)
    picked = torch.gather(
        data, -2, init_idx.unsqueeze(-1).expand(*batch, k, data.shape[-1])
    )
    centers = torch.where(rank_valid.unsqueeze(-1), picked, 0.0)

    maskf = mask.to(torch.float32).unsqueeze(-1)  # (..., N, 1)
    iters = torch.zeros(batch, dtype=torch.int32, device=data.device)
    shift = torch.full(batch, float("inf"), device=data.device)
    for _ in range(max_iter):
        active = shift > tol
        if not bool(active.any()):
            break
        assign = _assign(data, centers)
        onehot = torch.nn.functional.one_hot(assign.long(), k).to(
            torch.float32
        ) * maskf  # (..., N, k)
        sums = (onehot.transpose(-1, -2).double() @ data.double()).to(
            torch.float32
        )  # (..., k, D)
        counts = onehot.sum(-2).unsqueeze(-1)  # (..., k, 1)
        means = sums / counts.clamp(min=1.0)
        new_centers = torch.where(counts > 0.0, means, centers)
        new_shift = ((new_centers - centers) ** 2).sum(-1).amax(-1)
        centers = torch.where(active[..., None, None], new_centers, centers)
        shift = torch.where(active, new_shift, shift)
        iters = iters + active.to(torch.int32)
    return KmeansResult(
        centers=centers,
        assignments=_assign(data, centers),
        iterations=iters,
        converged=shift <= tol,
    )
