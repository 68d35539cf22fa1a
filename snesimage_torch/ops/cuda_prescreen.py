"""Small-table colour select: kernel A and its plain twin.

Counterpart of snesimage_tpu/ops/pallas_prescreen.py `select_colors`.
The refine loop builds each slot visit's no-candidate frame with it: every
pixel picks its linear colour from the (3, C*S) entry table by a combined
key, and the sentinel key K (transparent pixels) gives 0. The dithered
visit renders all its candidates' palette maps in one call, each with its
own table.

On a CUDA tensor `select_colors` launches csrc/select_colors.cu or raises;
on a CPU tensor it runs the plain twin, the padded gather of the JAX
package's XLA path. The two are bit-identical: both copy table entries.
"""

from __future__ import annotations

import torch

from snesimage_torch.ops import _kernels


def _select_colors_plain(key: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Zero-padded gather: (N, 3, H, W) planes, 0 where key >= K (or
    (3, H, W) for one key plane and one table)."""
    if key.dim() == 2:
        return _select_colors_plain(key[None], table[None])[0]
    n, h, w = key.shape
    padded = torch.cat([table, table.new_zeros((n, 3, 1))], dim=2)
    safe = torch.clamp(key, max=padded.shape[2] - 1).long()
    flat = safe.reshape(n, 1, h * w).expand(n, 3, h * w)
    return torch.gather(padded, 2, flat).reshape(n, 3, h, w)


def _select_colors_cuda(key: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    n, h, w = key.shape
    k = table.shape[2]
    dev = key.device
    out = torch.empty((n, 3, h, w), dtype=torch.float32, device=dev)
    rc = _kernels.library().snes_select_colors(
        _kernels.require(key, "key", torch.int32, (n, h, w), dev),
        _kernels.require(table, "table", torch.float32, (n, 3, k), dev),
        out.data_ptr(),
        n,
        h * w,
        k,
        _kernels.stream(dev),
    )
    _kernels.check(rc, "select_colors")
    select_colors.launches += 1
    return out


def select_colors(key: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(3, H, W) colour planes selected from a small table by pixel key.

    key:   (H, W) int32 in [0, K]; the value K selects 0.0.
    table: (3, K) float32 channel-major colour table.
    With a leading axis N on both (one table per key plane: the dithered
    visit renders its candidates so), the result is (N, 3, H, W).
    """
    batched = key.dim() == 3
    if not batched:
        key, table = key[None], table[None]
    fn = _select_colors_cuda if key.is_cuda else _select_colors_plain
    out = fn(key, table)
    return out if batched else out[0]


select_colors.launches = 0
