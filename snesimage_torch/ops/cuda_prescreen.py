"""Small-table colour select: kernel A and its plain twin.

Counterpart of snesimage_tpu/ops/pallas_prescreen.py `select_colors`.
The refine loop builds each slot visit's no-candidate frame with it: every
pixel picks its linear colour from the (3, C*S) entry table by a combined
key, and the sentinel key K (transparent pixels) gives 0.

On a CUDA tensor `select_colors` launches csrc/select_colors.cu or raises;
on a CPU tensor it runs the plain twin, the padded gather of the JAX
package's XLA path. The two are bit-identical: both copy table entries.
"""

from __future__ import annotations

import torch

from snesimage_torch.ops import _kernels


def _select_colors_plain(key: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Zero-padded gather: (3, H, W) planes, 0 where key >= K."""
    padded = torch.cat([table, table.new_zeros((3, 1))], dim=1)
    safe = torch.clamp(key, max=padded.shape[1] - 1).long()
    return padded.T[safe].permute(2, 0, 1)


def _select_colors_cuda(key: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    h, w = key.shape
    k = table.shape[1]
    dev = key.device
    out = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    rc = _kernels.library().snes_select_colors(
        _kernels.require(key, "key", torch.int32, (h, w), dev),
        _kernels.require(table, "table", torch.float32, (3, k), dev),
        out.data_ptr(),
        1,
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
    """
    if key.is_cuda:
        return _select_colors_cuda(key, table)
    return _select_colors_plain(key, table)


select_colors.launches = 0
