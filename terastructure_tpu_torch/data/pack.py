"""2-bit genotype packing (port of terastructure_tpu/data/pack.py).

Rows are SNPs, columns are individuals packed 4 per byte, little-endian
within the byte (individual i sits at bits 2*(i % 4)); code 3 is MISSING.
The numpy functions are bitwise equal to the reference's; `unpack2bit_torch`
unpacks on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch

from terastructure_tpu_torch.models.psd import MISSING


def packed_width(n: int) -> int:
    """Bytes per SNP row for n individuals."""
    return (n + 3) // 4


def pack2bit(x: np.ndarray) -> np.ndarray:
    """Pack int genotypes (..., N) in {0,1,2,3} to uint8 (..., ceil(N/4)).

    Trailing positions of the last partial byte are MISSING, so unpacked
    padding never contributes to statistics.
    """
    x = np.asarray(x)
    n = x.shape[-1]
    w = packed_width(n)
    pad = 4 * w - n
    if pad:
        pad_block = np.full(x.shape[:-1] + (pad,), MISSING, dtype=x.dtype)
        x = np.concatenate([x, pad_block], axis=-1)
    x = x.astype(np.uint8).reshape(x.shape[:-1] + (w, 4))
    return (
        x[..., 0] | (x[..., 1] << 2) | (x[..., 2] << 4) | (x[..., 3] << 6)
    ).astype(np.uint8)


def unpack2bit(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack2bit: uint8 (..., W) -> int8 (..., n)."""
    packed = np.asarray(packed)
    out = np.empty(packed.shape[:-1] + (packed.shape[-1] * 4,), dtype=np.int8)
    for s in range(4):
        out[..., s::4] = (packed >> (2 * s)) & 0x3
    return out[..., :n]


def unpack2bit_torch(packed: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 (..., W) -> int8 (..., n) on the tensor's device."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    g = (packed[..., None] >> shifts) & 0x3                # (..., W, 4)
    out = g.reshape(packed.shape[:-1] + (packed.shape[-1] * 4,))
    return out[..., :n].to(torch.int8)
