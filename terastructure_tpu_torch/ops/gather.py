"""Row-block gather of packed minibatch rows (port of
terastructure_tpu/ops/gather.py, `gather_row_blocks`).

At biobank L the engine draws the SNP minibatch as B/8 uniform blocks of
8 consecutive SNPs (svi/engine.py `_sample_rows`) and this kernel copies
those blocks out of the packed (L, W) matrix. On the TPU the 8-row unit
was forced by Mosaic's tiling; the port keeps it because it is the
reference's sampling distribution at that L, not for alignment.

CUDA: csrc/gather.cu (a warp copies a run, ten 16-byte words a lane in
flight; odd W copies 8-byte words). CPU: the plain fancy-index twin.
"""

from __future__ import annotations

import torch

from terastructure_tpu_torch import _build


def gather_row_blocks_twin(src, starts, *, block=8):
    """Plain PyTorch version: out[g*block + r] = src[starts[g]*block + r]."""
    idx = (starts.long()[:, None] * block
           + torch.arange(block, device=src.device)).reshape(-1)
    return src[idx]


def gather_row_blocks(src: torch.Tensor, starts: torch.Tensor, *,
                      block: int = 8) -> torch.Tensor:
    """src: (L, W) uint8; starts: (G,) int32 block indices in [0, L // block).
    Returns (G*block, W) with out[g*block + r] == src[starts[g]*block + r].
    Block starts are not range-checked on the device."""
    if src.dim() != 2 or starts.dim() != 1:
        raise ValueError("gather_row_blocks: src (L, W), starts (G,)")
    dev = src.device
    if dev.type == "cpu":
        gather_row_blocks.twin_calls += 1
        return gather_row_blocks_twin(src, starts, block=block)
    if dev.type != "cuda":
        raise ValueError(f"gather_row_blocks: unsupported device {dev}")
    _build.require_cuda("gather_row_blocks", src, starts,
                        dtypes=(torch.uint8, torch.int32))
    g, w = starts.shape[0], src.shape[1]
    out = torch.empty((g * block, w), dtype=torch.uint8, device=dev)
    if g:
        err = _build.lib().tt_gather_row_blocks(
            out.data_ptr(), src.data_ptr(), starts.data_ptr(), g, block * w,
            _build.stream_ptr(dev))
        _build.check(err, "gather_row_blocks")
        gather_row_blocks.launches += 1
    return out


gather_row_blocks.launches = 0
gather_row_blocks.twin_calls = 0
