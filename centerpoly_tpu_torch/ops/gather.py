"""Gather-at-peak-index primitives (reference: src/lib/models/utils.py:12-26
`_gather_feat` / `_transpose_and_gather_feat`), on NHWC maps."""
from __future__ import annotations

import torch


def gather_feat(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """Gather rows of (B, L, C) at indices (B, K) -> (B, K, C)."""
    return torch.gather(feat, 1, ind.long()[:, :, None].expand(
        -1, -1, feat.shape[-1]))


def gather_feat_nhwc(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """Gather channels of an NHWC map (B, H, W, C) at flat spatial indices
    y * W + x (B, K) -> (B, K, C)."""
    b, h, w, c = feat.shape
    return gather_feat(feat.reshape(b, h * w, c), ind)
