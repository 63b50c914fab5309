"""Masked regression losses at gathered peak indices: reference
losses.py:817-830 (RegL1Loss), :201-216 (RegLoss, smooth L1),
:1093-1118 (NormRegL1Loss, RegWeightedL1Loss), trains/ctdet.py:69-74
(the dense wh branch) and :1130-1179 (BinRotLoss, ddd's multi-bin
rotation), as the JAX package's losses/regression.py.

Every denominator is summed over the ranks of `group` when one is given
(losses/normalise.py), so a data-parallel step normalises over the global
batch.  |x| is `abs_`, jnp.abs's gradient at 0."""
from __future__ import annotations

import torch

from ..geometry.polygon import abs_
from ..ops.gather import gather_feat_nhwc
from .normalise import global_sum


def reg_l1_loss(output: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
                target: torch.Tensor, group=None) -> torch.Tensor:
    """L1 at peaks. output (B,H,W,D); mask (B,K); ind (B,K); target
    (B,K,D); normalised by the expanded mask sum (objects x D)."""
    pred = gather_feat_nhwc(output, ind)
    m = mask[..., None].to(pred.dtype).expand_as(pred)
    return abs_(pred * m - target * m).sum() / (global_sum(m.sum(), group)
                                                + 1e-4)


def reg_smooth_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                       ind: torch.Tensor, target: torch.Tensor,
                       group=None) -> torch.Tensor:
    """Smooth L1 (beta 1) at peaks, normalised by the unexpanded mask sum
    (the number of objects), as the reference does."""
    pred = gather_feat_nhwc(output, ind)
    num = mask.to(pred.dtype).sum()
    m = mask[..., None].to(pred.dtype).expand_as(pred)
    diff = abs_(pred * m - target * m)
    loss = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    return loss.sum() / (global_sum(num, group) + 1e-4)


def norm_reg_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                     ind: torch.Tensor, target: torch.Tensor,
                     group=None) -> torch.Tensor:
    """Target-normalised L1: the prediction over (target + 1e-4),
    regressed toward 1."""
    pred = gather_feat_nhwc(output, ind)
    m = mask[..., None].to(pred.dtype).expand_as(pred)
    pred = pred / (target + 1e-4)
    loss = abs_(pred * m - torch.ones_like(target) * m).sum()
    return loss / (global_sum(m.sum(), group) + 1e-4)


def reg_weighted_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                         ind: torch.Tensor, target: torch.Tensor,
                         group=None) -> torch.Tensor:
    """L1 at peaks under a per-element (B, K, D) mask (cat_spec_wh)."""
    pred = gather_feat_nhwc(output, ind)
    m = mask.to(pred.dtype)
    return abs_(pred * m - target * m).sum() / (global_sum(m.sum(), group)
                                                + 1e-4)


def dense_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                  target: torch.Tensor, group=None) -> torch.Tensor:
    """Masked L1 over whole (B, H, W, D) maps, normalised by the mask sum
    (dense_wh)."""
    m = mask.to(output.dtype)
    return abs_(output * m - target * m).sum() / (global_sum(m.sum(), group)
                                                  + 1e-4)


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = abs_(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def bin_rot_loss(output: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
                 rotbin: torch.Tensor, rotres: torch.Tensor,
                 group=None) -> torch.Tensor:
    """The multi-bin rotation loss of ddd (ref losses.py:1130-1179, the
    JAX package's fixed-shape form).  output (B,H,W,8) gathers to rows
    [bin1 logits 2, bin1 sin, bin1 cos, bin2 logits 2, bin2 sin, bin2
    cos]; rotbin (B,K,2) integer bin labels, rotres (B,K,2) angle
    residuals, mask (B,K).

    Each bin's cross-entropy zeroes the logits of masked rows and
    averages over ALL B*K rows (a masked row adds log 2); each residual
    term is a smooth-L1 mean over the rows whose bin label is nonzero, 0
    where there is none.  With a group, both denominators (the rows, the
    selected rows) and the residual's n > 0 test are the global batch's."""
    pred = gather_feat_nhwc(output, ind).reshape(-1, 8)
    tb = rotbin.reshape(-1, 2).long()
    tr = rotres.reshape(-1, 2)
    m = mask.reshape(-1, 1).to(pred.dtype)
    rows = global_sum(pred.new_tensor(float(pred.shape[0])), group)

    def bin_ce(logits, labels):
        logp = torch.log_softmax(logits * m, dim=-1)
        return -torch.gather(logp, 1, labels[:, None]).sum() / rows

    def res_term(sel, sin_pred, cos_pred, res):
        sel = sel.to(pred.dtype)
        n = global_sum(sel.sum(), group)
        ls = (_smooth_l1(sin_pred - torch.sin(res)) * sel).sum()
        lc = (_smooth_l1(cos_pred - torch.cos(res)) * sel).sum()
        return torch.where(n > 0, (ls + lc) / torch.clamp_min(n, 1.0), 0.0)

    loss_bin1 = bin_ce(pred[:, 0:2], tb[:, 0])
    loss_bin2 = bin_ce(pred[:, 4:6], tb[:, 1])
    loss_res = res_term(tb[:, 0] != 0, pred[:, 2], pred[:, 3], tr[:, 0])
    loss_res = loss_res + res_term(tb[:, 1] != 0, pred[:, 6], pred[:, 7],
                                   tr[:, 1])
    return loss_bin1 + loss_bin2 + loss_res
