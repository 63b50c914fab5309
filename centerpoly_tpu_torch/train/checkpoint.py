"""Checkpoints in the reference's format (src/lib/models/model.py:31-142):
a torch file {'epoch', 'state_dict', 'optimizer'} named model_<tag>.pth
(model_last / model_best), `module.` prefixes stripped on load, and a
tolerant partial load that skips what does not fit, with a report.
"""
from __future__ import annotations

import os

import torch

from ..weights import load_weights


def checkpoint_path(save_dir: str, tag: str) -> str:
    return os.path.join(save_dir, f"model_{tag}.pth")


def save_checkpoint(save_dir: str, tag: str, state, epoch: int) -> str:
    """Write model_<tag>.pth with the epoch, the weights, the optimizer
    state and the update count."""
    path = checkpoint_path(save_dir, tag)
    torch.save({"epoch": int(epoch), "state_dict": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": int(state.step)}, path)
    return path


def load_checkpoint(save_dir: str, tag: str, state):
    """Restore model_<tag>.pth into `state` (resume semantics, ref
    model.py:102-112): weights tolerantly, and the optimizer state and
    update count when every weight loaded.  Returns (state, epoch,
    load report)."""
    dev = next(state.model.parameters()).device
    ckpt = torch.load(checkpoint_path(save_dir, tag), map_location=dev,
                      weights_only=True)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in ckpt["state_dict"].items()}
    report = load_weights(state.model, sd)
    if "optimizer" in ckpt and not report["skipped"] and not report["missing"]:
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt.get("step", 0))
    return state, int(ckpt["epoch"]), report
