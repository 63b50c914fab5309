"""Carry weights into the port.

* `state_dict_from_jax`: the JAX package's DLA-34 variables
  ({"params", "batch_stats"} as nested dicts of arrays) -> this package's
  state_dict.  It inverts the JAX package's torch-import name map and
  kinds: conv kernels HWIO -> OIHW, the depthwise upsample kernel flipped
  back into a ConvTranspose2d weight, BatchNorm scale/bias/mean/var.
* `load_reference_checkpoint`: a reference `.pth` ({'epoch',
  'state_dict', ...}, `module.` prefixes stripped); the model keeps the
  reference's names, so its keys load as they are.
* `load_weights`: tolerant load into a model, reporting what it skipped
  (the reference's load_model semantics, src/lib/models/model.py:31-130).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _torch_key(flax_key: str) -> tuple[str, str]:
    """Flat JAX DLASeg key -> (torch key, kind), kind in conv | deconv_dw |
    raw.  E.g. base/level3/tree1/tree1/ConvBN_0/Conv_0/kernel ->
    base.level3.tree1.tree1.conv1.weight (conv)."""
    *mods, leaf = flax_key.split("/")
    if mods[0] == "heads":  # heads/hm_conv/kernel -> hm.0.weight
        head, _, part = mods[1].rpartition("_")
        name = "weight" if leaf == "kernel" else "bias"
        return f"{head}.{ {'conv': 0, 'out': 2}[part] }.{name}", (
            "conv" if leaf == "kernel" else "raw")
    out, parent = [], ""
    for p in mods:
        if p in ("Conv_0", "BatchNorm_0"):
            bn = p == "BatchNorm_0"
            if parent.startswith("ConvBN_"):   # BasicBlock conv1/bn1, conv2/bn2
                out.append(f"{'bn' if bn else 'conv'}{int(parent[-1]) + 1}")
            elif parent == "root":
                out.append("bn" if bn else "conv")
            elif parent.startswith(("proj_", "node_")):   # DeformConv actf
                out.append("actf.0")
            else:   # flat Sequential of (conv, bn, relu) triples
                m = re.fullmatch(r"level[01]_(\d+)", parent)
                out.append(str((3 * int(m[1]) if m else 0) + bn))
        elif m := re.fullmatch(r"(level[01])_\d+", p):
            out.append(m[1])
        elif m := re.fullmatch(r"dla_up_ida_(\d+)", p):
            out.append(f"dla_up.ida_{m[1]}")
        elif p == "DCNv2_0":
            out.append("conv")
        elif not p.startswith("ConvBN_"):
            out.append(p)
        parent = p
    if leaf in ("scale", "mean", "var") or (leaf == "bias"
                                            and parent == "BatchNorm_0"):
        return ".".join(out + [_BN_LEAF[leaf]]), "raw"
    if leaf == "kernel":
        kind = "deconv_dw" if parent.startswith("up_") else "conv"
        return ".".join(out + ["weight"]), kind
    return ".".join(out + [leaf]), "raw"


def state_dict_from_jax(variables: Mapping, arch: str = "dla_34"
                        ) -> Dict[str, torch.Tensor]:
    """JAX package variables -> this package's state_dict (f32 tensors)."""
    if arch != "dla_34":
        raise NotImplementedError(f"arch {arch!r}: only dla_34 is ported")
    flat = _flatten(variables["params"])
    flat.update(_flatten(variables.get("batch_stats", {})))
    sd = {}
    for fk, v in flat.items():
        tk, kind = _torch_key(fk)
        v = np.asarray(v, dtype=np.float32)
        if kind == "conv":                     # HWIO -> OIHW
            v = np.transpose(v, (3, 2, 0, 1))
        elif kind == "deconv_dw":              # flipped (k,k,1,C) -> (C,1,k,k)
            v = np.transpose(v[::-1, ::-1, 0, :], (2, 0, 1))[:, None]
        sd[tk] = torch.from_numpy(np.ascontiguousarray(v))
    return sd


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference checkpoint ({'epoch', 'state_dict', ...}) and strip
    DataParallel's `module.` prefixes."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def load_weights(model: torch.nn.Module, state_dict: Mapping,
                 strict: bool = False) -> Dict[str, list]:
    """Copy matching entries of `state_dict` into `model`.  Keys the model
    lacks or whose shapes differ are skipped (raised on when `strict`);
    model entries left unset are reported as missing (raised on when
    `strict`; BatchNorm's num_batches_tracked is never required)."""
    own = model.state_dict()
    loaded, skipped = [], []
    with torch.no_grad():
        for k, v in state_dict.items():
            v = torch.as_tensor(v)
            if k not in own or tuple(own[k].shape) != tuple(v.shape):
                skipped.append(k)
                continue
            own[k].copy_(v)
            loaded.append(k)
    missing = [k for k in own if k not in set(loaded)
               and not k.endswith("num_batches_tracked")]
    if strict and (skipped or missing):
        raise KeyError(f"state_dict mismatch: skipped {skipped[:8]}, "
                       f"missing {missing[:8]}")
    return {"loaded": loaded, "skipped": skipped, "missing": missing}
