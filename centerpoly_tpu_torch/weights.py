"""Carry weights into the port.

* `state_dict_from_jax`: the JAX package's variables ({"params",
  "batch_stats"} as nested dicts of arrays) of any arch of the registry
  -> this package's state_dict.  It inverts the JAX package's
  torch-import name map of that arch (train/torch_import.py) and its
  kinds: conv kernels HWIO -> OIHW, the depthwise upsample kernel flipped
  back into a grouped ConvTranspose2d weight, the ResNet deconv kernel
  flipped back into a dense one, BatchNorm scale/bias/mean/var.  DLA-34,
  dlav0_34 and the ResNets map each JAX leaf to its torch key
  (`_torch_key`, `_resnet_key`); the hourglass archs walk the port model's
  own keys through a copy of that name map (`hourglass_name_map`), so a
  module missing on either side raises.
* `load_reference_checkpoint`: a reference `.pth` ({'epoch',
  'state_dict', ...}, `module.` prefixes stripped); the model keeps the
  reference's names, so its keys load as they are.
* `load_weights`: tolerant load into a model, reporting what it skipped
  (the reference's load_model semantics, src/lib/models/model.py:31-130).
"""
from __future__ import annotations

import re
from functools import partial
from typing import Callable, Dict, Mapping

import numpy as np
import torch

from .models.factory import HOURGLASS_STACKS
from .models.hourglass import HourglassNet

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


def _torch_key(flax_key: str, plain: bool = False) -> tuple[str, str]:
    """Flat JAX DLASeg key -> (torch key, kind), kind in conv | deconv_dw |
    raw.  E.g. base/level3/tree1/tree1/ConvBN_0/Conv_0/kernel ->
    base.level3.tree1.tree1.conv1.weight (conv).  `plain`: dlav0, whose
    IDAUp projections and nodes are ConvBNs (proj_1/Conv_0 ->
    proj_1.0, proj_1/BatchNorm_0 -> proj_1.1), where the JAX package's
    dla_name_map knows only the DCN form (conv, actf.0)."""
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
            elif parent.startswith(("proj_", "node_")):
                # DeformConv's actf, or dlav0's ConvBN Sequential
                out.append(str(int(bn)) if plain else "actf.0")
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


# -- the hourglass name map: torch key -> (flat JAX key, kind), a copy of
# the JAX package's train/torch_import.py (the reference's exkp /
# kp_module / residual / convolution names, large_hourglass.py:24-462)

_BN_SUFFIX = {v: k for k, v in _BN_LEAF.items()}


def _bn(prefix: str, suffix: str):
    if suffix == "num_batches_tracked":
        return None
    return f"{prefix}/{_BN_SUFFIX[suffix]}", "raw"


def _residual_leaf(prefix: str, rest: str):
    """residual: conv1/bn1/conv2/bn2 (+ skip.0/skip.1) -> the JAX
    Residual's ConvBN_0/ConvBN_1(/ConvBN_2)."""
    if m := re.fullmatch(r"conv([12])\.weight", rest):
        return f"{prefix}/ConvBN_{int(m[1]) - 1}/Conv_0/kernel", "conv"
    if m := re.fullmatch(r"bn([12])\.(\w+)", rest):
        return _bn(f"{prefix}/ConvBN_{int(m[1]) - 1}/BatchNorm_0", m[2])
    if rest == "skip.0.weight":
        return f"{prefix}/ConvBN_2/Conv_0/kernel", "conv"
    if m := re.fullmatch(r"skip\.1\.(\w+)", rest):
        return _bn(f"{prefix}/ConvBN_2/BatchNorm_0", m[1])
    return None


def _convolution_leaf(prefix: str, rest: str):
    """convolution: conv (+ bias without BN) / bn -> a JAX ConvBN."""
    if rest == "conv.weight":
        return f"{prefix}/Conv_0/kernel", "conv"
    if rest == "conv.bias":
        return f"{prefix}/Conv_0/bias", "raw"
    if m := re.fullmatch(r"bn\.(\w+)", rest):
        return _bn(f"{prefix}/BatchNorm_0", m[1])
    return None


def _kp_path(rest: str, prefix: str):
    """kp_module: up1/low1/low3 (and the deepest low2) are Sequentials of
    residuals; a nested low2 is the JAX level's `inner`."""
    parts = rest.split(".")
    flax = [prefix]
    for i, p in enumerate(parts):
        if p in ("up1", "low1", "low3") or (
                p == "low2" and i + 1 < len(parts) and parts[i + 1].isdigit()):
            return _residual_leaf("/".join(flax) + f"/{p}_{parts[i + 1]}",
                                  ".".join(parts[i + 2:]))
        if p != "low2":
            return None
        flax.append("inner")
    return None


def hourglass_name_map(tk: str):
    """torch key of the reference's exkp -> (flat JAX key, kind), kind
    conv (OIHW <-> HWIO) or raw; None for a key with no JAX leaf."""
    if m := re.fullmatch(r"pre\.0\.(.*)", tk):
        return _convolution_leaf("pre_conv", m[1])
    if m := re.fullmatch(r"pre\.1\.(.*)", tk):
        return _residual_leaf("pre_res", m[1])
    if m := re.fullmatch(r"kps\.(\d+)\.(.*)", tk):
        return _kp_path(m[2], f"kp_{m[1]}")
    if m := re.fullmatch(r"cnvs\.(\d+)\.(.*)", tk):
        return _convolution_leaf(f"cnv_{m[1]}", m[2])
    if m := re.fullmatch(r"inters\.(\d+)\.(.*)", tk):
        return _residual_leaf(f"inter_{m[1]}", m[2])
    if m := re.fullmatch(r"(inters_|cnvs_)\.(\d+)\.0\.weight", tk):
        return f"{m[1][:-2]}__{m[2]}/Conv_0/kernel", "conv"
    if m := re.fullmatch(r"(inters_|cnvs_)\.(\d+)\.1\.(\w+)", tk):
        return _bn(f"{m[1][:-2]}__{m[2]}/BatchNorm_0", m[3])
    # heads: a ModuleList over stacks of Sequential(convolution without
    # BN, 1x1 conv)
    if m := re.fullmatch(r"(\w+)\.(\d+)\.(0\.conv|1)\.(weight|bias)", tk):
        part = "conv" if m[3] == "0.conv" else "out"
        leaf = "kernel" if m[4] == "weight" else "bias"
        return (f"heads_{m[2]}/{m[1]}_{part}/{leaf}",
                "conv" if leaf == "kernel" else "raw")
    return None


def _hourglass_model(params: Mapping) -> HourglassNet:
    """The port's HourglassNet shaped as the JAX variables are (stacks,
    heads, dims, modules, head width), on the meta device: only its keys
    and shapes are read."""
    n_stacks = sum(k.startswith("kp_") for k in params)
    heads0 = params["heads_0"]
    heads = {k[:-len("_out")]: int(np.shape(v["kernel"])[-1])
             for k, v in heads0.items() if k.endswith("_out")}
    first = next(iter(heads))
    head_conv = int(np.shape(heads0[f"{first}_conv"]["kernel"])[-1])
    dims, modules, level = [], [], params["kp_0"]

    def width(block):
        return int(np.shape(block["ConvBN_0"]["Conv_0"]["kernel"])[-1])

    while True:
        dims.append(width(level["up1_0"]))
        modules.append(sum(k.startswith("up1_") for k in level))
        if "inner" not in level:
            dims.append(width(level["low2_0"]))
            modules.append(sum(k.startswith("low2_") for k in level))
            break
        level = level["inner"]
    with torch.device("meta"):
        return HourglassNet(heads, n_stacks, dims, modules, head_conv)


def _resnet_key(flax_key: str, dcn: bool) -> tuple[str, str]:
    """Flat JAX ResNetDet key -> (torch key, kind): the inverse of the JAX
    package's resnet_name_map / resdcn_name_map (train/torch_import.py:
    252-331).  The deconv stages are one Sequential, 3 modules a stage
    ([up, BN, ReLU], msra_resnet.py) or with `dcn` 6 ([DCN, BN, ReLU, up,
    BN, ReLU], resnet_dcn.py:216-243)."""
    *mods, leaf = flax_key.split("/")
    if mods[0] == "heads":  # heads/hm_conv/kernel -> hm.0.weight
        return _torch_key(flax_key)
    bn_leaf = _BN_LEAF.get(leaf) if mods[-1] == "BatchNorm_0" or (
        mods[0].startswith("dcn_bn_")) else None
    stride = 6 if dcn else 3
    if mods[0] == "stem":
        torch_mod = "bn1" if bn_leaf else "conv1"
    elif m := re.fullmatch(r"layer(\d)_(\d+)", mods[0]):
        block = f"layer{m[1]}.{m[2]}"
        if mods[1] == "downsample":
            torch_mod = f"{block}.downsample.{1 if bn_leaf else 0}"
        else:
            j = int(mods[1].rpartition("_")[2]) + 1     # ConvBN_j
            torch_mod = f"{block}.{'bn' if bn_leaf else 'conv'}{j}"
    elif m := re.fullmatch(r"deconv_(\d+)", mods[0]):
        up = stride * int(m[1]) + (3 if dcn else 0)
        if not bn_leaf:
            return f"deconv_layers.{up}.weight", "deconv"
        torch_mod = f"deconv_layers.{up + 1}"
    elif m := re.fullmatch(r"dcn_bn_(\d+)", mods[0]):
        torch_mod = f"deconv_layers.{stride * int(m[1]) + 1}"
    elif m := re.fullmatch(r"dcn_(\d+)", mods[0]):
        # DCNv2: weight, bias, conv_offset_mask.{weight,bias}
        name = ".".join(["deconv_layers", str(stride * int(m[1])), *mods[1:],
                         "weight" if leaf == "kernel" else leaf])
        return name, "conv" if leaf == "kernel" else "raw"
    else:
        raise KeyError(f"JAX leaf {flax_key} has no place in a ResNetDet")
    if bn_leaf:
        return f"{torch_mod}.{bn_leaf}", "raw"
    return f"{torch_mod}.weight", "conv"


# arch family -> flat JAX key -> (torch key, kind); the hourglass archs
# take `hourglass_name_map` over the port model's own keys instead
_JAX_TO_TORCH: Dict[str, Callable[[str], tuple[str, str]]] = {
    "dla": _torch_key,
    "dlav0": partial(_torch_key, plain=True),
    "res": partial(_resnet_key, dcn=False),
    "resdcn": partial(_resnet_key, dcn=True),
}


def _to_torch(v, kind: str) -> torch.Tensor:
    v = np.asarray(v, dtype=np.float32)
    if kind == "conv":                         # HWIO -> OIHW
        v = np.transpose(v, (3, 2, 0, 1))
    elif kind == "deconv_dw":                  # flipped (k,k,1,C) -> (C,1,k,k)
        v = np.transpose(v[::-1, ::-1, 0, :], (2, 0, 1))[:, None]
    elif kind == "deconv":                     # flipped (k,k,I,O) -> (I,O,k,k)
        v = np.transpose(v[::-1, ::-1], (2, 3, 0, 1))
    return torch.from_numpy(np.array(v, order="C"))    # a writable copy


def state_dict_from_jax(variables: Mapping, arch: str = "dla_34"
                        ) -> Dict[str, torch.Tensor]:
    """JAX package variables of `arch` -> this package's state_dict (f32
    tensors)."""
    flat = _flatten(variables["params"])
    flat.update(_flatten(variables.get("batch_stats", {})))
    if arch in HOURGLASS_STACKS:
        model = _hourglass_model(variables["params"])
        if model.num_stacks != HOURGLASS_STACKS[arch]:
            raise ValueError(f"the variables hold {model.num_stacks} stacks, "
                             f"arch {arch!r} has {HOURGLASS_STACKS[arch]}")
        sd, used = {}, set()
        for tk in model.state_dict():
            if tk.endswith("num_batches_tracked"):
                continue
            mapped = hourglass_name_map(tk)
            if mapped is None or mapped[0] not in flat:
                raise KeyError(f"port key {tk} has no JAX leaf ({mapped})")
            sd[tk] = _to_torch(flat[mapped[0]], mapped[1])
            used.add(mapped[0])
        if used != set(flat):
            raise KeyError(f"JAX leaves with no port key: "
                           f"{sorted(set(flat) - used)[:8]}")
        return sd
    to_torch = _JAX_TO_TORCH.get(arch.partition("_")[0])
    if to_torch is None:
        raise KeyError(f"unknown arch '{arch}'")
    sd = {}
    for fk, v in flat.items():
        tk, kind = to_torch(fk)
        sd[tk] = _to_torch(v, kind)
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
