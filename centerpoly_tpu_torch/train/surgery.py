"""Cross-model weight surgery: per-head transplants and layer freezing
(the JAX package's train/surgery.py).

Behavioral reference: src/lib/models/model.py:66-125.  Its EXT_HM / EXT_D /
EXT_Poly blocks copy every parameter whose name contains a head substring
from another checkpoint, and FREEZE_LAYERS stops the gradients of the
loaded non-head parameters.  There they are hard-coded booleans; here they
are functions over the reference's parameter names.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping

import torch


def transplant_heads(state_dict: Mapping[str, torch.Tensor],
                     donor_state_dict: Mapping[str, torch.Tensor],
                     substrings: Iterable[str], verbose: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """A copy of `state_dict` with every donor tensor whose name contains
    any of the substrings (e.g. 'hm', 'pseudo_depth', 'poly') copied in,
    where the recipient has that name at the same shape."""
    out = dict(state_dict)
    subs = tuple(substrings)
    n = 0
    for k, v in donor_state_dict.items():
        if any(s in k for s in subs) and k in out \
                and out[k].shape == v.shape:
            out[k] = v.detach().clone().to(out[k].device, out[k].dtype)
            n += 1
            if verbose:
                print(f"transplant: {k}")
    if verbose:
        print(f"transplanted {n} tensors for {subs}")
    return out


def freeze_mask(model: torch.nn.Module,
                trainable_substrings: Iterable[str]) -> Dict[str, bool]:
    """{parameter name: trainable}: a parameter whose name contains one of
    the substrings stays trainable, every other one freezes (ref
    FREEZE_LAYERS keeps only 'poly' / 'hm' trainable)."""
    subs = tuple(trainable_substrings)
    return {k: any(s in k for s in subs) for k, _ in model.named_parameters()}


def freeze_transform(mask: Mapping[str, bool]
                     ) -> Callable[[torch.nn.Module], None]:
    """The gradient transform that zeroes the frozen parameters' gradients
    before the clip and Adam (TrainState's `grad_transform`), as
    `optax.chain(freeze_transform(mask), ...)` does.  A frozen parameter
    gets a zero gradient, not none: Adam then counts the step for it too,
    so a parameter unfrozen later takes its bias correction from the
    shared step count, as optax's single count gives it.  With zero
    moments Adam moves a frozen parameter by exactly 0."""
    def zero_frozen(model: torch.nn.Module) -> None:
        for name, p in model.named_parameters():
            if mask[name]:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()

    return zero_frozen
