"""Adam (betas 0.9 / 0.999, eps 1e-8, bias-corrected), written out."""
from __future__ import annotations

import torch


class Adam:
    """One update per `step(params)` from each parameter's .grad."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m: dict = {}
        self.v: dict = {}

    @torch.no_grad()
    def step(self, named_params):
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for name, p in named_params:
            if p.grad is None:
                continue
            g = p.grad
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
