"""AdamW (Loshchilov and Hutter), as ``torch.optim.AdamW`` defines it:
decoupled weight decay scaled by the learning rate, bias-corrected
moments, betas (0.9, 0.999), eps 1e-8."""

from __future__ import annotations

import math

import torch


class AdamW:
    def __init__(self, params: dict, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = params
        self.lr, self.wd, self.eps = lr, weight_decay, eps
        self.b1, self.b2 = betas
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = math.sqrt(1.0 - self.b2 ** self.t)
        for k, p in self.params.items():
            g = grads[k]
            p.mul_(1.0 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / c2 + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
