"""AdamW (Loshchilov and Hutter, arXiv:1711.05101) with clipping by the
global gradient norm, in float32, as a plain reference.

    g      <- g * min(1, clip / ||g||)       (the norm over every leaf)
    m      <- b1 m + (1 - b1) g
    v      <- b2 v + (1 - b2) g^2
    theta  <- theta - lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd theta)

with weight decay on every leaf, and the learning rate ``lr`` times the
schedule's factor at the step about to be taken (0 at the first):
linear warm-up over ``warmup_steps``, then a cosine from 1 down to 0.1 at
``total_steps``.
"""

from __future__ import annotations

import math

import torch


class AdamW:
    def __init__(self, params: list[torch.Tensor], *, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float, grad_clip: float, warmup_steps: int = 0,
                 total_steps: int = 0):
        self.params = params
        self.warmup, self.total = warmup_steps, total_steps
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip = weight_decay, grad_clip
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    def lr_scale(self, t: int) -> float:
        """The schedule's factor at step ``t`` (0 at the first step)."""
        if not self.warmup and not self.total:
            return 1.0
        warm = min(t / max(self.warmup, 1), 1.0)
        frac = min(max((t - self.warmup) / max(self.total - self.warmup, 1), 0.0), 1.0)
        return warm * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * frac)))

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """One update; returns the gradients' per-leaf norms as they come
        in, before the clipping."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(self.clip / torch.clamp_min(norm, 1e-12), max=1.0)
        lr = self.lr * self.lr_scale(self.t)
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        norms = []
        for p, m, v, g in zip(self.params, self.m, self.v, grads):
            norms.append(torch.linalg.vector_norm(g))
            g = g * scale
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.sub_(lr * (update + self.wd * p))
        return norms
