"""The optimizers' update rules, written out in float32.

* MomentumSGD (Chainer's, as ChainerMN's ImageNet example runs it):
  ``v = momentum v + g``, ``p = p - lr v``.
* Adam (Kingma and Ba 2015, bias-corrected, eps outside the root):
  ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
  ``p = p - alpha (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``.
"""

from __future__ import annotations

import torch

__all__ = ["MomentumSGD", "Adam", "make"]


class MomentumSGD:
    def __init__(self, lr, momentum):
        self.lr, self.momentum = lr, momentum

    def init(self, params):
        return {"v": {k: torch.zeros_like(p) for k, p in params.items()}}

    def step(self, params, grads, state):
        with torch.no_grad():
            for k, p in params.items():
                v = state["v"][k]
                v.mul_(self.momentum).add_(grads[k])
                p.sub_(self.lr * v)


class Adam:
    def __init__(self, alpha, beta1=0.9, beta2=0.999, eps=1e-8):
        self.alpha, self.beta1, self.beta2, self.eps = alpha, beta1, beta2, eps

    def init(self, params):
        return {"t": 0,
                "m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()}}

    def step(self, params, grads, state):
        state["t"] += 1
        t, b1, b2 = state["t"], self.beta1, self.beta2
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                m, v = state["m"][k], state["v"][k]
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                m_hat = m / (1 - b1 ** t)
                v_hat = v / (1 - b2 ** t)
                p.sub_(self.alpha * m_hat / (v_hat.sqrt() + self.eps))


def make(spec):
    """The rule a configuration's ``optimizer`` entry names."""
    kw = {k: v for k, v in spec.items() if k != "name"}
    return {"MomentumSGD": MomentumSGD, "Adam": Adam}[spec["name"]](**kw)
