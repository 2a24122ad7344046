"""MLP and Classifier (the MNIST model and ``chainer.links.Classifier``).

The port of ``chainermn_tpu.models.mlp``: three lazy ``Linear``s (their
input sizes come from the first batch, their weights from the JAX seeds)
and the loss head that reports ``loss`` and ``accuracy``.
"""

from __future__ import annotations

from ..core import reporter
from ..core.link import Chain
from ..nn import functions as F
from ..nn import links as L

__all__ = ["MLP", "Classifier"]


class MLP(Chain):
    def __init__(self, n_units=1000, n_out=10, seed=0, device=None):
        super().__init__()
        self.l1 = L.Linear(None, n_units, seed=seed, device=device)
        self.l2 = L.Linear(None, n_units,
                           seed=None if seed is None else seed + 1,
                           device=device)
        self.l3 = L.Linear(None, n_out,
                           seed=None if seed is None else seed + 2,
                           device=device)

    def forward(self, x):
        h = F.relu(self.l1(x))
        h = F.relu(self.l2(h))
        return self.l3(h)


class Classifier(Chain):
    """Loss head: ``forward(*inputs, t)`` runs the predictor, returns
    ``lossfun(y, t)`` and reports ``loss`` and ``accuracy``."""

    def __init__(self, predictor, lossfun=F.softmax_cross_entropy,
                 accfun=F.accuracy):
        super().__init__()
        self.lossfun = lossfun
        self.accfun = accfun
        self.predictor = predictor

    def forward(self, *args):
        *inputs, t = args
        y = self.predictor(*inputs)
        loss = self.lossfun(y, t)
        values = {"loss": loss.detach()}
        if self.accfun is not None:
            values["accuracy"] = self.accfun(y.detach(), t)
        reporter.report(values, self)
        return loss
