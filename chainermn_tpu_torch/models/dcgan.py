"""DCGAN generator, discriminator and updater (BASELINE config #5).

The port of ``chainermn_tpu.models.dcgan`` (reference: ChainerMN's
``examples/dcgan``, a CIFAR DCGAN with a multi-node optimizer for each
network).  The same links, seeds, defaults and parameter paths as the
JAX models, so a JAX snapshot loads and both start from bit-identical
weights.  NCHW, fp32.  The generator's transposed convolutions are
``F.deconvolution_2d`` (cuDNN on the card).

One iteration of :class:`DCGANUpdater` is the JAX compiled step's, in
eager PyTorch, in the reference's order: the discriminator's loss,
backward, exchange and update; then the generator's loss against the
updated discriminator, its backward, exchange and update.  Each update
is ``opt.update()`` on the gradients already on ``Parameter.grad`` (the
reference's flow; a multi-node optimizer exchanges them first).

Running statistics move as in the JAX step, which keeps the
discriminator's from its two forwards of the discriminator loss (real,
then fake) and the generator's from the forward of the generator loss:

* one forward of ``gen(z)`` serves both losses -- between them the
  generator's parameters and statistics do not change, so its output and
  new statistics are those of the JAX step's second forward;
* the discriminator's persistent values are saved before its forward in
  the generator loss and restored after it;
* that forward runs with the discriminator's parameters frozen
  (``requires_grad`` off), so its weight gradients are never computed and
  never reach an exchange or an update (the JAX step differentiates the
  generator loss with respect to the generator's parameters only).

The noise ``z`` is drawn once per iteration from the updater's key
(``core.rng``: split every iteration, the rank folded in when the
world holds more than one) by ``Generator.make_hidden``; the numbers
differ from the JAX package's threefry draws.  As in the JAX package the
updater serializes no key of its own: a resumed run starts the noise
stream again from ``seed``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import observability
from .._device import resolve_device
from ..core import rng
from ..core.link import Chain
from ..core.reporter import report
from ..nn import functions as F
from ..nn import links as L
from ..training.updaters import StandardUpdater

__all__ = ["Generator", "Discriminator", "DCGANUpdater"]


class Generator(Chain):
    """z ``[B, n_hidden]`` -> image ``[B, 3, 32, 32]``."""

    def __init__(self, n_hidden=128, ch=256, bottom_width=4, seed=0,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.n_hidden = n_hidden
        self.ch = ch
        self.bottom_width = bottom_width
        kw = dict(device=device)
        self.l0 = L.Linear(n_hidden, bottom_width * bottom_width * ch,
                           seed=seed, **kw)
        self.bn0 = L.BatchNormalization(bottom_width * bottom_width * ch,
                                        **kw)
        self.dc1 = L.Deconvolution2D(ch, ch // 2, 4, stride=2, pad=1,
                                     seed=seed + 1, **kw)
        self.bn1 = L.BatchNormalization(ch // 2, **kw)
        self.dc2 = L.Deconvolution2D(ch // 2, ch // 4, 4, stride=2, pad=1,
                                     seed=seed + 2, **kw)
        self.bn2 = L.BatchNormalization(ch // 4, **kw)
        self.dc3 = L.Deconvolution2D(ch // 4, ch // 8, 4, stride=2, pad=1,
                                     seed=seed + 3, **kw)
        self.bn3 = L.BatchNormalization(ch // 8, **kw)
        self.dc4 = L.Deconvolution2D(ch // 8, 3, 3, stride=1, pad=1,
                                     seed=seed + 4, **kw)

    def make_hidden(self, batchsize, key=None):
        """``[batchsize, n_hidden]`` standard normal noise on the model's
        device, drawn from ``key`` (two uint32 words, ``core.rng``); a
        key from numpy's global RNG when ``None``."""
        if key is None:
            key = rng.make_key(np.random.randint(0, 2**31 - 1))
        device = self.l0.W.device
        return torch.randn((batchsize, self.n_hidden), device=device,
                           generator=rng.generator(key, device))

    def forward(self, z):
        h = F.relu(self.bn0(self.l0(z)))
        h = h.reshape(-1, self.ch, self.bottom_width, self.bottom_width)
        h = F.relu(self.bn1(self.dc1(h)))
        h = F.relu(self.bn2(self.dc2(h)))
        h = F.relu(self.bn3(self.dc3(h)))
        return F.tanh(self.dc4(h))


class Discriminator(Chain):
    """image ``[B, 3, 32, 32]`` -> logit ``[B, 1]``."""

    def __init__(self, ch=256, seed=100, device=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device)
        self.c0 = L.Convolution2D(3, ch // 4, 3, stride=1, pad=1, seed=seed,
                                  **kw)
        self.c1 = L.Convolution2D(ch // 4, ch // 2, 4, stride=2, pad=1,
                                  seed=seed + 1, **kw)
        self.bn1 = L.BatchNormalization(ch // 2, **kw)
        self.c2 = L.Convolution2D(ch // 2, ch, 4, stride=2, pad=1,
                                  seed=seed + 2, **kw)
        self.bn2 = L.BatchNormalization(ch, **kw)
        self.l4 = L.Linear(ch * 8 * 8, 1, seed=seed + 3, **kw)

    def forward(self, x):
        h = F.leaky_relu(self.c0(x))
        h = F.leaky_relu(self.bn1(self.c1(h)))
        h = F.leaky_relu(self.bn2(self.c2(h)))
        return self.l4(h.reshape(h.shape[0], -1))


class DCGANUpdater(StandardUpdater):
    """The adversarial updater (reference: the DCGAN example's updater)
    over the optimizers ``gen`` and ``dis`` (plain or multi-node).
    Reports ``gen/loss`` and ``dis/loss``, each the mean over the ranks
    of a multi-node optimizer's communicator (the JAX step's ``pmean``).
    """

    def __init__(self, iterator, opt_gen, opt_dis, seed=0, **kwargs):
        super().__init__(iterator, {"gen": opt_gen, "dis": opt_dis},
                         **kwargs)
        self._key = rng.make_key(seed)

    def _next_key(self):
        self._key, sub = rng.split(self._key)
        return sub

    def _communicator(self):
        return getattr(self._optimizers["dis"], "communicator", None)

    def update_core(self):
        opt_gen, opt_dis = self._optimizers["gen"], self._optimizers["dis"]
        gen, dis = opt_gen.target, opt_dis.target
        iterator = self._iterators["main"]
        batch = self._pull(iterator, 1, lambda: iterator.next())
        x_real = self.converter(batch, self._device(opt_dis))
        if isinstance(x_real, tuple):
            x_real = x_real[0]
        comm = self._communicator()
        key = self._next_key()
        if comm is not None and comm.size > 1:
            key = rng.fold_in(key, comm.rank)   # each rank its own rows
        z = gen.make_hidden(x_real.shape[0], key=key)
        with observability.span("train/optimizer_update"):
            x_fake = gen(z)
            dis.cleargrads()
            y_real = dis(x_real)
            y_fake = dis(x_fake.detach())
            loss_dis = (F.sigmoid_cross_entropy(y_real,
                                                torch.ones_like(y_real))
                        + F.sigmoid_cross_entropy(y_fake,
                                                  torch.zeros_like(y_fake)))
            loss_dis.backward()
            opt_dis.update()
            gen.cleargrads()
            y_fake = _frozen_forward(dis, x_fake)
            loss_gen = F.sigmoid_cross_entropy(y_fake,
                                               torch.ones_like(y_fake))
            loss_gen.backward()
            opt_gen.update()
        losses = torch.stack([loss_gen.detach(), loss_dis.detach()])
        if comm is not None and comm.size > 1:
            losses = comm.allreduce(losses, op="mean")
        report({"gen/loss": losses[0], "dis/loss": losses[1]})
        if self.is_new_epoch:
            for opt in self._optimizers.values():
                opt.new_epoch()


def _frozen_forward(link, x):
    """``link(x)`` with ``link``'s parameters taking no gradient and its
    persistent values (running statistics) left as they were."""
    saved = [(b, b.clone()) for _, b in link.namedpersistent()]
    params = [p for p in link.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        return link(x)
    finally:
        for p in params:
            p.requires_grad_(True)
        with torch.no_grad():
            for b, value in saved:
                b.copy_(value)
