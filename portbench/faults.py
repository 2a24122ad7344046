"""Faults planted under the timed path, for the tests that show the
check catches them.  Each breaks one guarantee of the training step:

* ``frozen``: the update computes its rule but leaves the parameters as
  they were (a step that returns its state unchanged);
* ``half_batch``: the model sees the first half of each batch, its loss
  the mean over that half;
* ``no_exchange``: the gradient exchange between ranks is left out, each
  rank applies its own gradient;
* ``loss_altered``: the loss is altered where it is produced (1 % more).
"""

from __future__ import annotations

import torch

__all__ = ["plant", "FAULTS"]


def _frozen(model, opt, comm):
    actual = opt.actual_optimizer
    apply_to = actual._apply_to

    def keep(paths, params, grads, hooks=None):
        saved = [p.detach().clone() for p in params]
        apply_to(paths, params, grads, hooks=hooks)
        with torch.no_grad():
            torch._foreach_copy_(params, saved)

    actual._apply_to = keep


def _wrap_forward(model, fn):
    forward = model.forward

    def wrapped(*args):
        return fn(forward, *args)

    model.forward = wrapped


def _half_batch(model, opt, comm):
    _wrap_forward(model, lambda f, *args: f(
        *(a[:a.shape[0] // 2] for a in args)))


def _loss_altered(model, opt, comm):
    _wrap_forward(model, lambda f, *args: f(*args) * 1.01)


def _no_exchange(model, opt, comm):
    comm.multi_node_mean_grad = lambda *args, **kwargs: None


FAULTS = {"frozen": _frozen, "half_batch": _half_batch,
          "no_exchange": _no_exchange, "loss_altered": _loss_altered}


def plant(name, model, opt, comm):
    FAULTS[name](model, opt, comm)
