"""Multi-node optimizer wrapper.

The port of ``chainermn_tpu.optimizers`` (reference: ``chainermn/
optimizers.py · create_multi_node_optimizer, _MultiNodeOptimizer``).  The
JAX package compiles the whole data-parallel step into one ``shard_map``
program that splits a global batch across its devices; the port runs the
reference's step, one process per device:

1. clear the gradients;
2. forward and backward on this rank's local batch;
3. ``communicator.multi_node_mean_grad`` (the gradient allreduce);
4. the wrapped optimizer's update rule;
5. the loss, and every scalar the model reported during the forward,
   replaced by its mean over the ranks (one allreduce, as the JAX step
   ``pmean``s them), without a host sync;
6. the model's floating persistent values (BatchNormalization's running
   statistics) replaced by their mean over the ranks, in one allreduce
   of the flattened values (the JAX step ``pmean``s its persistent
   state); integer ones (BN's ``N``) stay per rank.

A model with lazy parameters (``Linear(None, out)``) gets one forward
before its first step, whose persistent updates and reports are dropped
(as the JAX step's), and then ``bcast_data``, so that every rank holds
rank 0's parameters before the exchange and the rule see them.

``update()`` with no arguments is the eager path: the gradients already
on ``Parameter.grad`` are averaged, then the rule runs.

Not ported yet (they raise ``NotImplementedError``): ``exchange=
"reduce_scatter"``, ``zero_sharding`` and ``double_buffering`` (ROADMAP
A5), ``autotune`` (A10).
"""

from __future__ import annotations

import torch
from torch.nn.parameter import is_lazy

from .core import reporter as reporter_module

__all__ = ["create_multi_node_optimizer"]


def create_multi_node_optimizer(actual_optimizer, communicator,
                                double_buffering=False, zero_fill=True,
                                zero_sharding=False, exchange=None,
                                autotune=None):
    """Wrap an optimizer so that each update averages the gradients over
    ``communicator``.  The returned object forwards attribute access to
    ``actual_optimizer`` (the reference's delegation).  ``exchange``:
    ``None`` or ``"allreduce"`` (the per-leaf / flat / bucketed structure
    is the communicator's ``batch_collectives``)."""
    if autotune:
        raise NotImplementedError(
            "autotune: the self-tuning exchange is not ported yet "
            "(ROADMAP A10)")
    if exchange is None:
        exchange = "allreduce"
    if exchange not in ("allreduce", "reduce_scatter"):
        raise ValueError(
            f"exchange must be 'allreduce' or 'reduce_scatter', got "
            f"{exchange!r} (per_leaf/flat/bucketed are communicator "
            f"batch_collectives flavors of the allreduce exchange)")
    for wanted, what in ((exchange == "reduce_scatter",
                          "exchange='reduce_scatter'"),
                         (zero_sharding, "zero_sharding"),
                         (double_buffering, "double_buffering")):
        if wanted:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP A5: the sharded and "
                f"double-buffered updates)")
    return _MultiNodeOptimizer(actual_optimizer, communicator, zero_fill)


def _observed(fn):
    """``fn()``, with what it reports to the active reporter collected
    apart: ``(result, observation)``.  Without an active reporter the
    observation is empty."""
    stack = reporter_module._reporter_stack()
    if not stack:
        return fn(), {}
    observation = {}
    with stack[-1].scope(observation):
        return fn(), observation


class _MultiNodeOptimizer:
    def __init__(self, actual_optimizer, communicator, zero_fill=True):
        super().__setattr__("communicator", communicator)
        super().__setattr__("actual_optimizer", actual_optimizer)
        super().__setattr__("zero_fill", zero_fill)

    # -- reference-style delegation ---------------------------------------
    def __getattr__(self, name):
        return getattr(self.actual_optimizer, name)

    def __setattr__(self, name, value):
        if name in self.__dict__ or hasattr(type(self), name):
            super().__setattr__(name, value)
        else:
            setattr(self.actual_optimizer, name, value)

    def setup(self, link):
        self.actual_optimizer.setup(link)
        return self

    # -- update -------------------------------------------------------------
    def update(self, lossfun=None, *args, **kwargs):
        actual = self.actual_optimizer
        if actual.target is None:
            raise RuntimeError("setup(link) was not called")
        comm = self.communicator
        if lossfun is None:
            # the reference's flow: backward, allreduce_grad, update
            comm.multi_node_mean_grad(actual.target, zero_fill=self.zero_fill)
            return actual.update()
        if hasattr(comm, "verify_step_signature"):
            # debug communicator: agree on the batch's shapes first
            comm.verify_step_signature((args, kwargs))
        target = actual.target
        if any(is_lazy(p) for p in target.parameters()):
            self._init_lazy(lambda: lossfun(*args, **kwargs))
        target.cleargrads()
        loss, observation = _observed(lambda: lossfun(*args, **kwargs))
        if isinstance(loss, tuple):
            loss = loss[0]
        loss.backward()
        comm.multi_node_mean_grad(target, zero_fill=self.zero_fill)
        actual.update()
        self._mean_persistent()
        return self._global_means(loss, observation)

    def _init_lazy(self, forward):
        """One forward without a gradient creates the lazy parameters; the
        persistent values it moved are put back."""
        target = self.actual_optimizer.target
        saved = [(b, b.clone()) for _, b in target.namedpersistent()]
        with torch.no_grad():
            _observed(forward)
            for b, value in saved:
                b.copy_(value)
        self.communicator.bcast_data(target)

    def _mean_persistent(self):
        """Every floating persistent value replaced by its mean over the
        ranks, in one allreduce."""
        if self.communicator.size == 1:
            return
        values = [b for _, b in self.actual_optimizer.target.namedpersistent()
                  if b.is_floating_point()]
        if not values:
            return
        means = self.communicator.allreduce(
            torch.cat([b.reshape(-1) for b in values]), op="mean")
        with torch.no_grad():
            torch._foreach_copy_(values, [
                m.view_as(b) for m, b in zip(
                    means.split([b.numel() for b in values]), values)])

    def _global_means(self, loss, observation):
        """The loss and the scalars reported in ``observation``, each
        replaced by its mean over the ranks in one allreduce; the means
        are reported to the active reporter.  Returns the mean loss."""
        keys = [k for k, v in observation.items()
                if isinstance(v, (int, float))
                or (isinstance(v, torch.Tensor) and v.numel() == 1)]
        comm = self.communicator
        loss = loss.detach()
        if comm.size > 1:
            values = torch.stack(
                [loss.float().reshape(())]
                + [torch.as_tensor(observation[k], dtype=torch.float32,
                                   device=loss.device).reshape(())
                   for k in keys])
            means = comm.allreduce(values, op="mean")
            loss = means[0].to(loss.dtype)
            for k, m in zip(keys, means[1:]):
                observation[k] = m
        reporter_module.report(observation)
        return loss
