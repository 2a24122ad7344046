"""Updaters (consumed-Chainer surface: ``chainer.training.updaters``).

The port of ``StandardUpdater`` from ``chainermn_tpu.training.updaters``:
``update()`` pulls a batch from the iterator, converts it onto the
device and hands it to ``optimizer.update(loss_func, *batch)`` (forward,
backward, rule).  The batch goes to the optimizer target's device unless
``device`` names another.  ``FusedUpdater`` pulls K batches per update
and hands them, stacked, to the multi-node optimizer's ``update_scan``.
Not ported yet: the input-stall and update spans (ROADMAP A12).
"""

from __future__ import annotations

import torch

from ..dataset.convert import concat_examples

__all__ = ["Updater", "StandardUpdater", "FusedUpdater"]


class Updater:
    def connect_trainer(self, trainer):
        pass

    def finalize(self):
        pass

    def get_optimizer(self, name):
        raise NotImplementedError

    def get_all_optimizers(self):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def serialize(self, serializer):
        raise NotImplementedError


class StandardUpdater(Updater):
    def __init__(self, iterator, optimizer, converter=concat_examples,
                 device=None, loss_func=None):
        if not isinstance(iterator, dict):
            iterator = {"main": iterator}
        self._iterators = iterator
        if not isinstance(optimizer, dict):
            optimizer = {"main": optimizer}
        self._optimizers = optimizer
        self.converter = converter
        self.device = device
        self.loss_func = loss_func
        self.iteration = 0

    @property
    def epoch(self):
        return self._iterators["main"].epoch

    @property
    def epoch_detail(self):
        return self._iterators["main"].epoch_detail

    @property
    def previous_epoch_detail(self):
        return self._iterators["main"].previous_epoch_detail

    @property
    def is_new_epoch(self):
        return self._iterators["main"].is_new_epoch

    def get_optimizer(self, name="main"):
        return self._optimizers[name]

    def get_all_optimizers(self):
        return dict(self._optimizers)

    def get_iterator(self, name="main"):
        return self._iterators[name]

    def _device(self, optimizer):
        if self.device is not None:
            return self.device
        return next(optimizer.target.parameters()).device

    def update(self):
        self.update_core()
        self.iteration += 1

    def update_core(self):
        iterator = self._iterators["main"]
        optimizer = self._optimizers["main"]
        in_arrays = self.converter(iterator.next(), self._device(optimizer))
        loss_func = self.loss_func or optimizer.target
        if isinstance(in_arrays, tuple):
            optimizer.update(loss_func, *in_arrays)
        elif isinstance(in_arrays, dict):
            optimizer.update(loss_func, **in_arrays)
        else:
            optimizer.update(loss_func, in_arrays)
        if self.is_new_epoch:
            optimizer.new_epoch()

    def finalize(self):
        for iterator in self._iterators.values():
            iterator.finalize()

    def serialize(self, serializer):
        self.iteration = int(serializer("iteration", self.iteration))
        for name, iterator in self._iterators.items():
            iterator.serialize(serializer["iterator:" + name])
        for name, optimizer in self._optimizers.items():
            optimizer.serialize(serializer["optimizer:" + name])


class FusedUpdater(StandardUpdater):
    """``n_fused`` optimizer steps per ``update()``: pulls ``n_fused``
    batches, stacks them along a new leading step axis on the device and
    hands the stack to the multi-node optimizer's ``update_scan`` (the
    JAX package runs it as one compiled ``lax.scan``; here it is a loop
    of the plain step).

    ``iteration`` advances by ``n_fused`` per ``update()``, so interval
    triggers fire at that granularity and a stop trigger of ``(N,
    "iteration")`` stops at the first multiple of ``n_fused`` at or past
    N.  ``new_epoch`` fires once for every epoch boundary crossed inside
    the K pulls.  Requires a multi-node optimizer
    (``create_multi_node_optimizer``)."""

    def __init__(self, iterator, optimizer, n_fused=4,
                 converter=concat_examples, device=None, loss_func=None):
        super().__init__(iterator, optimizer, converter=converter,
                         device=device, loss_func=loss_func)
        if n_fused < 1:
            raise ValueError("n_fused must be >= 1")
        self.n_fused = n_fused

    def update(self):
        self.update_core()
        self.iteration += self.n_fused

    def update_core(self):
        iterator = self._iterators["main"]
        optimizer = self._optimizers["main"]
        if not hasattr(optimizer, "update_scan"):
            raise TypeError("FusedUpdater requires a multi-node optimizer "
                            "(create_multi_node_optimizer)")
        epoch_before = iterator.epoch
        device = self._device(optimizer)
        batches = [self.converter(iterator.next(), device)
                   for _ in range(self.n_fused)]
        loss_func = self.loss_func or optimizer.target
        first = batches[0]
        if isinstance(first, tuple):
            optimizer.update_scan(loss_func, *(
                torch.stack([b[i] for b in batches])
                for i in range(len(first))))
        elif isinstance(first, dict):
            optimizer.update_scan(loss_func, **{
                k: torch.stack([b[k] for b in batches]) for k in first})
        else:
            optimizer.update_scan(loss_func, torch.stack(batches))
        # a boundary may fall on any of the K pulls (is_new_epoch tells
        # only of the last): one new_epoch per boundary crossed
        for _ in range(iterator.epoch - epoch_before):
            optimizer.new_epoch()
