"""Updaters (consumed-Chainer surface: ``chainer.training.updaters``).

The port of ``StandardUpdater`` from ``chainermn_tpu.training.updaters``:
``update()`` pulls a batch from the iterator, converts it onto the
device and hands it to ``optimizer.update(loss_func, *batch)`` (forward,
backward, rule).  The batch goes to the optimizer target's device unless
``device`` names another.  Not ported yet: the input-stall and update
spans (ROADMAP A12) and ``FusedUpdater`` (A4).
"""

from __future__ import annotations

from ..dataset.convert import concat_examples

__all__ = ["Updater", "StandardUpdater"]


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
