"""Updaters (consumed-Chainer surface: ``chainer.training.updaters``).

The port of ``StandardUpdater`` from ``chainermn_tpu.training.updaters``:
``update()`` pulls a batch from the iterator, converts it onto the
device and hands it to ``optimizer.update(loss_func, *batch)`` (forward,
backward, rule).  The batch goes to the optimizer target's device unless
``device`` names another.  ``FusedUpdater`` pulls K batches per update
and hands them, stacked, to the multi-node optimizer's ``update_scan``.

Both report the input stall: an iterator that accounts its own
(``DevicePrefetchIterator.input_stall_ms``) reports the stall of the
update's pulls as ``input_stall_ms`` into the observation.  With tracing
on (``CHAINERMN_TPU_TRACE``) the pulls run in a ``train/input_stall``
span (tagged with the iterator's kind) and the rest in a
``train/optimizer_update`` span, and
``chainermn_tpu_input_stall_ms_total`` (labelled by iterator kind and
updater) adds the accounted stall, or the pulls' wall time for an
iterator that does not account one.
"""

from __future__ import annotations

import time

import torch

from .. import observability
from ..core.reporter import report
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
        batch = self._pull(iterator, 1, lambda: iterator.next())
        in_arrays = self.converter(batch, self._device(optimizer))
        loss_func = self.loss_func or optimizer.target
        with observability.span("train/optimizer_update"):
            if isinstance(in_arrays, tuple):
                optimizer.update(loss_func, *in_arrays)
            elif isinstance(in_arrays, dict):
                optimizer.update(loss_func, **in_arrays)
            else:
                optimizer.update(loss_func, in_arrays)
        if self.is_new_epoch:
            optimizer.new_epoch()

    def _pull(self, iterator, n_fused, pull):
        """``pull()``, the update's reads of ``iterator``, with its input
        stall reported: into the observation where the iterator accounts
        it, and with tracing on as the ``train/input_stall`` span and the
        ``chainermn_tpu_input_stall_ms_total`` counter (the accounted
        stall, else the pull's wall time: a consumer of an iterator that
        does not prefetch is blocked for that long)."""
        stall_before = getattr(iterator, "input_stall_ms", None)
        obs_on = observability.enabled()
        t0 = time.monotonic() if obs_on else 0.0
        tags = None
        if obs_on:
            tags = {"iterator": type(iterator).__name__}
            if n_fused > 1:
                tags["n_fused"] = n_fused
        with observability.span("train/input_stall", tags=tags):
            out = pull()
        stall_ms = None if stall_before is None \
            else iterator.input_stall_ms - stall_before
        if stall_ms is not None:
            report({"input_stall_ms": stall_ms})
        if obs_on:
            observability.registry().counter(
                "chainermn_tpu_input_stall_ms_total",
                help="cumulative input-feed stall (ms) by iterator kind "
                     "and updater path").inc(
                stall_ms if stall_ms is not None
                else (time.monotonic() - t0) * 1e3,
                iterator=type(iterator).__name__,
                updater=type(self).__name__)
        return out

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
        # one stall reading over the K pulls (the converter included:
        # this path stacks K batches on the host, exposed feed latency)
        batches = self._pull(iterator, self.n_fused, lambda: [
            self.converter(iterator.next(), device)
            for _ in range(self.n_fused)])
        loss_func = self.loss_func or optimizer.target
        first = batches[0]
        with observability.span(
                "train/optimizer_update",
                tags={"n_fused": self.n_fused}
                if observability.enabled() else None):
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
