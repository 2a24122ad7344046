"""Multi-node optimizer wrapper.

The port of ``chainermn_tpu.optimizers`` (reference: ``chainermn/
optimizers.py · create_multi_node_optimizer, _MultiNodeOptimizer,
_DoubleBufferingOptimizer``).  The JAX package compiles the whole
data-parallel step into one ``shard_map`` program that splits a global
batch across its devices; the port runs the reference's step, one process
per device:

1. clear the gradients;
2. forward and backward on this rank's local batch;
3. the gradient exchange and the wrapped optimizer's update rule, in one
   of three structures (below);
4. the loss, and every scalar the model reported during the forward,
   replaced by its mean over the ranks (one allreduce, as the JAX step
   ``pmean``s them), without a host sync;
5. the model's floating persistent values (BatchNormalization's running
   statistics) replaced by their mean over the ranks, in one allreduce
   of the flattened values (the JAX step ``pmean``s its persistent
   state); integer ones (BN's ``N``) stay per rank.

The exchanges:

* ``exchange="allreduce"`` (the default): ``communicator.
  multi_node_mean_grad`` (per leaf, one flat bucket or size-bounded
  buckets, the communicator's ``batch_collectives``), then the rule on
  every parameter; ``Parameter.grad`` holds the mean gradient.
* ``exchange="reduce_scatter"`` and ``zero_sharding=True`` (ZeRO-1): the
  parameters, in sorted path order, form one flat fp32 vector padded to
  ``n_pad = ceil(n / size) * size``, of which rank ``r`` owns
  ``[r n_pad / size, (r + 1) n_pad / size)``.  The packed gradient is
  reduce-scattered (each rank keeps the mean of its chunk), the rule runs
  on the chunk alone -- its state is the chunk's, ``1/size`` of the
  whole -- and the chunks of the new parameters are all-gathered and
  unpacked.  ``Parameter.grad`` is not populated (the mean gradient never
  exists whole).  Hooks run on the chunk: elementwise ones
  (``chunk_local``) unchanged, ``GradientClipping`` with the global norm
  (an allreduce of each chunk's sum of squares); any other hook raises
  ``ValueError``.  The state is serialized as whole flat vectors,
  gathered from every rank, so a snapshot does not depend on the world
  size (a resume under another size slices and re-pads them).
  ``zero_sharding`` is the reduce-scatter exchange under the ZeRO-1
  name, and refuses double buffering.  On a hierarchical communicator
  the reduce-scatter and the all-gather are hop chains (intra-node hop
  first, then the inter-node one; gathered in reverse), and the chunk a
  rank owns is the communicator's ``chunk_index`` (fast-hop-major, at a
  2 x 2 split ranks 0-3 own chunks 0, 2, 1, 3), not its rank.
* ``double_buffering=True`` (with either exchange): update ``t`` applies
  the mean gradient of step ``t - 1``; the first update applies zeros.
  Step ``t``'s gradient is packed into one of two flat buffers (in the
  wire dtype) and its allreduce -- or reduce-scatter -- is launched on
  the backend's stream (``async_op=True``); the step then waits only on
  the other buffer's exchange, launched one step earlier, and applies
  it.  On the card, step ``t``'s exchange thus runs on NCCL's stream
  under step ``t + 1``'s forward and backward.  The mean gradient in
  flight is serialized under ``stale_grads`` (waiting for it first), so
  a resume continues bitwise.  ``Parameter.grad`` holds this rank's own
  gradient of the step, not a mean.  ``add_hook``, ``remove_hook`` and
  ``setup`` start again from zeros, as in the JAX package.

A model with lazy parameters (``Linear(None, out)``) gets one forward
before its first step (lazy parameters that forward does not use, such
as GoogLeNet's auxiliary heads under a ``Classifier``, stay lazy and take
no part in the exchange or the update), whose persistent updates and
reports are dropped (as the JAX step's), and then ``bcast_data``, so that
every rank holds rank 0's parameters before the exchange and the rule
see them.

Each step opens the optimizer's per-step key scope (``core.rng``) with
this rank folded in, so every rank draws its own dropout masks.
``update_scan(lossfun, *stacked)`` runs K steps on batches stacked along
a leading step axis (``FusedUpdater``), step ``i``'s randomness from one
key of the call with the rank and then ``i`` folded in.

``update()`` with no arguments is the eager path: the gradients already
on ``Parameter.grad`` are averaged, then the rule runs (whatever the
exchange, as in the JAX package).  With the ``dummy`` communicator every
structure is the plain local update, as there.

A quantized wire with error feedback (the communicator's ``quantized``
and ``error_feedback``) makes the residual part of the wrapper's state:
a flat fp32 vector, zero-seeded on first use and again by ``setup``,
``add_hook`` and ``remove_hook``, which each exchange takes and replaces
(this rank's part of the JAX package's global vector: per bucket the
quantized hop's payload, or under the sharded update the chunk after the
intra-node hop).  It is serialized as the JAX package's ``ef_residual``
(``n``, ``r0``: the global vector in chunk order, ``world_size``); a
resume at another world size, or from a snapshot without the section,
starts again from zeros.

On a striped communicator (``stripe_ratio``) the sharded update's flat
vector splits at ``stripe_plan(n, ratio)`` into a ``{"ici", "dcn"}`` pair,
each slice padded to a multiple of ``size``: the ICI-path slice's chunks
land fast-hop-major (``chunk_index``), the DCN-path slice's slow-hop-major
(``striped_chunk_index``), and the rule's state is the pair, serialized
as the JAX package's optax state over the pair (per slot the ``dcn``
vector, then the ``ici`` one).  ``double_buffering="dcn"`` (the striped
allreduce exchange only) applies each step's ICI-path results fresh and
the DCN-path results of the step before (zeros first): on the card this
step's DCN path runs on under the next step's forward and backward.  Its
stale buffer (``grad_dcn_stale_len_for`` fp32 elements) serializes as
``stale_grads`` with one leaf.  A quantized wire does not compose with the
striped sharded update, and ``"dcn"`` needs a striped communicator and
the allreduce exchange: both are refused, as in the JAX package.

With tracing on (``CHAINERMN_TPU_TRACE``) each step's phases run in
spans: ``train/forward``, ``train/backward``, ``train/grad_exchange``
(tagged with the planned payload bytes and bucket count),
``train/rule``, ``train/persistent_mean`` and ``train/global_means``;
``update()`` with no arguments has the exchange and the rule.  On a CUDA
card each has a device twin (``observability.span(device=)``): the
stream's time from the phase's first work to its last, waits included.
Under double buffering the exchange's twin covers this step's enqueue
and the wait for the step before's exchange (``_take_stale``).  Each
bucket's hops are ``observability.scope`` ranges of the communicator's
(``train.grad_exchange.bucket{k}.*``), in profiler captures only.

``autotune`` tunes the communicator's exchange knobs
(``communicators._autotune``): ``True``/``"startup"`` runs the startup
micro-bench now, unless the communicator already carries an agreed plan,
and wraps the re-tuned communicator; ``"online"`` (or an int N, default
3) re-tunes once, after the first N updates, from the
``train/grad_exchange`` spans (on the card their device twins, each
step's fastest rank: ``_autotune.online_measurement``), and swaps the
re-tuned communicator in
through :meth:`change_communicator`.  Online mode reads the tracer, so it
needs ``CHAINERMN_TPU_TRACE``; with tracing off it warns and runs the
startup micro-bench instead, as in the JAX package.

:meth:`change_communicator` swaps the communicator after an elastic
resize (the JAX method's contract): the gradient in flight is waited for
and dropped, the double-buffered gradient and the error-feedback residual
start again from zeros, the exchange plan and the flat layout are made
again at the new size, the sharded update's state is re-sliced in memory
(or, ``via_checkpoint=True``, dropped for the consensus resume), and a
communicator that carries no plan is re-tuned by the micro-bench when the
outgoing one was tuned.

A model whose parameters only some ranks train (a
``MultiNodeChainList``: each rank runs and trains only the components it
owns) takes part in the exchange with the parameters that have a
gradient on this rank after the backward: the others are left out of the
exchange and the update, as ``Optimizer.update`` leaves them out,
instead of being moved by a zero gradient (with Adam a zero gradient
still moves the moments).  Every rank of a data-parallel group owns the
same components, so the groups' leaves agree.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import torch
from torch.nn.parameter import is_lazy

from . import observability
from .communicators._memory_utility import (chunk_bounds, padded_length,
                                            stripe_plan, tree_pack,
                                            tree_unpack)
from .communicators.mesh_communicator import PendingExchange
from .core import reporter as reporter_module
from .core import rng

__all__ = ["create_multi_node_optimizer"]

#: the state key of the sharded update's flat chunk
_FLAT = "flat"
#: communicators with a fused exchange (the reference allows double
#: buffering on ``pure_nccl`` only; the JAX package's list)
_DB_COMMUNICATORS = ("pure_nccl", "jax_ici", "hierarchical",
                     "two_dimensional", "single_node", "flat", "dummy")


def create_multi_node_optimizer(actual_optimizer, communicator,
                                double_buffering=False, zero_fill=True,
                                zero_sharding=False, exchange=None,
                                autotune=None):
    """Wrap an optimizer so that each update averages the gradients over
    ``communicator``.  The returned object forwards attribute access to
    ``actual_optimizer`` (the reference's delegation).  ``exchange``:
    ``None`` or ``"allreduce"`` (the per-leaf / flat / bucketed structure
    is the communicator's ``batch_collectives``), or
    ``"reduce_scatter"``."""
    online_after = 0
    if autotune not in (None, False, True, "startup", "online") \
            and not (isinstance(autotune, int)
                     and not isinstance(autotune, bool) and autotune > 0):
        raise ValueError(
            f"autotune must be True/'startup', 'online', or a positive "
            f"int (online re-tune after N updates); got {autotune!r}")
    if autotune and not hasattr(communicator, "retuned"):
        raise ValueError(
            f"autotune= tunes a mesh communicator, not "
            f"{type(communicator).__name__} — a silently dropped plan "
            f"would make an autotune run pass vacuously")
    if autotune:
        from .communicators._autotune import retune_communicator
        if autotune in (True, "startup"):
            if getattr(communicator, "autotune_plan", None) is None:
                communicator = retune_communicator(communicator,
                                                   mode="startup")
        elif observability.enabled():
            online_after = autotune if isinstance(autotune, int) \
                and not isinstance(autotune, bool) else 3
            communicator._autotune_mode = "online"
        else:
            warnings.warn(
                "autotune='online' reads the span tracer's "
                "train/grad_exchange spans but tracing is off "
                "(CHAINERMN_TPU_TRACE): running the startup "
                "micro-bench instead", UserWarning, stacklevel=2)
            if getattr(communicator, "autotune_plan", None) is None:
                communicator = retune_communicator(communicator,
                                                   mode="startup")
    if exchange is None:
        exchange = "allreduce"
    if exchange not in ("allreduce", "reduce_scatter"):
        raise ValueError(
            f"exchange must be 'allreduce' or 'reduce_scatter', got "
            f"{exchange!r} (per_leaf/flat/bucketed are communicator "
            f"batch_collectives flavors of the allreduce exchange)")
    striped = getattr(communicator, "striped", False)
    if (exchange == "reduce_scatter" or zero_sharding) and striped \
            and getattr(communicator, "quantized_wire_dtype",
                        None) is not None:
        raise ValueError(
            "a quantized (int8/fp8) wire does not compose with the "
            "STRIPED sharded update (zero_sharding or "
            "exchange='reduce_scatter') yet: the slow-hop-major chain "
            "has no quantized reduce-scatter.  Use the allreduce striped "
            "exchange (which quantizes both slices' DCN crossings) or the "
            "non-striped hierarchical_rs path")
    if zero_sharding and exchange == "reduce_scatter":
        raise ValueError(
            "zero_sharding already exchanges gradients via reduce-scatter; "
            "exchange='reduce_scatter' on top of it is a redundancy error")
    if double_buffering not in (False, True, "dcn"):
        raise ValueError(
            f"double_buffering must be False, True (full one-step-stale "
            f"semantics) or 'dcn' (the striped exchange's DCN-slice-only "
            f"stale variant); got {double_buffering!r}")
    if double_buffering:
        if zero_sharding:
            raise ValueError(
                "zero_sharding is incompatible with double buffering "
                "(a one-step-stale gradient buffer would defeat the "
                "sharded-state memory contract)")
        if double_buffering == "dcn":
            if not striped:
                raise ValueError(
                    "double_buffering='dcn' is the striped exchange's "
                    "DCN-slice-only stale variant: it needs a "
                    "communicator with stripe_ratio > 0 "
                    "(create_communicator('hierarchical', "
                    "stripe_ratio=...))")
            if exchange == "reduce_scatter":
                raise ValueError(
                    "double_buffering='dcn' rides the allreduce striped "
                    "exchange (the DCN-path slice of each bucket); with "
                    "exchange='reduce_scatter' use double_buffering=True: "
                    "the stale chunk is already 1/n-sized")
        if communicator.name not in _DB_COMMUNICATORS:
            raise ValueError(
                "double buffering requires a fused-bucket communicator "
                f"(reference: pure_nccl); got {communicator.name!r}")
    opt = _MultiNodeOptimizer(actual_optimizer, communicator, zero_fill,
                              zero_sharding=zero_sharding,
                              exchange=exchange,
                              double_buffering=double_buffering)
    opt.__dict__["_autotune_online_after"] = online_after
    return opt


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
    def __init__(self, actual_optimizer, communicator, zero_fill=True,
                 zero_sharding=False, exchange="allreduce",
                 double_buffering=False):
        self.__dict__.update(
            communicator=communicator, actual_optimizer=actual_optimizer,
            zero_fill=zero_fill, zero_sharding=zero_sharding,
            exchange=exchange, double_buffering=double_buffering,
            _pending=None, _stale=None, _stale_dcn=None, _layout=None,
            _residual=None, _obs_plan=None, _buffers=[None, None],
            _slot=0, _lazy_done=False, _autotune_online_after=0,
            _autotune_steps_done=0, _local_state=False)

    # -- reference-style delegation ---------------------------------------
    def __getattr__(self, name):
        return getattr(self.actual_optimizer, name)

    def __setattr__(self, name, value):
        if name in self.__dict__ or hasattr(type(self), name):
            super().__setattr__(name, value)
        else:
            setattr(self.actual_optimizer, name, value)

    @property
    def _sharded_update(self):
        """True for the flat reduce-scatter update (ZeRO-1 and
        ``exchange="reduce_scatter"``) on a real communicator."""
        return (self.zero_sharding or self.exchange == "reduce_scatter") \
            and self.communicator.name != "dummy"

    @property
    def _stale_exchange(self):
        """Full one-step-stale double buffering on a real communicator."""
        return self.double_buffering is True \
            and self.communicator.name != "dummy"

    @property
    def _db_dcn(self):
        """``double_buffering="dcn"``: fresh ICI-path results, one-step-
        stale DCN-path ones."""
        return self.double_buffering == "dcn" \
            and self.communicator.name != "dummy"

    @property
    def _striped_update(self):
        """True for the sharded update's ``{"ici", "dcn"}`` layout."""
        return self._sharded_update \
            and getattr(self.communicator, "striped", False)

    @property
    def _needs_residual(self):
        """True when the exchange carries an error-feedback residual: a
        quantized hop with error feedback on."""
        comm = self.communicator
        return bool(getattr(comm, "quantized", False)
                    and getattr(comm, "error_feedback", False))

    def _residual_len(self):
        """This rank's residual length: under the sharded update the
        quantized hop's input, the chunk after the intra-node hop
        (``n_pad / intra``, the whole padded vector when flat); else the
        communicator's per-bucket accounting."""
        comm = self.communicator
        if self._sharded_update:
            n_pad = self._segments()[0][3]
            return n_pad // comm.ici_size if comm.hierarchy is not None \
                else n_pad
        return comm.grad_residual_len_for(self.actual_optimizer.target)

    def _residual_in(self):
        """The residual this step's exchange takes: ``None`` without error
        feedback, zeros before the first exchange (no error made yet)."""
        if not self._needs_residual:
            return None
        if self._residual is None:
            device = next(self.actual_optimizer.target.parameters()).device
            self.__dict__["_residual"] = torch.zeros(
                self._residual_len(), dtype=torch.float32, device=device)
        return self._residual

    def _keep_residual(self, residual):
        """The residual an exchange returned (``None`` without one)."""
        self.__dict__["_residual"] = residual

    def _reset_exchange(self):
        """Back to the first step's state: no gradient in flight (one
        still running is waited for, so its buffer can go), none stale,
        the flat layout recomputed at the next step."""
        if self._pending is not None:
            self._pending.wait()
        self.__dict__.update(_pending=None, _stale=None, _stale_dcn=None,
                             _layout=None, _buffers=[None, None], _slot=0)

    def setup(self, link):
        self.actual_optimizer.setup(link)
        self._reset_exchange()
        self.__dict__.update(_lazy_done=False, _residual=None,
                             _obs_plan=None)
        return self

    def add_hook(self, hook, name=None, timing="pre"):
        self.actual_optimizer.add_hook(hook, name, timing)
        self._reset_exchange()
        self.__dict__["_residual"] = None

    def remove_hook(self, name):
        self.actual_optimizer.remove_hook(name)
        self._reset_exchange()
        self.__dict__["_residual"] = None

    # -- the communicator -------------------------------------------------------
    def _layout_key(self, comm):
        """What the sharded update's flat layout depends on."""
        return (comm.size, getattr(comm, "chunk_index", comm.rank),
                bool(getattr(comm, "striped", False)),
                getattr(comm, "stripe_ratio", 0.0))

    def change_communicator(self, communicator, via_checkpoint=False):
        """Swap the communicator, re-planning every piece of state whose
        layout depends on the world (the JAX elastic contract); returns
        ``self``.

        * The parameters and the replicated (per-parameter) state are
          kept: every rank holds them whole.
        * The exchange plan and the sharded update's flat layout (its
          padding and this rank's chunk) are derived again at the next
          step.
        * The gradient in flight is waited for and dropped; the
          double-buffered gradient and the error-feedback residual start
          again from zeros (per-rank content with no meaning in another
          partition: one step of staleness or correction, never
          correctness).
        * The sharded update's state is re-sliced in memory at the new
          layout: its whole flat vectors are gathered over the OUTGOING
          communicator (a collective over the old world, which must still
          be up; none for an old world of one), then this rank takes its
          new chunk.  With ``via_checkpoint=True`` it is dropped instead,
          for the checkpointer's consensus ``maybe_load`` to restore (an
          elastic rebuild: the old world spans departed ranks and is
          already torn down).  A change of the striped layout (striped to
          flat, or another ``stripe_ratio``) needs ``via_checkpoint``.
        * When the outgoing communicator was tuned (``autotune``) and the
          new one carries no plan, the new one takes the old one's
          hand-knob provenance and is re-tuned by the startup micro-bench
          (collective over the new world)."""
        old = self.communicator
        if communicator is old:
            return self
        if getattr(old, "_autotune_mode", None) \
                and hasattr(communicator, "retuned") \
                and communicator.autotune_plan is None:
            hand = getattr(old, "_hand_knobs", None)
            if hand is not None:
                communicator._hand_knobs = dict(hand)
            communicator._autotune_mode = old._autotune_mode
            from .communicators._autotune import retune_communicator
            communicator = retune_communicator(communicator,
                                               mode="startup")
        actual = self.actual_optimizer
        leaves = None
        if self._sharded_update and actual._state \
                and self._layout_key(old) != self._layout_key(
                    communicator):
            striped_change = (
                (bool(getattr(old, "striped", False)),
                 getattr(old, "stripe_ratio", 0.0))
                != (bool(getattr(communicator, "striped", False)),
                    getattr(communicator, "stripe_ratio", 0.0)))
            if striped_change and not via_checkpoint:
                raise RuntimeError(
                    "change_communicator across a striped-layout change "
                    "(striped<->flat chunking or a different "
                    "stripe_ratio) needs via_checkpoint=True: the "
                    "sharded flat state cannot be re-sliced in memory "
                    "across split layouts")
            if not via_checkpoint:
                # whole vectors, gathered over the old world (a world of
                # one holds them already: no collective)
                local = old.size == 1
                self.__dict__["_local_state"] = local
                try:
                    leaves = self._save_flat_state()
                finally:
                    self.__dict__["_local_state"] = False
            actual._state = {}
        self._reset_exchange()
        self.__dict__.update(communicator=communicator, _residual=None,
                             _obs_plan=None)
        if leaves is not None:
            self._load_flat_state(leaves)
        return self

    def _maybe_online_retune(self):
        """Online autotune: after the armed number of updates, derive a
        plan from the tracer's ``train/grad_exchange`` spans, agree it
        across the ranks and swap the re-tuned communicator in.  Once: the
        count disarms whether or not the plan changed anything.  A plan
        the sharded layout cannot take in memory is warned about and
        skipped."""
        n = self._autotune_online_after
        if not n:
            return
        done = self._autotune_steps_done + 1
        self.__dict__["_autotune_steps_done"] = done
        if done < n:
            return
        self.__dict__["_autotune_online_after"] = 0
        from .communicators._autotune import (agree_exchange_plan,
                                              online_measurement)
        comm = self.communicator
        plan = agree_exchange_plan(comm, online_measurement(
            comm, observability.tracer().events()))
        new_comm = comm.retuned(plan)
        if new_comm is comm:
            return
        try:
            self.change_communicator(new_comm)
        except RuntimeError as e:
            warnings.warn(
                f"online autotune plan {plan.get('fingerprint')} not "
                f"applied: {e}", RuntimeWarning, stacklevel=2)

    # -- update -------------------------------------------------------------
    def update(self, lossfun=None, *args, **kwargs):
        actual = self.actual_optimizer
        if actual.target is None:
            raise RuntimeError("setup(link) was not called")
        comm = self.communicator
        if lossfun is None:
            # the reference's flow: backward, allreduce_grad, update
            device = self._span_device()
            with observability.span("train/grad_exchange",
                                    tags=self._exchange_tags(),
                                    device=device):
                self._keep_residual(comm.multi_node_mean_grad(
                    actual.target, zero_fill=self.zero_fill,
                    residual=self._residual_in()))
            with observability.span("train/rule", device=device):
                out = actual.update()
            self._maybe_online_retune()
            return out
        self._prepare(lossfun, args, kwargs)
        loss, observation = self._step(lossfun, args, kwargs,
                                       actual.step_key_scope(comm.rank))
        reporter_module.report(observation)
        self._maybe_online_retune()
        return loss

    def update_scan(self, lossfun, *args, **kwargs):
        """K training steps in one call: every tensor in ``args`` and
        ``kwargs`` carries a leading step axis of length K on top of its
        batch axis (``(K, batch, ...)``), and step ``i`` runs the step of
        :meth:`update` on slice ``i``.  The steps draw their randomness
        from one key of the call with this rank and then ``i`` folded in
        (the JAX ``update_scan``'s keys), so a stochastic model's masks
        differ from K :meth:`update` calls'; a deterministic model's K
        steps equal them.  Reports the mean of the K steps'
        observations; returns the K losses.  Double buffering is refused,
        as in the JAX package."""
        if self.double_buffering:
            raise RuntimeError("update_scan does not support double "
                               "buffering; use update()")
        actual = self.actual_optimizer
        if actual.target is None:
            raise RuntimeError("setup(link) was not called")
        leaves = list(args) + list(kwargs.values())
        if not leaves or any(not isinstance(a, torch.Tensor) or a.dim() < 2
                             for a in leaves):
            raise ValueError("update_scan arguments must be tensors with a "
                             "leading (n_steps, batch, ...) axis")
        n_steps = leaves[0].shape[0]
        if any(a.shape[0] != n_steps for a in leaves):
            raise ValueError("all update_scan arguments must share the "
                             "same leading step-axis length")
        comm = self.communicator
        key = rng.fold_in(actual._next_rng_key(), comm.rank)
        device = next(actual.target.parameters()).device
        losses, observations = [], []
        for i in range(n_steps):
            a_i = tuple(a[i] for a in args)
            kw_i = {k: v[i] for k, v in kwargs.items()}
            if i == 0:
                self._prepare(lossfun, a_i, kw_i)
            loss, observation = self._step(
                lossfun, a_i, kw_i,
                rng.key_scope(rng.fold_in(key, i), device))
            losses.append(loss)
            observations.append(observation)
        reporter_module.report({
            k: torch.stack([torch.as_tensor(o[k], dtype=torch.float32)
                            .reshape(()) for o in observations]).mean()
            for k in observations[0]
            if all(k in o for o in observations)})
        return torch.stack(losses)

    def _prepare(self, lossfun, args, kwargs):
        """Checks and one-time work before a step on ``args``: the debug
        communicator's signature check, the sharded update's hooks, the
        lazy parameters."""
        comm = self.communicator
        if hasattr(comm, "verify_step_signature"):
            # debug communicator: agree on the batch's shapes first
            comm.verify_step_signature((args, kwargs))
        if self._sharded_update:
            self._chunk_hooks()   # refuse a hook before any work is done
        if not self._lazy_done:
            # once: what the forward leaves lazy it does not use (say
            # GoogLeNet's auxiliary heads under a Classifier)
            if any(is_lazy(p)
                   for p in self.actual_optimizer.target.parameters()):
                self._init_lazy(lambda: lossfun(*args, **kwargs))
            self.__dict__["_lazy_done"] = True

    def _step(self, lossfun, args, kwargs, key_scope):
        """One data-parallel step, its draws from ``key_scope``: forward,
        backward, exchange, rule, the persistent values' mean, each a
        span.  Returns the mean loss and the mean observation (not yet
        reported)."""
        self.actual_optimizer.target.cleargrads()
        device = self._span_device()
        with observability.span("train/forward", device=device), key_scope:
            loss, observation = _observed(lambda: lossfun(*args, **kwargs))
        if isinstance(loss, tuple):
            loss = loss[0]
        with observability.span("train/backward", device=device):
            grads = self._gradients(loss)
        with observability.span("train/grad_exchange",
                                tags=self._exchange_tags(), device=device):
            exchanged = self._exchange(grads)
        with observability.span("train/rule", device=device):
            self._apply_update(exchanged)
        with observability.span("train/persistent_mean", device=device):
            self._mean_persistent()
        with observability.span("train/global_means", device=device):
            return self._global_means(loss, observation)

    # -- telemetry (tracing on only) -------------------------------------------
    def _span_device(self):
        """The device of the phase spans' twins: the parameters' (None
        with tracing off)."""
        if not observability.enabled():
            return None
        return next(self.actual_optimizer.target.parameters()).device

    def _exchange_tags(self):
        """The ``train/grad_exchange`` span's tags: the planned payload
        bytes (in the gradient's own dtype) and bucket count, cached until
        ``setup`` (``None`` with tracing off: built only when they are
        recorded, and without a bucket plan)."""
        if not observability.enabled():
            return None
        if self._obs_plan is None:
            comm = self.communicator
            target = self.actual_optimizer.target
            tags = {}
            if hasattr(comm, "grad_buckets_for"):
                shapes, dtypes = comm.grad_leaf_specs(target)
                buckets = comm.grad_buckets_for(target)
                if buckets:
                    tags = {"payload_bytes": sum(
                        int(np.prod(shapes[i])) * dtypes[i].itemsize
                        for idx in buckets for i in idx),
                        "buckets": len(buckets)}
            self.__dict__["_obs_plan"] = tags
        return self._obs_plan or None

    def _sorted_params(self):
        """``(paths, parameters)`` in sorted path order: the order of the
        JAX params tree, which the flat layouts and the stale buffer
        follow."""
        named = sorted(((p, v) for p, v in
                        self.actual_optimizer.target.namedparams()
                        if not is_lazy(v)
                        and not getattr(v, "_mn_not_owned", False)),
                       key=lambda kv: kv[0])
        return [p for p, _ in named], [v for _, v in named]

    def _gradients(self, loss):
        """The backward: this rank's gradients in sorted path order,
        zeros where a parameter took none (the JAX gradient's).  The
        sharded update leaves ``Parameter.grad`` unset; the plain
        exchange reads it there (and returns ``None``)."""
        if not (self._sharded_update or self._stale_exchange):
            loss.backward()
            return None
        _, params = self._sorted_params()
        if self._sharded_update:
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        else:
            loss.backward()
            grads = [p.grad for p in params]
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(params, grads)]

    def _exchange(self, grads):
        """The gradient exchange of one step: what the rule is to apply
        (the plain exchange leaves it on ``Parameter.grad``)."""
        comm = self.communicator
        residual = self._residual_in()
        if grads is None and self._db_dcn:
            new_residual, fresh = comm.multi_node_mean_grad(
                self.actual_optimizer.target, zero_fill=self.zero_fill,
                residual=residual, stale_dcn=self._stale_dcn_in())
            self._keep_residual(new_residual)
            self.__dict__["_stale_dcn"] = fresh
            return None
        if grads is None:
            self._keep_residual(comm.multi_node_mean_grad(
                self.actual_optimizer.target, zero_fill=self.zero_fill,
                residual=residual))
            return None
        if self._sharded_update:
            with torch.no_grad():
                flat, _ = tree_pack(grads, torch.float32)
                flat = self._per_slice(lambda seg: torch.nn.functional.pad(
                    flat[seg[1]:seg[1] + seg[2]], (0, seg[3] - seg[2])))
            exchange = comm.reduce_scatter_grad(
                flat, async_op=self._stale_exchange, residual=residual)
            self._keep_residual(exchange.residual)
            if not self._stale_exchange:
                return exchange.wait()
        else:
            exchange = comm.allreduce_grad_async(
                self._pack(grads), shapes=[tuple(g.shape) for g in grads],
                residual=residual)
            self._keep_residual(exchange.residual)
        previous = self._take_stale()
        self.__dict__["_pending"] = exchange
        return previous

    def _pack(self, grads):
        """``grads`` copied into the next of the two flat buffers, in the
        wire's cast dtype."""
        dtype = getattr(self.communicator, "grad_cast_dtype",
                        None) or grads[0].dtype
        n = sum(g.numel() for g in grads)
        buf = self._buffers[self._slot]
        if buf is None or buf.numel() != n or buf.dtype != dtype:
            buf = torch.empty(n, dtype=dtype, device=grads[0].device)
            self._buffers[self._slot] = buf
        self.__dict__["_slot"] = 1 - self._slot
        views = [v.view(g.shape) for v, g in
                 zip(buf.split([g.numel() for g in grads]), grads)]
        with torch.no_grad():
            torch._foreach_copy_(views, list(grads))
        return buf

    def _take_stale(self):
        """The previous step's mean gradient (waiting for its exchange),
        or the one a snapshot restored, or zeros before any."""
        if self._pending is not None:
            stale = self._finish(self._pending.wait())
            self.__dict__["_pending"] = None
        elif self._stale is not None:
            stale = self._stale
        else:
            stale = self._zeros()
        self.__dict__["_stale"] = None
        return stale

    def _finish(self, mean):
        """An exchange's result as what the rule applies: the sharded
        update's fp32 chunk as it is, the allreduced flat buffer cut
        into the parameters' shapes and dtypes."""
        if self._sharded_update:
            return mean
        _, params = self._sorted_params()
        return tree_unpack(mean, ([tuple(p.shape) for p in params],
                                  [p.dtype for p in params]))

    def _zeros(self):
        if self._sharded_update:
            device = self._sorted_params()[1][0].device
            return self._per_slice(lambda seg: torch.zeros(
                seg[5] - seg[4], dtype=torch.float32, device=device))
        return [torch.zeros_like(p) for p in self._sorted_params()[1]]

    def _stale_dcn_in(self):
        """``double_buffering="dcn"``'s previous DCN-path results: the
        pending exchange of the step before, or the vector a snapshot
        restored, or zeros before any."""
        if self._stale_dcn is None:
            comm = self.communicator
            target = self.actual_optimizer.target
            zeros = torch.zeros(comm.grad_dcn_stale_len_for(target),
                                dtype=torch.float32,
                                device=next(target.parameters()).device)
            return PendingExchange(None, lambda: zeros)
        return self._stale_dcn

    def _apply_update(self, exchanged):
        """The rule on what :meth:`_exchange` returned: on every
        parameter, or on this rank's chunk followed by the all-gather
        of the new parameters."""
        actual = self.actual_optimizer
        if exchanged is None:
            actual.update()
            return
        paths, params = self._sorted_params()
        if not self._sharded_update:
            actual._apply_to(paths, params, exchanged)
            return
        segments = self._segments()
        with torch.no_grad():
            flat, spec = tree_pack(params, torch.float32)
            chunks = self._per_slice(lambda seg: torch.nn.functional.pad(
                flat[seg[1]:seg[1] + seg[2]], (0, seg[3] - seg[2]))[
                    seg[4]:seg[5]])
        actual._apply_to([seg[0] for seg in segments], self._slices(chunks),
                         self._slices(exchanged), hooks=self._chunk_hooks())
        full = self._slices(self.communicator.allgather_flat(chunks))
        with torch.no_grad():
            new_flat = torch.cat([f[:seg[2]] for f, seg in sorted(
                zip(full, segments), key=lambda fs: fs[1][1])])
            torch._foreach_copy_(params, tree_unpack(new_flat, spec))

    def _flat_layout(self):
        """``(n, n_pad, start, stop)`` of the plain sharded update: the
        flat vector's length, its padded length and this rank's chunk
        (the communicator's ``chunk_index``: where the reduce-scatter
        chain leaves it)."""
        _, _, n, n_pad, lo, hi = self._segments()[0]
        return n, n_pad, lo, hi

    def _segments(self):
        """The sharded update's flat slices, each ``(key, offset in the
        parameter vector, length, padded length, start, stop of this
        rank's chunk)``: one ``"flat"`` slice, or on a striped
        communicator the ``"dcn"`` and ``"ici"`` slices of
        ``stripe_plan(n, ratio)`` (the JAX state's leaf order), each padded
        to a multiple of ``size``, the ICI-path chunks fast-hop-major
        (``chunk_index``) and the DCN-path ones slow-hop-major
        (``striped_chunk_index``)."""
        _, params = self._sorted_params()
        n = sum(p.numel() for p in params)
        if self._layout is None or self._layout[0] != n:
            comm = self.communicator
            size = comm.size
            if self._striped_update:
                fast, slow = comm.striped_chunk_specs()
                n_i, n_d = stripe_plan(n, comm.stripe_ratio)
                pad_i, pad_d = padded_length(n_i, size), padded_length(
                    n_d, size)
                segments = [
                    ("dcn", n_i, n_d, pad_d, *chunk_bounds(pad_d, size, slow)),
                    ("ici", 0, n_i, pad_i, *chunk_bounds(pad_i, size, fast))]
            else:
                n_pad = padded_length(n, size)
                segments = [(_FLAT, 0, n, n_pad, *chunk_bounds(
                    n_pad, size, getattr(comm, "chunk_index", comm.rank)))]
            self.__dict__["_layout"] = (n, segments)
        return self._layout[1]

    def _per_slice(self, fn):
        """``fn(segment)`` for each flat slice: one tensor, or the striped
        ``{"dcn", "ici"}`` pair."""
        out = {seg[0]: fn(seg) for seg in self._segments()}
        return out if self._striped_update else out[_FLAT]

    def _slices(self, x):
        """A :meth:`_per_slice` value as a list in the slices' order."""
        return [x[seg[0]] for seg in self._segments()] \
            if self._striped_update else [x]

    def _chunk_hooks(self):
        """The registered hooks as they run on a chunk of the flat
        gradient."""
        hooks = []
        for name, hook in self.actual_optimizer._hooks.items():
            if hasattr(hook, "sharded"):
                hooks.append(hook.sharded(self.communicator))
            elif getattr(hook, "chunk_local", False):
                hooks.append(hook)
            else:
                raise ValueError(
                    f"hook {name!r} cannot run under zero_sharding or "
                    f"exchange='reduce_scatter': it is not marked "
                    f"chunk_local (elementwise) and provides no "
                    f"sharded(communicator) variant, and applying it to "
                    f"one rank's chunk of the gradient would change what "
                    f"it computes if it reads the whole gradient")
        return hooks

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
        replaced by its mean over the ranks in one allreduce: ``(mean
        loss, observation)``."""
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
        return loss, observation

    # -- serialization --------------------------------------------------------
    def serialize(self, serializer):
        """The JAX wrapper's keys: the wrapped optimizer's (under the
        sharded update its state leaves are whole flat vectors), and
        under double buffering the mean gradient in flight as
        ``stale_grads/n`` and ``stale_grads/g<i>`` (per parameter in
        sorted path order, or the one flat vector).  Under the sharded
        update this is a collective: every rank serializes.

        In the per-rank mode (``_local_state``, set by the per-rank DCP
        checkpointer) the flat vectors are this rank's own chunks, written
        and read without a collective, beside ``local_chunk`` (the world
        size and this rank's chunk index, and, striped, its DCN-path chunk
        index: :meth:`local_layout`) and ``local_chunk_keys`` (each chunked
        key with the entry of ``local_chunk`` that orders it).  A per-rank
        read holds ``local_chunk`` to this rank's layout; a reader at
        another layout is given the whole vectors instead (every writer's
        chunks in that order) and reads them in the plain mode."""
        actual = self.actual_optimizer
        local = self._local_state and actual.target is not None \
            and (self._sharded_update or self._needs_residual)
        if local:
            self._check_local_layout(serializer)
        if self._sharded_update:
            actual.serialize_with(serializer, self._save_flat_state,
                                  self._load_flat_state)
        else:
            actual.serialize(serializer)
        if self._needs_residual and actual.target is not None:
            self._serialize_residual(serializer["ef_residual"])
        if self._stale_exchange and actual.target is not None:
            self._serialize_stale(serializer["stale_grads"])
        if self._db_dcn and actual.target is not None:
            self._serialize_stale_dcn(serializer["stale_grads"])
        if local and serializer.is_writer:
            serializer("local_chunk_keys", json.dumps(self._chunk_keys()))

    def local_layout(self):
        """``local_chunk`` of the per-rank mode (world size, chunk index,
        and on a striped communicator the DCN-path chunk index), or None
        when this optimizer writes no per-rank state."""
        comm = self.communicator
        if self.actual_optimizer.target is None \
                or not (self._sharded_update or self._needs_residual):
            return None
        mine = [comm.size, getattr(comm, "chunk_index", comm.rank)]
        if self._striped_update:
            mine.append(comm.striped_chunk_index)
        return np.array(mine, np.int64)

    def _check_local_layout(self, serializer):
        """The per-rank mode's ``local_chunk`` key: written, or read and
        held against this rank's layout."""
        mine = self.local_layout()
        if serializer.is_writer:
            serializer("local_chunk", mine)
            return
        saved = serializer("local_chunk", None)
        if saved is None or not np.array_equal(np.asarray(saved), mine):
            raise ValueError(
                f"per-rank optimizer state of layout {saved} read at "
                f"layout {mine.tolist()}: a reader at another world size "
                f"or split takes the whole vectors (every writer's chunks "
                f"in chunk order) in the plain mode")

    def _chunk_keys(self):
        """``[key, entry]`` of every leaf this rank has just written as its
        own chunk: the entry of ``local_chunk`` that orders the writers'
        chunks of it (1, the chunk index; 2, the DCN-path one)."""
        actual = self.actual_optimizer
        segs = [seg[0] for seg in self._segments()]

        def entry(key):
            return 2 if key == "dcn" else 1
        out = []
        if self._sharded_update and all(k in actual._state for k in segs):
            start = int(actual._has_count)
            out += [[f"opt_state_{start + i}", entry(segs[i % len(segs)])]
                    for i in range(len(actual._slots) * len(segs))]
        if self._sharded_update and self._stale_exchange \
                and self._stale is not None:
            out += [[f"stale_grads/g{i}", entry(k)]
                    for i, k in enumerate(segs)]
        if self._needs_residual and self._residual is not None:
            out.append(["ef_residual/r0", 1])
        return out

    def _whole(self, chunk, key=_FLAT):
        """Every rank's chunk of the flat slice ``key``, gathered in chunk
        order (the reverse hop chain): the whole slice on the host.  In
        the per-rank mode, this rank's chunk as it is."""
        if self._local_state:
            return chunk.cpu().numpy()
        comm = self.communicator
        if key != _FLAT:
            return comm.allgather_flat({key: chunk})[key].cpu().numpy()
        return comm.allgather_flat(chunk).cpu().numpy()

    def _serialize_stale_dcn(self, sub):
        """``double_buffering="dcn"``'s stale buffer as the JAX package
        writes it: ``n`` 1 and ``g0``, every bucket's DCN-path results
        (the same on every rank).  Read back it is applied by the next
        step; a snapshot without it, or of another length, leaves zeros."""
        if sub.is_writer:
            if self._stale_dcn is not None:
                stale = self._stale_dcn.wait()
                self.__dict__["_stale_dcn"] = PendingExchange(
                    None, lambda: stale)
                sub("n", 1)
                sub("g0", stale.cpu().numpy())
            return
        self.__dict__["_stale_dcn"] = None
        try:
            n = sub("n", None)
        except KeyError:  # saved before the first update
            return
        if n is None or int(n) != 1:
            return
        comm = self.communicator
        target = self.actual_optimizer.target
        leaf = np.asarray(sub("g0", None), np.float32).reshape(-1)
        if leaf.shape[0] != comm.grad_dcn_stale_len_for(target):
            return
        stale = torch.from_numpy(leaf.copy()).to(
            next(target.parameters()).device)
        self.__dict__["_stale_dcn"] = PendingExchange(None, lambda: stale)

    def _serialize_residual(self, sub):
        """The JAX package's ``ef_residual`` section: ``n`` (1), ``r0``
        (the global residual, every rank's part in chunk order) and
        ``world_size``.  Collective when writing.  Read back, this rank
        takes its part; a snapshot of another world size, of another
        length or without the section leaves the residual to be
        zero-seeded (the residual is per-rank quantization error with no
        meaning in another partition: one step of correction is lost,
        never correctness)."""
        if sub.is_writer:
            if self._pending is not None:
                self.__dict__["_stale"] = self._take_stale()
            if self._stale_dcn is not None:
                self._stale_dcn.wait()   # the DCN path writes its part
            if self._residual is not None:
                sub("n", 1)
                sub("r0", self._whole(self._residual))
                sub("world_size", self.communicator.size)
            return
        self.__dict__["_residual"] = None
        try:
            n = sub("n", None)
        except KeyError:  # no section (saved without error feedback)
            return
        try:
            saved_size = int(sub("world_size", -1))
        except KeyError:
            saved_size = -1
        if n is None or int(n) < 1 \
                or saved_size not in (-1, self.communicator.size):
            return
        whole = np.asarray(sub("r0", None), np.float32).reshape(-1)
        local = self._residual_len()
        if self._local_state:   # this rank's own part
            if whole.shape[0] != local:
                return
            at = 0
        elif whole.shape[0] != local * self.communicator.size:
            return
        else:
            at = getattr(self.communicator, "chunk_index",
                         self.communicator.rank) * local
        device = self._sorted_params()[1][0].device
        self.__dict__["_residual"] = torch.from_numpy(
            whole[at:at + local].copy()).to(device)

    def _my_chunk(self, leaf, key=_FLAT):
        """This rank's chunk of a whole flat slice ``key`` saved under any
        world size (cut to the slice's length, padded to this size's)."""
        _, _, n, n_pad, lo, hi = next(seg for seg in self._segments()
                                      if seg[0] == key)
        leaf = np.asarray(leaf, np.float32).reshape(-1)
        device = self._sorted_params()[1][0].device
        if self._local_state:   # this rank's chunk, saved as it is
            if leaf.shape[0] != hi - lo:
                raise ValueError(f"chunk of {leaf.shape[0]} elements for "
                                 f"this rank's {hi - lo}")
            return torch.from_numpy(leaf.copy()).to(device)
        if leaf.shape[0] < n:
            raise ValueError(f"flat vector of {leaf.shape[0]} elements "
                             f"for {n} parameters")
        full = np.zeros(n_pad, np.float32)
        full[:n] = leaf[:n]
        return torch.from_numpy(full[lo:hi].copy()).to(device)

    def _save_flat_state(self):
        """The rule's state as the JAX package's flat optax leaves:
        ``count``, then per slot the whole flat vector of each slice."""
        actual = self.actual_optimizer
        keys = [seg[0] for seg in self._segments()]
        if any(k not in actual._state for k in keys):
            return None
        sts = [actual._state[k] for k in keys]
        leaves = [np.asarray(sts[0]["count"], np.int32)] \
            if actual._has_count else []
        return leaves + [self._whole(st[slot], k) for slot in actual._slots
                         for k, st in zip(keys, sts)]

    def _load_flat_state(self, leaves):
        actual = self.actual_optimizer
        keys = [seg[0] for seg in self._segments()]
        want = int(actual._has_count) + len(actual._slots) * len(keys)
        if len(leaves) != want:
            raise ValueError(
                f"optimizer state has {len(leaves)} leaves, the flat "
                f"state of {type(actual).__name__} takes {want}")
        leaves = list(leaves)
        count = int(np.asarray(leaves.pop(0))) if actual._has_count else 0
        state = {k: {"count": count} for k in keys}
        for slot in actual._slots:
            for k in keys:
                state[k][slot] = self._my_chunk(leaves.pop(0), k)
        actual._state = state

    def _serialize_stale(self, sub):
        if sub.is_writer:
            if self._pending is not None:
                self.__dict__["_stale"] = self._take_stale()
            if self._stale is None:
                return
            if self._striped_update:
                leaves = [self._whole(self._stale[k], k)
                          for k, *_ in self._segments()]
            elif self._sharded_update:
                leaves = [self._whole(self._stale)]
            else:
                leaves = [g.detach().cpu().numpy() for g in self._stale]
            sub("n", len(leaves))
            for i, leaf in enumerate(leaves):
                sub(f"g{i}", leaf)
            return
        try:
            n = sub("n", None)
        except KeyError:  # saved before the first update
            n = None
        self._reset_exchange()
        if n is None:
            return
        leaves = [sub(f"g{i}", None) for i in range(int(n))]
        if self._sharded_update:
            keys = [seg[0] for seg in self._segments()]
            if len(leaves) != len(keys):
                raise ValueError(f"stale_grads has {len(leaves)} leaves "
                                 f"for the {len(keys)} flat slices")
            stale = self._per_slice(
                lambda seg: self._my_chunk(leaves[keys.index(seg[0])],
                                           seg[0]))
        else:
            _, params = self._sorted_params()
            if len(leaves) != len(params):
                raise ValueError(f"stale_grads has {len(leaves)} leaves "
                                 f"for {len(params)} parameters")
            stale = [torch.from_numpy(np.array(g)).to(p.device, p.dtype)
                     .view_as(p) for g, p in zip(leaves, params)]
        self.__dict__["_stale"] = stale
