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
  name, and refuses double buffering.
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

What raises: ``double_buffering="dcn"`` (the striped exchange's
variant), the quantized wires (the communicator refuses them) and
``autotune`` wait for ROADMAP A10.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn.parameter import is_lazy

from .communicators._memory_utility import (chunk_bounds, padded_length,
                                            tree_pack, tree_unpack)
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
    if zero_sharding and exchange == "reduce_scatter":
        raise ValueError(
            "zero_sharding already exchanges gradients via reduce-scatter; "
            "exchange='reduce_scatter' on top of it is a redundancy error")
    if double_buffering not in (False, True, "dcn"):
        raise ValueError(
            f"double_buffering must be False, True or 'dcn'; got "
            f"{double_buffering!r}")
    if double_buffering:
        if zero_sharding:
            raise ValueError(
                "zero_sharding is incompatible with double buffering "
                "(a one-step-stale gradient buffer would defeat the "
                "sharded-state memory contract)")
        if double_buffering == "dcn":
            raise NotImplementedError(
                "double_buffering='dcn' is the striped exchange's "
                "DCN-slice-only stale variant, not ported yet "
                "(ROADMAP A10)")
        if communicator.name not in _DB_COMMUNICATORS:
            raise ValueError(
                "double buffering requires a fused-bucket communicator "
                f"(reference: pure_nccl); got {communicator.name!r}")
    return _MultiNodeOptimizer(actual_optimizer, communicator, zero_fill,
                               zero_sharding=zero_sharding,
                               exchange=exchange,
                               double_buffering=bool(double_buffering))


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
            _pending=None, _stale=None, _layout=None,
            _buffers=[None, None], _slot=0, _lazy_done=False)

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
        return self.double_buffering and self.communicator.name != "dummy"

    def _reset_exchange(self):
        """Back to the first step's state: no gradient in flight (one
        still running is waited for, so its buffer can go), none stale,
        the flat layout recomputed at the next step."""
        if self._pending is not None:
            self._pending.wait()
        self.__dict__.update(_pending=None, _stale=None, _layout=None,
                             _buffers=[None, None], _slot=0)

    def setup(self, link):
        self.actual_optimizer.setup(link)
        self._reset_exchange()
        self.__dict__["_lazy_done"] = False
        return self

    def add_hook(self, hook, name=None, timing="pre"):
        self.actual_optimizer.add_hook(hook, name, timing)
        self._reset_exchange()

    def remove_hook(self, name):
        self.actual_optimizer.remove_hook(name)
        self._reset_exchange()

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
        self._prepare(lossfun, args, kwargs)
        loss, observation = self._step(lossfun, args, kwargs,
                                       actual.step_key_scope(comm.rank))
        reporter_module.report(observation)
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
        backward, exchange, rule, the persistent values' mean.  Returns
        the mean loss and the mean observation (not yet reported)."""
        self.actual_optimizer.target.cleargrads()
        with key_scope:
            loss, observation = _observed(lambda: lossfun(*args, **kwargs))
        if isinstance(loss, tuple):
            loss = loss[0]
        self._apply_update(self._exchange(self._gradients(loss)))
        self._mean_persistent()
        return self._global_means(loss, observation)

    def _sorted_params(self):
        """``(paths, parameters)`` in sorted path order: the order of the
        JAX params tree, which the flat layouts and the stale buffer
        follow."""
        named = sorted(((p, v) for p, v in
                        self.actual_optimizer.target.namedparams()
                        if not is_lazy(v)), key=lambda kv: kv[0])
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
        if grads is None:
            comm.multi_node_mean_grad(self.actual_optimizer.target,
                                      zero_fill=self.zero_fill)
            return None
        if self._sharded_update:
            n, n_pad, _, _ = self._flat_layout()
            with torch.no_grad():
                flat, _ = tree_pack(grads, torch.float32)
                flat = torch.nn.functional.pad(flat, (0, n_pad - n))
            exchange = comm.reduce_scatter_grad(
                flat, async_op=self._stale_exchange)
            if not self._stale_exchange:
                return exchange.wait()
        else:
            exchange = comm.allreduce_grad_async(self._pack(grads))
        previous = self._take_stale()
        self.__dict__["_pending"] = exchange
        return previous

    def _pack(self, grads):
        """``grads`` copied into the next of the two flat buffers, in the
        wire dtype."""
        dtype = self.communicator.allreduce_grad_dtype or grads[0].dtype
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
            _, _, lo, hi = self._flat_layout()
            _, params = self._sorted_params()
            return torch.zeros(hi - lo, dtype=torch.float32,
                               device=params[0].device)
        return [torch.zeros_like(p) for p in self._sorted_params()[1]]

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
        n, n_pad, lo, hi = self._flat_layout()
        with torch.no_grad():
            flat, spec = tree_pack(params, torch.float32)
            flat = torch.nn.functional.pad(flat, (0, n_pad - n))
        chunk = flat[lo:hi]
        actual._apply_to([_FLAT], [chunk], [exchanged],
                         hooks=self._chunk_hooks())
        full = self.communicator.allgather_flat(chunk)
        with torch.no_grad():
            torch._foreach_copy_(params, tree_unpack(full[:n], spec))

    def _flat_layout(self):
        """``(n, n_pad, start, stop)``: the flat vector's length, its
        padded length and this rank's chunk."""
        _, params = self._sorted_params()
        n = sum(p.numel() for p in params)
        if self._layout is None or self._layout[0] != n:
            comm = self.communicator
            n_pad = padded_length(n, comm.size)
            self.__dict__["_layout"] = (n, n_pad, *chunk_bounds(
                n_pad, comm.size, comm.rank))
        return self._layout

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
        update this is a collective: every rank serializes."""
        actual = self.actual_optimizer
        if self._sharded_update:
            actual.serialize_with(serializer, self._save_flat_state,
                                  self._load_flat_state)
        else:
            actual.serialize(serializer)
        if self._stale_exchange and actual.target is not None:
            self._serialize_stale(serializer["stale_grads"])

    def _whole(self, chunk):
        """Every rank's chunk, gathered: the whole flat vector on the
        host."""
        return self.communicator.allgather_flat(chunk).cpu().numpy()

    def _my_chunk(self, leaf):
        """This rank's chunk of a whole flat vector saved under any world
        size (cut to the parameters' length, padded to this size's)."""
        n, n_pad, lo, hi = self._flat_layout()
        leaf = np.asarray(leaf, np.float32).reshape(-1)
        if leaf.shape[0] < n:
            raise ValueError(f"flat vector of {leaf.shape[0]} elements "
                             f"for {n} parameters")
        full = np.zeros(n_pad, np.float32)
        full[:n] = leaf[:n]
        device = self._sorted_params()[1][0].device
        return torch.from_numpy(full[lo:hi].copy()).to(device)

    def _save_flat_state(self):
        actual = self.actual_optimizer
        st = actual._state.get(_FLAT)
        if st is None:
            return None
        leaves = [np.asarray(st["count"], np.int32)] \
            if actual._has_count else []
        return leaves + [self._whole(st[slot]) for slot in actual._slots]

    def _load_flat_state(self, leaves):
        actual = self.actual_optimizer
        want = int(actual._has_count) + len(actual._slots)
        if len(leaves) != want:
            raise ValueError(
                f"optimizer state has {len(leaves)} leaves, the flat "
                f"state of {type(actual).__name__} takes {want}")
        leaves = list(leaves)
        st = {"count": int(np.asarray(leaves.pop(0)))
              if actual._has_count else 0}
        for slot, leaf in zip(actual._slots, leaves):
            st[slot] = self._my_chunk(leaf)
        actual._state = {_FLAT: st}

    def _serialize_stale(self, sub):
        if sub.is_writer:
            if self._pending is not None:
                self.__dict__["_stale"] = self._take_stale()
            if self._stale is None:
                return
            leaves = [self._whole(self._stale)] if self._sharded_update \
                else [g.detach().cpu().numpy() for g in self._stale]
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
            stale = self._my_chunk(leaves[0])
        else:
            _, params = self._sorted_params()
            if len(leaves) != len(params):
                raise ValueError(f"stale_grads has {len(leaves)} leaves "
                                 f"for {len(params)} parameters")
            stale = [torch.from_numpy(np.array(g)).to(p.device, p.dtype)
                     .view_as(p) for g, p in zip(leaves, params)]
        self.__dict__["_stale"] = stale
