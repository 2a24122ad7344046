"""Optimizers (consumed-Chainer surface: ``chainer.Optimizer`` + optimizers).

The port of ``chainermn_tpu.core.optimizer``.  The lifecycle vocabulary
stays: ``setup(link)``, ``update(lossfun, *args)`` (clear the gradients,
forward, backward, then the rule), ``update()`` from the gradients already
on ``Parameter.grad``, ``add_hook`` / ``remove_hook``, ``new_epoch``, ``t``,
``epoch``, ``serialize``.

Each rule reproduces the optax transform its JAX class builds, followed by
the JAX ``apply_transform_update``: hooks transform the gradients in
registration order, the rule turns them into ``u``, and every parameter
moves by ``-lr * u - weight_decay_rate * p`` (the decoupled decay is not
scaled by lr).  The rules are plain tensor code on the parameters'
device, in place, under ``torch.no_grad``.  ``torch.optim`` is not used:
its AdamW scales the decay by lr.

State is per parameter (``count`` and the rule's moment slots, e.g. Adam's
``mu`` / ``nu``).  :meth:`Optimizer.state_leaves` lays it out as the flat
leaf list of the JAX optimizer's optax state (count first, then each slot
over the parameters in sorted path order), which is what its ``serialize``
writes as ``opt_state_<i>``, so state crosses between the packages
(``serializers.load_optimizer_state``).

What the JAX optimizer needs for ``jit`` has no counterpart here: buffer
donation, the compiled-step cache, ahead-of-time memory analysis.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch.nn.parameter import is_lazy

from . import rng

__all__ = ["Optimizer", "GradientMethod", "SGD", "MomentumSGD", "Adam",
           "AdamW", "RMSprop", "AdaGrad", "AdaDelta", "NesterovAG",
           "WeightDecay", "GradientClipping", "GradientHardClipping",
           "Lasso", "GradientScaling"]


# ---------------------------------------------------------------------------
# Hooks: gradient transforms chained ahead of the rule
# ---------------------------------------------------------------------------

class _Hook:
    """``hook(params, grads) -> grads`` over lists of tensors.

    Under ``zero_sharding`` (and ``exchange="reduce_scatter"``) a hook
    sees only this rank's chunk of the flat parameter and gradient
    vectors.  An elementwise hook declares ``chunk_local = True`` and
    runs on the chunk unchanged; a hook that needs statistics of the
    whole gradient provides ``sharded(communicator)``, the hook to run
    on a chunk instead (``GradientClipping``); any other hook is refused
    there (``ValueError``)."""

    name = "Hook"
    timing = "pre"
    chunk_local = False


class WeightDecay(_Hook):
    """L2 decay added to gradients (``optax.add_decayed_weights``)."""

    name = "WeightDecay"
    chunk_local = True

    def __init__(self, rate):
        self.rate = rate

    def __call__(self, params, grads):
        return [g + self.rate * p for p, g in zip(params, grads)]


class Lasso(_Hook):
    name = "Lasso"
    chunk_local = True

    def __init__(self, rate):
        self.rate = rate

    def __call__(self, params, grads):
        return [g + self.rate * torch.sign(p) for p, g in zip(params, grads)]


class GradientClipping(_Hook):
    """Clip by global L2 norm (``optax.clip_by_global_norm``)."""

    name = "GradientClipping"

    def __init__(self, threshold):
        self.threshold = threshold

    def __call__(self, params, grads):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        # on the device, no sync: below the threshold the gradients pass
        keep = norm < self.threshold
        return [torch.where(keep, g, (g / norm) * self.threshold)
                for g in grads]

    def sharded(self, communicator):
        """The hook on one rank's chunk of the flat gradient: the global
        norm is the square root of the allreduced sum of each chunk's
        squares (the padding is zero), and the gradients are scaled by
        ``min(1, threshold / max(norm, 1e-16))``, as the JAX package's
        ``to_optax_sharded``."""
        threshold = self.threshold

        def clip(params, grads):
            sq = sum(torch.sum(g * g) for g in grads)
            norm = torch.sqrt(communicator.allreduce(sq.reshape(1))[0])
            scale = torch.clamp(threshold / torch.clamp(norm, min=1e-16),
                                max=1.0)
            return [g * scale for g in grads]

        return clip


class GradientHardClipping(_Hook):
    name = "GradientHardClipping"
    chunk_local = True

    def __init__(self, lower_bound, upper_bound):
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound

    def __call__(self, params, grads):
        return [g.clamp(self.lower_bound, self.upper_bound) for g in grads]


class GradientScaling(_Hook):
    name = "GradientScaling"
    chunk_local = True

    def __init__(self, rate):
        self.rate = rate

    def __call__(self, params, grads):
        return [g * self.rate for g in grads]


# ---------------------------------------------------------------------------
# Optimizer base
# ---------------------------------------------------------------------------

def _bias_correction(decay, count):
    """``1 - decay ** count`` in fp32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """Base optimizer with the reference's lifecycle vocabulary.

    ``setup(link)`` binds a target; ``update(lossfun, *args)`` runs one
    step: clear the gradients, ``lossfun(*args)`` forward, backward, then
    the rule; ``update()`` (no args) applies the rule to the gradients
    already on ``Parameter.grad``."""

    #: the rule's state slots per parameter, in the order of the fields
    #: of its optax state (after ``count`` when ``_has_count``)
    _slots = ()
    _has_count = False

    def __init__(self):
        self.target = None
        self.t = 0
        self.epoch = 0
        self._hooks = OrderedDict()
        self._state = {}
        # the per-step key (``core.rng``, the JAX optimizer's layout):
        # seeded from ``self.seed`` when set, split every step, saved
        # and loaded as ``rng_key``
        self._rng_key = None

    # -- lifecycle ---------------------------------------------------------
    def setup(self, link):
        self.target = link
        self._state = {}
        return self

    def add_hook(self, hook, name=None, timing="pre"):
        if self.target is None:
            raise RuntimeError("call setup() before add_hook()")
        self._hooks[name or hook.name] = hook
        self._state = {}   # a new chain starts from fresh state, as in JAX

    def remove_hook(self, name):
        del self._hooks[name]
        self._state = {}

    def new_epoch(self):
        self.epoch += 1

    def update(self, lossfun=None, *args, **kwargs):
        if self.target is None:
            raise RuntimeError("Optimizer.setup(link) was not called")
        if lossfun is None:
            self._apply()
            return None
        self.target.cleargrads()
        with self.step_key_scope():
            loss = lossfun(*args, **kwargs)
        if isinstance(loss, tuple):
            loss = loss[0]
        loss.backward()
        self._apply()
        return loss

    def _next_rng_key(self):
        """This step's key: the stored key is split, the subkey returned
        (the JAX optimizer's ``_next_rng_key``).  The first key comes
        from ``self.seed`` when set, else from numpy's global RNG."""
        if self._rng_key is None:
            seed = getattr(self, "seed", None)
            if seed is None:
                seed = np.random.randint(0, 2**31 - 1)
            self._rng_key = rng.make_key(seed)
        self._rng_key, sub = rng.split(self._rng_key)
        return sub

    def step_key_scope(self, *fold):
        """The scope of one step's stochastic draws: this step's key with
        each of ``fold`` (a rank, a step index) folded in, its generator
        on the target's device."""
        key = self._next_rng_key()
        for data in fold:
            key = rng.fold_in(key, data)
        device = next(self.target.parameters()).device
        return rng.key_scope(key, device)

    # -- the rule ----------------------------------------------------------
    def _slot_state(self, path, p):
        st = self._state.get(path)
        if st is None:
            st = {name: torch.zeros_like(p) for name in self._slots}
            st["count"] = 0
            self._state[path] = st
        return st

    def _rule(self, params, grads, states):
        """Subclass: the update directions ``u`` (before ``-lr``)."""
        raise NotImplementedError

    def _apply(self):
        named = [(path, p) for path, p in self.target.namedparams()
                 if p.grad is not None]
        if not named:
            return
        self._apply_to([path for path, _ in named], [p for _, p in named],
                       [p.grad for _, p in named])

    def _apply_to(self, paths, params, grads, hooks=None):
        """Hooks (``hooks``, else the registered ones), the rule and the
        move, in place on ``params`` with the state kept under
        ``paths``."""
        with torch.no_grad():
            for hook in (self._hooks.values() if hooks is None else hooks):
                grads = hook(params, grads)
            states = [self._slot_state(path, p)
                      for path, p in zip(paths, params)]
            for st in states:
                st["count"] += 1
            upd = torch._foreach_mul(self._rule(params, grads, states),
                                     -float(self.lr))
            wd = float(getattr(self, "weight_decay_rate", 0.0) or 0.0)
            if wd:
                torch._foreach_sub_(upd, torch._foreach_mul(params, wd))
            torch._foreach_add_(params, upd)
        self.t += 1

    # -- state in the JAX optimizer's layout -------------------------------
    def _sorted_params(self):
        """``(path, parameter)`` in sorted path order, lazy parameters
        not yet created left out (the JAX params tree lacks them)."""
        return sorted(((p, v) for p, v in self.target.namedparams()
                       if not is_lazy(v)), key=lambda kv: kv[0])

    def state_leaves(self):
        """The state as the JAX optimizer's flat optax leaves (host
        arrays): ``count`` (int32) when the rule has one, then each slot
        over the parameters in sorted path order; a parameter that has had
        no update holds zeros."""
        named = self._sorted_params()
        leaves = []
        if self._has_count:
            counts = {self._state[p]["count"] for p, _ in named
                      if p in self._state}
            if len(counts) > 1:
                raise ValueError(f"parameters were updated different "
                                 f"numbers of times ({sorted(counts)}); "
                                 "the JAX layout holds one count")
            leaves.append(np.asarray(counts.pop() if counts else 0,
                                     np.int32))
        for slot in self._slots:
            for path, p in named:
                st = self._state.get(path)
                leaves.append(np.zeros(tuple(p.shape), np.float32)
                              if st is None
                              else st[slot].detach().cpu().numpy())
        return leaves

    def load_state_leaves(self, leaves):
        """Set the state from the JAX optimizer's flat optax leaves;
        refuses a tree of another length or leaf shape (another optimizer
        or model)."""
        named = self._sorted_params()
        want = int(self._has_count) + len(self._slots) * len(named)
        if len(leaves) != want:
            raise ValueError(
                f"optimizer state has {len(leaves)} leaves, "
                f"{type(self).__name__} over {len(named)} parameters "
                f"takes {want}")
        leaves = [np.asarray(x) for x in leaves]
        count = 0
        if self._has_count:
            if leaves[0].shape != ():
                raise ValueError(f"leaf 0 (count) has shape "
                                 f"{leaves[0].shape}, expected ()")
            count = int(leaves.pop(0))
        state = {path: {"count": count} for path, _ in named}
        for i, slot in enumerate(self._slots):
            for j, (path, p) in enumerate(named):
                leaf = leaves[i * len(named) + j]
                if leaf.shape != tuple(p.shape):
                    raise ValueError(
                        f"{slot} of {path}: leaf shape {leaf.shape} does "
                        f"not match the parameter's {tuple(p.shape)}")
                state[path][slot] = torch.from_numpy(
                    np.array(leaf, np.float32)).to(p.device)
        self._state = state

    def serialize(self, serializer):
        """Chainer serializer protocol, in the JAX optimizer's keys:
        ``target/...``, ``t``, ``epoch``, ``rng_key`` (once a step or a
        snapshot set it), ``opt_state_len`` and ``opt_state_<i>``."""
        self.serialize_with(
            serializer,
            lambda: self.state_leaves() if self._state else None,
            self.load_state_leaves)

    def serialize_with(self, serializer, save_leaves, load_leaves):
        """:meth:`serialize` with the state's leaves written from
        ``save_leaves()`` (``None``: no state yet) and read into
        ``load_leaves(leaves)``: the multi-node wrapper passes its flat
        layout here."""
        if self.target is not None:
            self.target.serialize(serializer["target"])
        self.t = int(serializer("t", self.t))
        self.epoch = int(serializer("epoch", self.epoch))
        if serializer.is_writer:
            if self._rng_key is not None:
                serializer("rng_key", self._rng_key)
            leaves = save_leaves()
            if leaves is not None:
                serializer("opt_state_len", len(leaves))
                for i, leaf in enumerate(leaves):
                    serializer(f"opt_state_{i}", leaf)
            return
        try:
            key = serializer("rng_key", None)
        except KeyError:  # written by the port before any load
            key = None
        if key is not None and np.asarray(key).size:
            self._rng_key = np.asarray(key, np.uint32)
        try:
            n = serializer("opt_state_len", None)
        except KeyError:  # saved before the first update
            n = None
        if n is not None and self.target is not None:
            load_leaves([serializer(f"opt_state_{i}", None)
                         for i in range(int(n))])


class GradientMethod(Optimizer):
    """Alias tier matching the reference hierarchy."""


# ---------------------------------------------------------------------------
# Concrete optimizers (each the optax transform of its JAX class)
# ---------------------------------------------------------------------------

class SGD(GradientMethod):
    """``optax.identity``."""

    def __init__(self, lr=0.01):
        super().__init__()
        self.lr = lr

    def _rule(self, params, grads, states):
        return list(grads)


class MomentumSGD(GradientMethod):
    """``optax.trace(decay=momentum)``: ``trace = g + m * trace``."""

    _slots = ("trace",)

    def __init__(self, lr=0.01, momentum=0.9):
        super().__init__()
        self.lr = lr
        self.momentum = momentum

    def _rule(self, params, grads, states):
        trace = [st["trace"] for st in states]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        return trace


class NesterovAG(MomentumSGD):
    """``optax.trace(decay=momentum, nesterov=True)``:
    ``u = g + m * trace`` with the updated trace."""

    def _rule(self, params, grads, states):
        trace = super()._rule(params, grads, states)
        return torch._foreach_add(torch._foreach_mul(trace, self.momentum),
                                  grads)


class Adam(GradientMethod):
    """Adam, ``optax.scale_by_adam`` (or ``scale_by_amsgrad``): bias-
    corrected ``m_hat / (sqrt(v_hat) + eps)``, eps outside the root.

    ``alpha`` is the step size (``lr`` is its alias: optax already bias-
    corrects); ``weight_decay_rate`` is decoupled decay, not scaled by
    alpha."""

    _slots = ("mu", "nu")
    _has_count = True

    def __init__(self, alpha=0.001, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay_rate=0.0, amsgrad=False):
        super().__init__()
        self.alpha = alpha
        self.beta1 = beta1
        self.beta2 = beta2
        self.eps = eps
        self.weight_decay_rate = weight_decay_rate
        self.amsgrad = amsgrad
        if amsgrad:
            self._slots = ("mu", "nu", "nu_max")

    @property
    def lr(self):
        return self.alpha

    @lr.setter
    def lr(self, value):
        self.alpha = value

    def _rule(self, params, grads, states):
        b1, b2 = self.beta1, self.beta2
        mu = [st["mu"] for st in states]
        nu = [st["nu"] for st in states]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        counts = [st["count"] for st in states]
        mu_hat = torch._foreach_div(
            mu, [_bias_correction(b1, c) for c in counts])
        nu_hat = torch._foreach_div(
            nu, [_bias_correction(b2, c) for c in counts])
        if self.amsgrad:
            nu_max = [st["nu_max"] for st in states]
            torch._foreach_maximum_(nu_max, nu_hat)
            nu_hat = nu_max
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        return torch._foreach_div(mu_hat, denom)


class AdamW(Adam):
    def __init__(self, alpha=0.001, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay_rate=0.01):
        super().__init__(alpha, beta1, beta2, eps, weight_decay_rate)


class RMSprop(GradientMethod):
    """``optax.scale_by_rms(decay=alpha, eps)``: ``g / sqrt(nu + eps)``."""

    _slots = ("nu",)

    def __init__(self, lr=0.01, alpha=0.99, eps=1e-8):
        super().__init__()
        self.lr = lr
        self.alpha = alpha
        self.eps = eps

    def _rule(self, params, grads, states):
        out = []
        for g, st in zip(grads, states):
            nu = st["nu"]
            nu.mul_(self.alpha).add_((1 - self.alpha) * (g * g))
            out.append(torch.rsqrt(nu + self.eps) * g)
        return out


class AdaGrad(GradientMethod):
    """``optax.scale_by_rss(0, eps)``: ``g / sqrt(sum g^2 + eps)``, 0
    where the sum is 0."""

    _slots = ("sum_of_squares",)

    def __init__(self, lr=0.001, eps=1e-8):
        super().__init__()
        self.lr = lr
        self.eps = eps

    def _rule(self, params, grads, states):
        out = []
        for g, st in zip(grads, states):
            acc = st["sum_of_squares"]
            acc.add_(g * g)
            inv = torch.where(acc > 0, torch.rsqrt(acc + self.eps),
                              torch.zeros_like(acc))
            out.append(inv * g)
        return out


class AdaDelta(GradientMethod):
    """``optax.scale_by_adadelta(rho, eps)``; no learning rate (1)."""

    _slots = ("e_g", "e_x")

    def __init__(self, rho=0.95, eps=1e-6):
        super().__init__()
        self.lr = 1.0
        self.rho = rho
        self.eps = eps

    def _rule(self, params, grads, states):
        rho, eps = self.rho, self.eps
        out = []
        for g, st in zip(grads, states):
            e_g, e_x = st["e_g"], st["e_x"]
            e_g.mul_(rho).add_((1 - rho) * (g * g))
            u = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
            e_x.mul_(rho).add_((1 - rho) * (u * u))
            out.append(u)
        return out
