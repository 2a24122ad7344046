"""Declarative, seeded fault schedules: the injection layer's oracle.

The port of ``chainermn_tpu.communicators.fault_schedule``, a host-only
module copied over (the port imports nothing of the JAX package).  A
:class:`FaultSchedule` is consulted once per named operation call: given
the op name it answers "nothing", or one of the fault actions below.  Two
schedules built from the same specs and seed, driven through the same
sequence of op calls, fire at exactly the same call sites (the replay
property the tests hold against the JAX schedule).

Fault actions
-------------
``raise``  raise :class:`InjectedFault` (default) or a caller-supplied
           exception type: a crashed collective or transport error.
``drop``   skip the operation.  For sends this loses the message (the
           peer's matched receive then exercises the timeout path); for
           value-preserving collectives (bcast/allreduce flavors) the
           wrapper returns the input unchanged; ops with no well-defined
           silent result (scatter/gather/recv...) degrade to ``raise``.
``delay``  sleep ``delay_s`` before executing: stragglers, and the
           deadline/backoff paths without a real slow host.
``preempt`` raise :class:`RankPreempted`: the rank's capacity was
           reclaimed at this call.  Unhandled, it fail-stops the process
           like any crash; under :class:`~..extensions.ElasticRecovery`
           the rank announces ``leave`` and the survivors shrink.

Spec matching
-------------
A spec names an ``op`` (exact name, or ``"*"``) and fires either on the
``nth`` call of that op (1-based, counted per schedule instance) or with
probability ``prob`` drawn from the schedule's seeded RNG: one shared
stream, consumed in op-call order, so probabilistic schedules replay
deterministically too.  ``count`` bounds how many times a spec fires
(default 1; ``None`` = unbounded).  ``rank`` restricts a spec to ONE rank
of a shared schedule (every process builds the same schedule, only the
targeted rank is preempted); the filter applies after the draw, so every
rank consumes the same stream positions.  ``step`` restricts a spec to a
named protocol step (``on_call(op, step=...)``), filtered after the draw
as well.

Host-channel ops are named ``hc.<op>`` (``hc.put``, ``hc.get``,
``hc.barrier``, ``hc.chunk``) and carry transport actions (``lost_chunk``,
``stale_key``) interpreted by the host channel's fault hook
(``fault_injection_communicator.bind_host_channel``).
"""

from __future__ import annotations

import json
import os
import random

__all__ = ["InjectedFault", "RankPreempted", "FaultSpec", "FaultSchedule",
           "schedule_from_env"]

_ACTIONS = ("raise", "drop", "delay", "lost_chunk", "stale_key", "preempt")


class InjectedFault(RuntimeError):
    """A deliberately injected fault (carries the op and call index)."""

    def __init__(self, op, call_index, note=""):
        self.op = op
        self.call_index = call_index
        super().__init__(
            f"injected fault at {op!r} call #{call_index}"
            + (f" ({note})" if note else ""))


class RankPreempted(RuntimeError):
    """This rank's capacity was reclaimed (the ``preempt`` action).

    Deliberately NOT an :class:`InjectedFault` subclass: the fixed-size
    :class:`~..extensions.FailureRecovery` must fail-stop on it (an
    in-place retry cannot bring back a reclaimed host), while
    :class:`~..extensions.ElasticRecovery` treats it as this rank's cue
    to leave the membership.  Carries the op, call index, and the
    targeted rank (``None`` when the spec was rank-unrestricted)."""

    def __init__(self, op, call_index, rank=None, note=""):
        self.op = op
        self.call_index = call_index
        self.rank = rank
        super().__init__(
            f"rank{'' if rank is None else f' {rank}'} preempted at "
            f"{op!r} call #{call_index}"
            + (f" ({note})" if note else ""))


class FaultSpec:
    """One declarative fault: *when* (op + nth/prob) and *what* (action)."""

    def __init__(self, op, action="raise", nth=None, prob=None,
                 delay_s=0.0, exc=None, count=1, note="", rank=None,
                 step=None):
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r}; "
                             f"choose from {_ACTIONS}")
        if (nth is None) == (prob is None):
            raise ValueError("exactly one of nth=/prob= must be given")
        if nth is not None and nth < 1:
            raise ValueError("nth is 1-based (first call is nth=1)")
        if rank is not None and int(rank) < 0:
            raise ValueError(f"rank must be a non-negative rank id, "
                             f"got {rank}")
        if step is not None and (not isinstance(step, str) or not step):
            raise ValueError(f"step must be a non-empty protocol-step "
                             f"name, got {step!r}")
        self.op = op
        self.action = action
        self.nth = nth
        self.prob = prob
        self.delay_s = float(delay_s)
        self.exc = exc
        self.count = count  # None = unbounded
        self.note = note
        self.rank = None if rank is None else int(rank)
        self.step = step
        self.fired = 0

    def to_dict(self):
        d = {"op": self.op, "action": self.action}
        if self.nth is not None:
            d["nth"] = self.nth
        if self.prob is not None:
            d["prob"] = self.prob
        if self.delay_s:
            d["delay_s"] = self.delay_s
        if self.count != 1:
            d["count"] = self.count
        if self.note:
            d["note"] = self.note
        if self.rank is not None:
            d["rank"] = self.rank
        if self.step is not None:
            d["step"] = self.step
        return d

    def __repr__(self):
        return f"FaultSpec({self.to_dict()!r})"


class _Fault:
    """A resolved injection decision handed back to the interception site."""

    def __init__(self, spec, op, call_index):
        self.spec = spec
        self.action = spec.action
        self.op = op
        self.call_index = call_index

    def make_exception(self):
        if self.action == "preempt":
            # the preempt action owns its exception type: a caller-
            # supplied exc= would hide the RankPreempted contract the
            # elastic supervisor dispatches on
            return RankPreempted(self.op, self.call_index,
                                 rank=self.spec.rank, note=self.spec.note)
        if self.spec.exc is not None:
            return self.spec.exc(
                f"injected fault at {self.op!r} call #{self.call_index}")
        return InjectedFault(self.op, self.call_index, self.spec.note)


class FaultSchedule:
    """Seeded oracle: ``on_call(op)`` → :class:`_Fault` or ``None``.

    Deterministic by construction: per-op call counters plus one seeded
    RNG stream consumed in call order.  ``fired`` records every injection
    as ``(op, call_index, action)`` — the replay log the determinism
    tests compare.
    """

    def __init__(self, specs=(), seed=0, rank=None):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                      for s in specs]
        self._counters = {}
        self.fired = []
        # the rank this schedule instance is driving (bound by the
        # fault-injection communicator at wrap time; settable up front
        # for host-channel-only schedules).  None = unbound: rank-
        # restricted specs never fire, rank-free specs always can.
        self.rank = None if rank is None else int(rank)

    def bind_rank(self, rank):
        """Bind the schedule to the rank it is driving — rank-restricted
        specs (``FaultSpec(rank=k)``) only fire on the bound rank.  The
        RNG stream is unaffected (rank filtering happens after the
        draw), so bound and unbound instances of the same schedule stay
        call-site-aligned."""
        self.rank = None if rank is None else int(rank)
        return self

    # -- construction --------------------------------------------------------
    @classmethod
    def from_dict(cls, d):
        """``{"seed": int, "faults": [spec-dict, ...]}``."""
        return cls(specs=d.get("faults", ()), seed=d.get("seed", 0))

    @classmethod
    def from_json(cls, text):
        return cls.from_dict(json.loads(text))

    def to_dict(self):
        return {"seed": self.seed,
                "faults": [s.to_dict() for s in self.specs]}

    # -- the oracle ----------------------------------------------------------
    def on_call(self, op, step=None):
        """Consult the schedule for one call of ``op``.

        Increments the op's call counter, then returns the first matching
        armed spec's decision (or None).  The RNG stream is advanced for
        every probabilistic spec naming this op — match or not — so the
        draw sequence depends only on the op-call sequence.  ``step``
        names the protocol step the caller is executing (capacity
        conversion sites pass it); step-restricted specs only fire when
        the names agree.
        """
        n = self._counters.get(op, 0) + 1
        self._counters[op] = n
        hit = None
        for spec in self.specs:
            if spec.op != "*" and spec.op != op:
                continue
            if spec.count is not None and spec.fired >= spec.count:
                # exhausted probabilistic specs must still consume their
                # draw, or exhaustion would shift later specs' sites
                if spec.prob is not None:
                    self._rng.random()
                continue
            if spec.nth is not None:
                matched = (n == spec.nth)
            else:
                matched = (self._rng.random() < spec.prob)
            if matched and spec.rank is not None \
                    and spec.rank != self.rank:
                # targeted at another rank (or unbound schedule): the
                # draw above is already consumed, so every rank's
                # stream stays aligned — the spec just doesn't fire here
                matched = False
            if matched and spec.step is not None and spec.step != step:
                # step filtering mirrors rank filtering: post-draw, so
                # ranks at different protocol steps stay stream-aligned
                matched = False
            if matched and hit is None:
                spec.fired += 1
                hit = _Fault(spec, op, n)
        if hit is not None:
            self.fired.append((hit.op, hit.call_index, hit.action))
        return hit

    def calls(self, op):
        """How many times ``op`` has been consulted."""
        return self._counters.get(op, 0)

    def reset(self):
        """Re-arm: counters, RNG stream, and spec budgets back to t=0."""
        self._rng = random.Random(self.seed)
        self._counters = {}
        self.fired = []
        for spec in self.specs:
            spec.fired = 0

    def __repr__(self):
        return (f"<FaultSchedule seed={self.seed} specs={len(self.specs)} "
                f"fired={len(self.fired)}>")


def schedule_from_env(env="CHAINERMN_TPU_FAULT_SCHEDULE"):
    """Build a schedule from a JSON env var (CI/chaos entry point).

    The value is either inline JSON or an ``@/path/to/file.json``
    reference.  Returns None when unset — injection stays zero-cost for
    normal runs.
    """
    raw = os.environ.get(env)
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    return FaultSchedule.from_json(raw)
