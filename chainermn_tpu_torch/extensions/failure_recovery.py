"""Fail-stop auto-recovery: the consumer of the ``on_error`` hook.

The port of ``chainermn_tpu.extensions.failure_recovery``.  Reference
contract: a crashed rank takes the whole job down (fail-stop), the
scheduler relaunches it, and the checkpointer's consensus ``maybe_load``
converges every rank on the newest snapshot present on all ranks.  Many
real faults (a failed collective, a host-channel timeout) kill no process
and can be recovered in place, without a relaunch.

:class:`FailureRecovery` is a trainer extension consumed by the
supervisor loop of ``Trainer.run``:

1. a recoverable fault escapes the training loop,
2. the trainer fires ``on_error`` on every extension,
3. this extension quiesces the transport: clears a posted abort flag and
   bumps the host channel's key generation (keys stranded by the failed
   op never match the recovered incarnation's), and waits for and drops
   any gradient exchange still in flight (a double-buffered allreduce on
   a side stream, launched the step before the fault),
4. the checkpointer's consensus ``maybe_load`` rolls every rank back, in
   place, to the newest snapshot all of them hold: parameters and the
   optimizer's state into the tensors the model and the rule already
   hold, the iterator's position, the updater's iteration, the triggers
   and the per-step rng key,
5. an optional ``rebuild`` hook replaces the communicator, and
6. the training loop resumes.

Every process must take the same decision at the same call site, which
holds when a fault is visible everywhere (a collective that fails, fails
for all) or injected from a shared seeded schedule.
"""

from __future__ import annotations

import sys
import time

from .. import observability
from ..communicators._host_channel import ChannelError, PeerLostError
from ..communicators.fault_schedule import InjectedFault
from ..training.trainer import Extension, PRIORITY_READER

__all__ = ["FailureRecovery", "RecoveryGivingUp"]

_DEFAULT_RECOVERABLE = (InjectedFault, ChannelError)
# A dead PEER cannot be recovered in place: the consensus allgather would
# block on its contribution for the full op deadline.  Prompt fail-stop
# (relaunch + consensus) is the correct outcome; deployments whose
# ``rebuild`` hook respawns peers can opt in via ``unrecoverable=()``.
_DEFAULT_UNRECOVERABLE = (PeerLostError,)


def _never_fire(trainer):
    return False


class RecoveryGivingUp(RuntimeError):
    """Raised (chaining the fault) when the recovery budget is spent.

    Carries the last known membership view (``membership`` — an
    :class:`~..communicators.MembershipView` on elastic runs, None on
    fixed-size ones) IN THE MESSAGE: a give-up is precisely the moment
    an operator reads one line of a crash log, and "who was in the
    world when we stopped trying" is the first question.  The message
    also names the view's group role: a give-up inside a serving-role
    membership group (``role="fleet"``) points the operator at the fleet
    namespace, not the training ``elastic`` one."""

    def __init__(self, message, membership=None):
        self.membership = membership
        if membership is not None:
            message = (f"{message} [last membership view: epoch "
                       f"{membership.epoch}, members "
                       f"{list(membership.members)}, group "
                       f"'{getattr(membership, 'role', 'elastic')}']")
        super().__init__(message)


class FailureRecovery(Extension):
    """Supervisor-consumed extension implementing inject → detect →
    recover → converge.

    ``checkpointer``: a ``_MultiNodeCheckpointer`` (its ``maybe_load``
    is the convergence step; optional — without one, recovery restarts
    from live in-memory state, which is only safe for idempotent loops).
    ``recoverable``: exception types worth recovering (default:
    ``InjectedFault`` + the typed channel errors).  ``unrecoverable``:
    types that always fail-stop even when ``recoverable`` matches
    (default: ``PeerLostError`` — see module docstring).
    ``max_recoveries``:
    lifetime budget; exhaustion re-raises through
    :class:`RecoveryGivingUp` so a crash-looping job still fail-stops.
    ``rebuild``: optional ``rebuild(trainer, exc) -> communicator|None``
    hook replacing the transport.  ``cooldown_s``: pause before resuming
    (real deployments back off to let the fabric settle).
    """

    # a None trigger means fire-every-iteration to Trainer.run; this
    # extension's behavior lives on the supervisor path only, so its
    # iteration trigger genuinely never fires
    trigger = staticmethod(_never_fire)
    priority = PRIORITY_READER
    name = "FailureRecovery"

    def __init__(self, checkpointer=None, comm=None, recoverable=None,
                 unrecoverable=None, max_recoveries=3, rebuild=None,
                 cooldown_s=0.0, sleep=time.sleep, on_recover=None,
                 verbose=True):
        self.checkpointer = checkpointer
        self.comm = comm if comm is not None \
            else getattr(checkpointer, "comm", None)
        self.recoverable = tuple(recoverable) if recoverable is not None \
            else _DEFAULT_RECOVERABLE
        self.unrecoverable = tuple(unrecoverable) \
            if unrecoverable is not None else _DEFAULT_UNRECOVERABLE
        self.max_recoveries = int(max_recoveries)
        self.rebuild = rebuild
        self.cooldown_s = float(cooldown_s)
        self._sleep = sleep
        self.on_recover = on_recover
        self.verbose = verbose
        self.stats = {"recoveries": 0, "resumed_iterations": [],
                      "generation_bumps": 0,
                      # elastic telemetry: world-size changes
                      # and the rank churn behind them — zero forever on
                      # fixed-size runs, filled by ElasticRecovery
                      "resizes": 0, "ranks_lost": 0, "ranks_joined": 0}
        # the last membership view this supervisor acted on (elastic
        # runs); attached to RecoveryGivingUp so a give-up names who
        # was present
        self.last_view = None

    def __call__(self, trainer):
        pass  # all behavior lives on the supervisor path

    # -- supervisor protocol -------------------------------------------------
    def can_recover(self, exc):
        """Type check only — a spent budget is reported by
        :meth:`recover` raising :class:`RecoveryGivingUp` (chaining the
        fault), so the crash output distinguishes 'never recoverable'
        from 'gave up after N recoveries'.  ``unrecoverable`` types
        (default: :class:`PeerLostError` — a dead peer can never answer
        the consensus allgather) always fail-stop."""
        return (isinstance(exc, self.recoverable)
                and not isinstance(exc, self.unrecoverable))

    def _spend_recovery_budget(self, exc):
        """Shared budget gate (fixed-size AND elastic recover paths):
        exhaustion raises :class:`RecoveryGivingUp` chaining the fault
        and naming the last membership view; otherwise one attempt is
        spent."""
        if self.stats["recoveries"] >= self.max_recoveries:
            raise RecoveryGivingUp(
                f"recovery budget exhausted "
                f"({self.stats['recoveries']}/{self.max_recoveries})",
                membership=self.last_view
                if self.last_view is not None
                else getattr(self, "view", None),
            ) from exc
        self.stats["recoveries"] += 1

    def recover(self, trainer, exc):
        """Run the recovery state machine; returns the resumed iteration
        (or None when no common snapshot existed and training restarts
        from live state)."""
        self._spend_recovery_budget(exc)
        if self.verbose:
            print(f"chainermn_tpu: recovering from {type(exc).__name__}: "
                  f"{exc} (attempt {self.stats['recoveries']}"
                  f"/{self.max_recoveries})", file=sys.stderr)
        observability.instant("recover/detect",
                              tags={"exc": type(exc).__name__})
        if self.cooldown_s:
            self._sleep(self.cooldown_s)
        with observability.span("recover/quiesce"):
            self._quiesce_transport()
            _drop_exchanges(trainer)
        resumed = None
        if self.checkpointer is not None:
            # checkpointer.maybe_load carries its own
            # "recover/consensus_load" span
            resumed = self.checkpointer.maybe_load(trainer)
        if self.rebuild is not None:
            with observability.span("recover/rebuild"):
                new_comm = self.rebuild(trainer, exc)
            if new_comm is not None:
                self.comm = new_comm
                if self.checkpointer is not None:
                    self.checkpointer.comm = new_comm
        self.stats["resumed_iterations"].append(resumed)
        self._publish_stats()
        if self.verbose:
            print(f"chainermn_tpu: consensus resume -> iteration "
                  f"{resumed if resumed is not None else '(fresh state)'}",
                  file=sys.stderr)
        if self.on_recover is not None:
            self.on_recover(trainer, exc, resumed)
        return resumed

    def _publish_stats(self):
        """Fold :attr:`stats` into the observability registry: the
        supervisor's lifetime telemetry (recoveries, generation bumps,
        the elastic resize and rank-churn counts) as gauges beside the
        other counters.  No-op when observability is off."""
        if not observability.enabled():
            return
        reg = observability.registry()
        for key in ("recoveries", "generation_bumps", "resizes",
                    "ranks_lost", "ranks_joined"):
            reg.gauge(f"chainermn_tpu_recovery_{key}",
                      help="FailureRecovery.stats['%s']" % key).set(
                self.stats[key])

    def _quiesce_transport(self):
        """Clear a posted abort flag and rotate the host channel's key
        generation, so the resumed run can never match keys stranded by
        the failed op (every process does this lock-step before the
        consensus allgather below runs over the NEW generation)."""
        comm = self.comm
        ch = None
        if comm is not None and hasattr(comm, "_host_channel"):
            try:
                ch = comm._host_channel()
            except Exception:
                ch = None
        if ch is not None:
            ch.clear_abort()
            ch.bump_generation()
            self.stats["generation_bumps"] += 1

    def serialize(self, serializer):
        pass  # recovery budget is per-process-lifetime, not snapshot state


def _drop_exchanges(trainer):
    """Wait for and drop every multi-node optimizer's gradient exchange
    in flight (a double-buffered allreduce or reduce-scatter launched the
    step before the fault, on a side stream of the card): the load below
    writes the parameters and state that exchange would otherwise be
    applied to."""
    for opt in trainer.updater.get_all_optimizers().values():
        reset = getattr(opt, "_reset_exchange", None)
        if reset is not None:
            reset()
