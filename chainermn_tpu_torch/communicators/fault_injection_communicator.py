"""Fault-injection communicator: deterministic chaos at the API surface.

The port of ``chainermn_tpu.communicators.fault_injection_communicator``.
It wraps any communicator and consults a
:class:`~.fault_schedule.FaultSchedule` before every named operation, so a
test (or a chaos run) can make the Nth ``allreduce`` raise, the 3rd
``send_obj`` vanish, or every ``bcast_obj`` straggle, without a real
multi-host failure.  Beyond the JAX package's vocabulary (the
``CommunicatorBase`` calls), the port's own gradient-exchange entry
points are intercepted too: ``allreduce_grad_async``,
``reduce_scatter_grad`` and ``allgather_flat``, which the multi-node
optimizer calls eagerly where the JAX package compiles the exchange into
its step.

Every process builds the same schedule (same specs, same seed), and the
lock-step call order makes all processes hit an injected collective fault
at the same call site, which is what a real collective failure looks like
from the trainer: everyone raises, everyone recovers through the
checkpointer's consensus resume.

Host-side transport faults (lost chunk, stale key, timeout) are injected
one level lower through :func:`bind_host_channel`, which installs a
schedule-driven hook at ``HostChannel``'s put/get/barrier hook points.
The JAX package's object calls always ride that channel; the port's
:class:`~.mesh_communicator.MeshCommunicator` sends its objects over the
process group, so the wrapper sends them over the wrapped communicator's
host channel (``_host_channel()``) when it has one: the transport faults
then act on the same calls as in the JAX package, and a peer that is gone
surfaces as a typed channel error.
"""

from __future__ import annotations

import time

from .communicator_base import CommunicatorBase
from .fault_schedule import FaultSchedule

__all__ = ["FaultInjectionCommunicator", "bind_host_channel"]

# ops consulted against the schedule (everything stateful or collective
# on the CommunicatorBase vocabulary)
_INTERCEPTED = (
    "send", "recv", "bcast", "gather", "allgather", "alltoall", "scatter",
    "allreduce", "multi_node_mean",
    "send_obj", "recv_obj", "bcast_obj", "gather_obj", "allgather_obj",
    "allreduce_obj",
    "bcast_data", "multi_node_mean_grad", "allreduce_grad",
    "allreduce_grad_async", "reduce_scatter_grad", "allgather_flat",
)
# "drop" semantics by op family:
#   value-preserving collectives -> input returned unchanged (a silently
#     no-op collective);
#   sends -> message lost, returns None (the peer's matched receive then
#     exercises the timeout path);
#   everything else (scatter/gather/allgather/alltoall/recv*) has no
#     well-defined silent result -> drop degrades to raise, modeling a
#     failed collective rather than fabricating a wrong-shaped value.
_DROP_RETURNS_INPUT = {
    "bcast", "allreduce", "multi_node_mean", "bcast_obj", "allreduce_obj",
    "bcast_data",
}
_DROP_LOSES_MESSAGE = {"send", "send_obj"}
# payload parameter name per drop-returns-input op, for keyword-invoked
# calls (kwargs insertion order is NOT the signature order)
_PAYLOAD_KW = {"bcast": "data", "allreduce": "data",
               "multi_node_mean": "data", "bcast_obj": "obj",
               "allreduce_obj": "obj", "bcast_data": "model"}
# the object calls sent over the wrapped communicator's host channel, with
# the communicator's signatures (ranks are the channel's process ids)
_OVER_CHANNEL = {
    "send_obj": lambda ch, obj, dest, tag=0: ch.send_obj(obj, dest, tag),
    "recv_obj": lambda ch, source, tag=0: ch.recv_obj(source, tag),
    "bcast_obj": lambda ch, obj, root=0: ch.bcast(obj, root=root),
    "gather_obj": lambda ch, obj, root=0: ch.allgather(obj),
    "allgather_obj": lambda ch, obj: ch.allgather(obj),
}


class FaultInjectionCommunicator(CommunicatorBase):
    """Transparent communicator wrapper driven by a fault schedule.

    ``base``: the real communicator.  ``schedule``: a
    :class:`FaultSchedule` (or spec-dict accepted by
    ``FaultSchedule.from_dict``).  ``sleep``: injectable clock for tests
    (``delay`` actions call it).
    """

    def __init__(self, base, schedule, sleep=time.sleep):
        if isinstance(schedule, dict):
            schedule = FaultSchedule.from_dict(schedule)
        self.base = base
        self.schedule = schedule
        if schedule.rank is None:
            # rank-restricted specs (the elastic preempt shape) address
            # communicator ranks; bind the wrapped communicator's rank
            # so the shared schedule fires only on its target.  An
            # explicit pre-bound rank wins (tests drive several ranks'
            # schedules from one process).
            schedule.bind_rank(getattr(base, "rank", None))
        self.hc_schedule = None  # transport-layer clone (factory-bound)
        self._sleep = sleep
        self.injected = 0

    # -- interception core ---------------------------------------------------
    def _maybe_inject(self, op, first_arg=None):
        """Returns (handled, value): handled=True means the op was
        consumed by the fault (value is its replacement result)."""
        fault = self.schedule.on_call(op)
        if fault is None:
            return False, None
        if fault.action == "delay":
            self._sleep(fault.spec.delay_s)
            return False, None  # delayed, then executes normally
        self.injected += 1
        if fault.action == "drop":
            if op in _DROP_RETURNS_INPUT:
                return True, first_arg
            if op in _DROP_LOSES_MESSAGE:
                return True, None
        # raise, preempt (a typed RankPreempted — the elastic
        # supervisor's leave cue, hard fail-stop otherwise),
        # drop-without-a-well-defined-silent-result, and the
        # transport-flavored actions (lost_chunk/stale_key only have
        # meaning inside the host channel — bind_host_channel) all
        # surface as the injected exception
        raise fault.make_exception()

    # -- topology (pure delegation) -----------------------------------------
    rank = property(lambda self: self.base.rank)
    size = property(lambda self: self.base.size)
    intra_rank = property(lambda self: self.base.intra_rank)
    intra_size = property(lambda self: self.base.intra_size)
    inter_rank = property(lambda self: self.base.inter_rank)
    inter_size = property(lambda self: self.base.inter_size)

    # -- everything else delegates (calls, device, grad_buckets_for, ...) --
    def __getattr__(self, name):
        # only called for attributes not found on this class; keeps the
        # wrapper transparent for backend-specific surface (device,
        # calls, _host_channel, chunk_index, ...).  'base' itself must
        # fail plainly or a half-constructed instance recurses forever
        if name == "base":
            raise AttributeError(name)
        return getattr(self.base, name)

    def _object_channel(self):
        """The wrapped communicator's host channel, or None."""
        fn = getattr(self.base, "_host_channel", None)
        return fn() if fn is not None else None

    # base-class concrete methods shadow __getattr__, so delegate explicitly
    def split(self, color, key):
        return self.base.split(color, key)

    def finalize(self):
        # unbind OUR schedule's transport hook from the (process-global)
        # host channel, so injected faults cannot outlive this
        # communicator into supposedly fault-free later runs; another
        # owner's hook is left alone
        try:
            ch = self._object_channel()
        except Exception:
            ch = None
        tag = getattr(ch, "_fault_hook", None) and \
            getattr(ch._fault_hook, "_schedule", None)
        if tag is not None and (tag is self.schedule
                                or tag is self.hc_schedule):
            ch.set_fault_hook(None)
        return self.base.finalize()


def _make_intercepted(op):
    payload_kw = _PAYLOAD_KW.get(op)

    def method(self, *args, **kwargs):
        if args:
            first = args[0]
        else:  # keyword-invoked: resolve the payload by PARAMETER name
            first = kwargs.get(payload_kw) if payload_kw else None
        handled, value = self._maybe_inject(op, first_arg=first)
        if handled:
            return value
        ch = self._object_channel() if op in _OVER_CHANNEL else None
        if ch is not None:
            return _OVER_CHANNEL[op](ch, *args, **kwargs)
        return getattr(self.base, op)(*args, **kwargs)
    method.__name__ = op
    method.__qualname__ = f"FaultInjectionCommunicator.{op}"
    method.__doc__ = (f"Schedule-checked ``{op}`` "
                      f"(delegates to the wrapped communicator).")
    return method


for _op in _INTERCEPTED:
    setattr(FaultInjectionCommunicator, _op, _make_intercepted(_op))
del _op


def bind_host_channel(channel, schedule, sleep=time.sleep):
    """Install a schedule-driven fault hook at a HostChannel's hook points.

    The channel calls ``hook(event, ctx)`` at ``hc.put`` / ``hc.chunk`` /
    ``hc.get`` / ``hc.barrier`` sites (see ``_host_channel.HostChannel``).
    Actions:

    ``raise``      raise at the hook site (a transport error the
                   channel's bounded retry may absorb — ``hc.get`` raises
                   surface as transient failures of one attempt).
    ``delay``      straggle (drives deadline/backoff paths).
    ``lost_chunk`` after a put, delete one chunk key from the store —
                   the reader sees a torn message and must time out or
                   retry (ctx supplies the key and the client).
    ``stale_key``  corrupt the meta key so the reader sees a stale/
                   malformed entry (exercises key-cleanup paths).
    ``preempt``    raise :class:`RankPreempted` at the hook site.  The
                   channel's retry loop treats it as NON-transient (a
                   reclaimed host cannot come back within a backoff),
                   so it surfaces immediately instead of burning the
                   retry budget.
    """
    if isinstance(schedule, dict):
        schedule = FaultSchedule.from_dict(schedule)

    def hook(event, ctx):
        fault = schedule.on_call(event)
        if fault is None:
            return
        if fault.action == "delay":
            sleep(fault.spec.delay_s)
            return
        if fault.action == "raise":
            raise fault.make_exception()
        if fault.action == "lost_chunk":
            try:
                ctx["client"].key_value_delete(ctx["key"] + "/c0")
            except Exception:
                pass
            return
        if fault.action == "stale_key":
            try:
                ctx["client"].key_value_set(ctx["key"] + "/meta", "stale:0")
            except Exception:
                pass
            return
        raise fault.make_exception()

    hook._schedule = schedule  # ownership tag: lets the schedule's
    # communicator wrapper unbind exactly this hook in finalize()
    channel.set_fault_hook(hook)
    return schedule
