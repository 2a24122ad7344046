"""Global exception hook: fail-stop crash propagation.

The port of ``chainermn_tpu.global_except_hook`` (reference:
``chainermn/global_except_hook.py · _add_hook_if_enabled``): an uncaught
exception on any rank prints its traceback and ends the process with
exit code 1 at once, so the job fails loudly instead of leaving its
peers blocked in a collective.  Under ``torchrun`` the agent sees the
failed rank and stops the others; recovery is a relaunch and the
checkpointer's consensus ``maybe_load`` (:mod:`.extensions.checkpoint`).
The hook makes no teardown call that can block on NCCL (no
``destroy_process_group``): it only prints, flushes and exits.  The
host channel's ``post_abort``, which the JAX hook also calls to wake
peers waiting on the coordination store, comes with the port of
``_host_channel.py`` (ROADMAP A11).

Where it installs: the JAX package installs the hook at import when its
distributed client is already up.  No process group exists when this
package is imported, so :func:`_add_hook_if_enabled` runs at import (the
flag only) and again in ``create_communicator`` once a group of more than
one rank is up.  ``CHAINERMN_TPU_FORCE_ABORT_ON_EXCEPTION=1`` installs it
anyway, ``=0`` never.
"""

from __future__ import annotations

import os
import sys
import traceback

__all__ = ["add_hook", "_add_hook_if_enabled"]

_hook_installed = False


def _rank():
    """This process's rank in the default process group, -1 without
    one."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:  # noqa: BLE001 (the abort path must not raise)
        pass
    return -1


def add_hook():
    """Install the except hook (idempotent).

    Any previously installed excepthook (a test harness's capture hook,
    a logging framework's reporter) runs first, and stderr and stdout
    are flushed before the hard exit, so the traceback is never lost in
    a buffered pipe when ``os._exit`` skips the interpreter's flush.  A
    ``KeyboardInterrupt`` is reported and does not exit."""
    global _hook_installed
    if _hook_installed:
        return
    _hook_installed = True
    original = sys.excepthook

    def _hook(exc_type, exc_value, exc_traceback):
        rank = _rank()
        sys.stderr.write(
            f"chainermn_tpu_torch: uncaught exception on rank {rank} -- "
            f"aborting the distributed job (fail-stop)\n")
        traceback.print_exception(exc_type, exc_value, exc_traceback)
        sys.stderr.flush()
        # the hook installed before ours runs too (the interpreter's
        # default is skipped: the traceback is already printed); its
        # failure, SystemExit included, must not stop the abort
        if original is not None and original is not _hook \
                and original is not sys.__excepthook__:
            try:
                original(exc_type, exc_value, exc_traceback)
            except BaseException:  # noqa: BLE001
                pass
        if exc_type is KeyboardInterrupt:
            return
        try:
            sys.stderr.flush()
            sys.stdout.flush()
        except Exception:  # noqa: BLE001
            pass
        os._exit(1)

    sys.excepthook = _hook


def _add_hook_if_enabled():
    """Install the hook when the flag asks for it, or, without the flag,
    when a process group of more than one rank is up."""
    flag = os.environ.get("CHAINERMN_TPU_FORCE_ABORT_ON_EXCEPTION")
    if flag == "0":
        return
    if flag == "1":
        add_hook()
        return
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        add_hook()
