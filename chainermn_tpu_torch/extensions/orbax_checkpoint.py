"""Per-rank checkpointing on ``torch.distributed.checkpoint`` (DCP).

The port of ``chainermn_tpu.extensions.orbax_checkpoint``.  The JAX
module writes device-sharded pytrees with Orbax, which is JAX-only; this
one keeps its module path and names (:class:`OrbaxCheckpointer`,
:func:`create_multi_node_orbax_checkpointer`,
:class:`_MultiNodeOrbaxCheckpointer`) and stores with DCP instead:
``dcp.save`` / ``dcp.load`` in a single process (``no_dist=True``), one
directory per step.  The storage is DCP's format, not Orbax's: a JAX
Orbax checkpoint does not load here, nor one of these in JAX (the npz
checkpointer, :mod:`.checkpoint`, is the path that crosses packages).

:class:`OrbaxCheckpointer` saves a pytree (nested dicts of tensors, host
arrays and numbers) as ``<directory>/<step>``: written to a tmp directory
beside it, then renamed into place, so a step is either whole or absent;
``max_to_keep`` keeps the newest steps.  Tensors are stored as tensors
(DCP's byte-range files); anything else is pickled by DCP.  A restore
with a ``template`` loads in place into the template's tensors (on their
device); without one it rebuilds the tree from the step's metadata (host
arrays, flat keys).

:class:`_MultiNodeOrbaxCheckpointer` is the trainer-extension face with
the npz checkpointer's contract: trigger-driven snapshots of the trainer
through the serializer protocol, each rank into its own
``<directory>/rank<k>/`` (``k`` the communicator's ``stable_rank``, else
its ``rank``: one process per device), the newest ``cp_interval``
generations kept, and ``maybe_load`` resuming every rank from the newest
step present on all of them, that step pinned against GC.  Under the
multi-node optimizer's sharded update each rank saves its own chunk of the
flat optimizer state (``_MultiNodeOptimizer``'s per-rank mode), never the
gathered vector, so a save is no collective; such a snapshot resumes only
at the world size and chunk layout that wrote it (``ValueError``
otherwise).
"""

from __future__ import annotations

import contextlib
import os
import re
import shutil
import tempfile
import warnings

import numpy as np
import torch

from .. import observability
from ..core.link import _copy_array
from ..optimizers import _MultiNodeOptimizer
from ..serializers.npz import DictionarySerializer, NpzDeserializer
from ..training.trainer import Extension
from .checkpoint import file_rank

__all__ = ["OrbaxCheckpointer", "create_multi_node_orbax_checkpointer",
           "_MultiNodeOrbaxCheckpointer"]

_STEP = re.compile(r"^\d+$")


def _dcp():
    import torch.distributed.checkpoint as dcp
    return dcp


@contextlib.contextmanager
def _quiet():
    # DCP warns that it assumes a single process when no group is up;
    # ``no_dist=True`` asks for exactly that
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*single process.*")
        yield


def _to_state_dict(tree):
    """``tree`` with host arrays of one or more axes as tensors (DCP
    stores tensors by byte range and pickles anything else); a 0-d array
    (DCP would give it back with one axis) and an array torch has no
    dtype for stay arrays."""
    if isinstance(tree, dict):
        return {k: _to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.ndim:
        try:
            return torch.from_numpy(np.ascontiguousarray(tree))
        except TypeError:
            return tree
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


def _template(path):
    """An empty flat state dict of the step at ``path``, from its
    metadata: a host tensor per stored tensor, ``None`` per pickled
    value (DCP fills both)."""
    from torch.distributed.checkpoint import FileSystemReader
    meta = FileSystemReader(path).read_metadata().state_dict_metadata
    return {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
            if hasattr(m, "size") else None for k, m in meta.items()}


class OrbaxCheckpointer:
    """Step-numbered DCP snapshots of pytrees under ``directory``."""

    def __init__(self, directory, max_to_keep=3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step):
        return os.path.join(self.directory, str(int(step)))

    def delete(self, step):
        shutil.rmtree(self._step_dir(step))

    # -- raw pytrees -------------------------------------------------------
    def save(self, step, pytree):
        """Write ``pytree`` as step ``step`` (replacing an older write of
        that step): to a tmp directory, then renamed into place."""
        tmp = tempfile.mkdtemp(prefix=f".tmp-{int(step)}-",
                               dir=self.directory)
        try:
            with _quiet():
                _dcp().save(_to_state_dict(pytree), checkpoint_id=tmp,
                            no_dist=True)
            final = self._step_dir(step)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                self.delete(old)

    def restore(self, step=None, template=None):
        """Step ``step`` (the newest when ``None``; ``None`` when there is
        none): loaded in place into ``template``'s tensors and returned
        as ``template``, or without one as a flat ``{key: value}`` map of
        host arrays."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = self._step_dir(step)
        state = _template(path) if template is None else template
        with _quiet():
            _dcp().load(state, checkpoint_id=path, no_dist=True)
        if template is not None:
            return state
        return {k: v.numpy() if isinstance(v, torch.Tensor) else v
                for k, v in state.items()}

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if _STEP.match(d)
                      and os.path.isdir(os.path.join(self.directory, d)))

    # -- links -------------------------------------------------------------
    def save_link(self, step, link):
        """``link``'s parameters and persistent values by their JAX
        paths (``{"params": {...}, "state": {...}}``)."""
        self.save(step, _link_tree(link))

    def restore_link(self, link, step=None):
        """Load a :meth:`save_link` step into ``link`` in place; False
        when there is none."""
        tree = self.restore(step, template=_link_tree(link, copy=True))
        if tree is None:
            return False
        own = dict(link.namedparams())
        own.update(link.namedpersistent())
        for part in ("params", "state"):
            for path, value in tree[part].items():
                _copy_array(own[path], value.cpu().numpy(), path)
        return True

    def close(self):
        pass


def _link_tree(link, copy=False):
    take = (lambda t: t.detach().clone()) if copy else (lambda t: t.detach())
    return {"params": {p: take(v) for p, v in link.namedparams()},
            "state": {p: take(v) for p, v in link.namedpersistent()}}


@contextlib.contextmanager
def _per_rank_state(trainer):
    """The trainer's sharded multi-node optimizers in their per-rank
    serialization mode (each rank's own chunk, no collective) inside the
    block."""
    opts = [opt for opt in trainer.updater.get_all_optimizers().values()
            if isinstance(opt, _MultiNodeOptimizer)]
    for opt in opts:
        opt.__dict__["_local_state"] = True
    try:
        yield
    finally:
        for opt in opts:
            opt.__dict__["_local_state"] = False


def create_multi_node_orbax_checkpointer(comm, directory, cp_interval=5):
    """Reference-shaped factory (the DCP sibling of
    ``create_multi_node_checkpointer``).  ``cp_interval``: snapshot
    generations kept per rank."""
    return _MultiNodeOrbaxCheckpointer(comm, directory, cp_interval)


class _MultiNodeOrbaxCheckpointer(Extension):
    """Trigger-driven per-rank DCP snapshots with consensus resume."""

    trigger = (1, "epoch")
    priority = -100  # after everything else mutated state this iteration

    def __init__(self, comm, directory, cp_interval=5):
        self.comm = comm
        self.directory = os.path.abspath(directory)
        self.cp_interval = cp_interval
        self._ckpt = OrbaxCheckpointer(
            os.path.join(self.directory, f"rank{file_rank(comm)}"),
            max_to_keep=None)  # GC is this extension's generation policy
        self._protected_iteration = None
        self.stats = {"snapshots": 0, "gc": 0}

    @property
    def rank(self):
        return file_rank(self.comm)

    # -- save -------------------------------------------------------------
    def __call__(self, trainer):
        self.save(trainer, trainer.updater.iteration)

    def save(self, trainer, iteration):
        with observability.span("train/checkpoint_serialize",
                                tags={"iteration": int(iteration)}):
            s = DictionarySerializer()
            with _per_rank_state(trainer):
                trainer.serialize(s)
            self._ckpt.save(iteration, s.target)
            self.stats["snapshots"] += 1
            self._gc()

    def _gc(self):
        steps = self._ckpt.all_steps()
        for step in steps[:-self.cp_interval] if self.cp_interval else []:
            if step == self._protected_iteration:
                continue   # a peer may still be resuming from it
            self._ckpt.delete(step)
            self.stats["gc"] += 1

    # -- consensus resume -------------------------------------------------
    def maybe_load(self, trainer, optimizer=None):
        """Resume from the newest step *every* rank has (allgather of the
        step sets, the maximum of their intersection, this rank's own
        restore through the serializer protocol).  Returns the resumed
        iteration or None."""
        with observability.span("recover/consensus_load"):
            local = self._ckpt.all_steps()
            all_sets = self.comm.allgather_obj(local)
            common = set(all_sets[0])
            for s in all_sets[1:]:
                common &= set(s)
            if not common:
                return None
            iteration = max(common)
            tree = self._ckpt.restore(iteration)
            with _per_rank_state(trainer):
                trainer.serialize(NpzDeserializer(tree, strict=False))
            self._protected_iteration = iteration
            return iteration

    def finalize(self):
        self._ckpt.close()

    def serialize(self, serializer):
        pass
