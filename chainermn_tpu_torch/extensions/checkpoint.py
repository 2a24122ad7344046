"""Distributed checkpointing with consensus resume.

The port of ``chainermn_tpu.extensions.checkpoint`` (reference:
``chainermn/extensions/checkpoint.py · create_multi_node_checkpointer,
_MultiNodeCheckpointer``): every rank snapshots its own trainer state
(``<name>.<iteration>.<rank>``) on a trigger, old generations are
garbage-collected, and ``maybe_load`` allgathers each rank's verified
snapshot iterations, picks the newest iteration present on *all* ranks,
and resumes every rank from its own file of that iteration -- the
fail-stop recovery contract (crash, relaunch, converge on the newest
common checkpoint).

A rank is a process here, one per device, as in the reference: files are
keyed by the communicator's ``stable_rank`` where it has one, else by its
``rank``.  (The JAX package keys them by ``inter_rank``, one controller
per host; in a world of processes the ranks of one host would share that
key and write, collect and vote on one file.)  Under the multi-node
optimizer's sharded update ``serialize`` is a collective, and every rank
saves.

Integrity, as in the JAX package: a snapshot is serialized to memory,
written to a tmp file, its SHA-256 sidecar (``<file>.sum``) published
(itself tmp + rename) *before* the data is renamed into place, so a
snapshot torn by a crash either never becomes visible or fails
verification; ``_scan`` offers only verified iterations to the vote
(a mismatching file is counted in ``stats["verify_failures"]``), and the
generation a consensus resume loaded is pinned against GC
(``_protected_iteration``).  ``save`` runs in a
``train/checkpoint_serialize`` span and ``maybe_load`` in a
``recover/consensus_load`` span (``observability``).
"""

from __future__ import annotations

import hashlib
import io
import os
import re
import tempfile
import time

from .. import observability
from ..serializers.npz import load_npz, save_npz
from ..training.trainer import Extension

__all__ = ["create_multi_node_checkpointer", "_MultiNodeCheckpointer"]


def _sha256_file(path, bufsize=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(bufsize)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def file_rank(comm):
    """The rank a checkpointer keys this process's files by: the
    communicator's ``stable_rank`` where it has one, else its ``rank``."""
    return getattr(comm, "stable_rank", comm.rank)


def create_multi_node_checkpointer(comm, name="", cp_interval=5,
                                   gc_interval=5, path=None):
    """Reference-shaped factory.

    ``cp_interval``: number of snapshot generations kept.  ``gc_interval``:
    collection cadence -- stale generations are removed once they number at
    least ``gc_interval`` (batching deletes instead of one unlink per save).
    ``path``: the directory (the trainer's ``out`` when ``None``).
    """
    return _MultiNodeCheckpointer(comm, name, cp_interval, gc_interval, path)


class _MultiNodeCheckpointer(Extension):
    trigger = (1, "epoch")
    priority = -100  # after everything else mutated state this iteration

    def __init__(self, comm, name, cp_interval, gc_interval, path):
        self.comm = comm
        self.name = name
        self.cp_interval = cp_interval
        self.gc_interval = gc_interval
        self.path = path
        self.stats = {"snapshots": 0, "gc": 0, "save_time": 0.0,
                      "verify_failures": 0}
        self._files = []
        # the iteration the last consensus resume loaded, pinned against
        # GC: a rank running ahead must not sweep the newest COMMON
        # generation while a peer may still be resuming from it
        self._protected_iteration = None
        # test seam: called with (tmp_path, final_name) between the
        # serialized write and the atomic publish, to model a crash
        # mid-write
        self._write_fault_hook = None

    @property
    def rank(self):
        return file_rank(self.comm)

    def _dir(self, trainer=None):
        if self.path is not None:
            return self.path
        assert trainer is not None
        return trainer.out

    def _filename(self, iteration):
        return f"{self.name}.{iteration}.{self.rank}"

    _pattern = property(lambda self: re.compile(
        re.escape(self.name) + r"\.(\d+)\.(\d+)$"))

    # -- save -------------------------------------------------------------
    def __call__(self, trainer):
        self.save(trainer, trainer.updater.iteration)

    def save(self, trainer, iteration):
        """Atomic, checksummed snapshot write: serialize to a tmp file,
        publish the SHA-256 sidecar, then rename the data into place.  A
        failure at any point leaves no visible snapshot (tmp names never
        match ``_pattern``) or one whose sidecar is already durable."""
        with observability.span("train/checkpoint_serialize",
                                tags={"iteration": int(iteration)}):
            return self._save_impl(trainer, iteration)

    def _save_impl(self, trainer, iteration):
        start = time.time()
        out = self._dir(trainer)
        os.makedirs(out, exist_ok=True)
        fname = self._filename(iteration)
        fd, tmp = tempfile.mkstemp(prefix=fname + ".tmp", dir=out)
        os.close(fd)
        sum_tmp = None
        try:
            # serialized once to memory: the digest is of the bytes in
            # hand (zipfile seeks while writing, so hashing the stream
            # as it is written would be wrong)
            buf = io.BytesIO()
            save_npz(buf, trainer)
            data = buf.getbuffer()
            with open(tmp, "wb") as f:
                f.write(data)
            if self._write_fault_hook is not None:
                self._write_fault_hook(tmp, fname)
            digest = hashlib.sha256(data).hexdigest()
            fd, sum_tmp = tempfile.mkstemp(prefix=fname + ".sum.tmp",
                                           dir=out)
            with os.fdopen(fd, "w") as f:
                f.write(digest)
            os.replace(sum_tmp, os.path.join(out, fname + ".sum"))
            sum_tmp = None
            os.replace(tmp, os.path.join(out, fname))
        except Exception:
            for leftover in (tmp, sum_tmp):
                if leftover is not None and os.path.exists(leftover):
                    os.remove(leftover)
            raise
        if fname not in self._files:  # re-crossed after a rollback: one
            self._files.append(fname)  # entry, or _gc's keep/stale split
            # would count the generation twice and delete a kept file
        self.stats["snapshots"] += 1
        self.stats["save_time"] += time.time() - start
        if len(self._files) >= self.cp_interval + self.gc_interval:
            self._gc(out)

    def _gc(self, out):
        keep = sorted(self._files,
                      key=lambda f: int(self._pattern.match(f).group(1)))
        stale, keep = keep[: -self.cp_interval], keep[-self.cp_interval:]
        protected = []
        for fname in stale:
            if self._protected_iteration is not None and \
                    int(self._pattern.match(fname).group(1)) == \
                    self._protected_iteration:
                protected.append(fname)
                continue
            try:
                os.remove(os.path.join(out, fname))
                self.stats["gc"] += 1
            except OSError:
                # the data survived: keep its sidecar and keep tracking
                # it, so the next gc retries
                protected.append(fname)
                continue
            try:
                os.remove(os.path.join(out, fname + ".sum"))
            except OSError:
                pass
        self._files = protected + keep

    # -- consensus resume ---------------------------------------------------
    def maybe_load(self, trainer, optimizer=None, path=None):
        """Resume from the newest iteration *every* rank has a verified
        snapshot of: local scan, allgather of the iteration sets, the
        maximum of their intersection, ``load_npz`` of this rank's own
        file.  Returns the resumed iteration or None.  The resumed
        iteration is pinned against GC."""
        with observability.span("recover/consensus_load"):
            return self._maybe_load_impl(trainer, path)

    def _maybe_load_impl(self, trainer, path=None):
        out = path or self._dir(trainer)
        local = self._scan(out)
        all_sets = self.comm.allgather_obj(sorted(local))
        common = set(all_sets[0])
        for s in all_sets[1:]:
            common &= set(s)
        if not common:
            return None
        iteration = max(common)
        load_npz(os.path.join(out, self._filename(iteration)), trainer,
                 strict=False)
        self._files = [self._filename(i) for i in sorted(local)]
        self._protected_iteration = iteration
        return iteration

    def _scan(self, out):
        """This rank's iterations whose files verify against their
        sidecar.  Sidecar-less files are admitted (written before
        sidecars existed); a mismatching one is left out and counted."""
        iterations = set()
        if not os.path.isdir(out):
            return iterations
        for fname in os.listdir(out):
            m = self._pattern.match(fname)
            if not (m and int(m.group(2)) == self.rank):
                continue
            if not self._verify(os.path.join(out, fname)):
                self.stats["verify_failures"] += 1
                continue
            iterations.add(int(m.group(1)))
        return iterations

    def _verify(self, path):
        sum_path = path + ".sum"
        if not os.path.exists(sum_path):
            return True
        try:
            with open(sum_path) as f:
                expect = f.read().strip()
            return _sha256_file(path) == expect
        except OSError:
            return False

    def finalize(self):
        pass

    def serialize(self, serializer):
        pass
