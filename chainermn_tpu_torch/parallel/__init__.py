"""Parallelism beyond the data-parallel step: pipelines and mesh helpers.

The port of the model-parallel part of ``chainermn_tpu.parallel``: the
microbatched GPipe pipeline (:mod:`.pipeline`), the 1F1B schedule
(:mod:`.one_f_one_b`) and named axes over process subgroups for hybrid
layouts (:mod:`.mesh`).  Sequence parallelism (ring attention, Ulysses)
and the mixture of experts wait for ROADMAP A9.
"""

from .mesh import Mesh, axis_communicators, make_mesh, replicate, shard_batch
from .one_f_one_b import (heterogeneous_stage_fn, make_pipeline_train_step,
                          one_f_one_b)
from .pipeline import gpipe_apply, merge_microbatches, split_microbatches

__all__ = ["Mesh", "make_mesh", "axis_communicators", "shard_batch",
           "replicate", "gpipe_apply", "split_microbatches",
           "merge_microbatches", "one_f_one_b", "make_pipeline_train_step",
           "heterogeneous_stage_fn"]
