"""Parallelism beyond the data-parallel step.

The port of ``chainermn_tpu.parallel``: the microbatched GPipe pipeline
(:mod:`.pipeline`), the 1F1B schedule (:mod:`.one_f_one_b`), named axes
over process subgroups for hybrid layouts (:mod:`.mesh`), sequence
parallelism (ring attention with the naive and zigzag schedules,
:mod:`.ring_attention`; Ulysses, :mod:`.ulysses`) and the mixture of
experts over all-to-all (:mod:`.moe`).
"""

from .mesh import Mesh, axis_communicators, make_mesh, replicate, shard_batch
from .moe import moe_dispatch_combine, moe_dispatch_combine_topk, switch_moe
from .one_f_one_b import (heterogeneous_stage_fn, make_pipeline_train_step,
                          one_f_one_b)
from .pipeline import gpipe_apply, merge_microbatches, split_microbatches
from .ring_attention import (ring_attention, ring_self_attention,
                             zigzag_shard, zigzag_unshard)
from .ulysses import head_to_seq_shard, seq_to_head_shard, ulysses_attention

__all__ = ["Mesh", "make_mesh", "axis_communicators", "shard_batch",
           "replicate", "ring_self_attention", "ring_attention",
           "zigzag_shard", "zigzag_unshard", "ulysses_attention",
           "seq_to_head_shard", "head_to_seq_shard", "gpipe_apply",
           "split_microbatches", "merge_microbatches", "switch_moe",
           "moe_dispatch_combine", "moe_dispatch_combine_topk",
           "one_f_one_b", "make_pipeline_train_step",
           "heterogeneous_stage_fn"]
