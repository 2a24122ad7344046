"""Attention ops: the flash kernels' dispatch and the paged attention."""

from .flash_attention import (attention, attention_with_lse,
                              blockwise_attention, flash_attention,
                              flash_attention_bwd, flash_attention_fwd,
                              xla_attention)
from .paged_attention import (paged_attn_mode, paged_decode_attention,
                              paged_prefill_attention)

__all__ = ["attention", "attention_with_lse", "blockwise_attention",
           "flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "xla_attention", "paged_attn_mode", "paged_decode_attention",
           "paged_prefill_attention"]
