"""Attention ops: the flash kernel's dispatch and the paged attention."""

from .flash_attention import attention, flash_attention, xla_attention
from .paged_attention import (paged_attn_mode, paged_decode_attention,
                              paged_prefill_attention)

__all__ = ["attention", "flash_attention", "xla_attention",
           "paged_attn_mode", "paged_decode_attention",
           "paged_prefill_attention"]
