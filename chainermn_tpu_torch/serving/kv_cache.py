"""Paged KV cache: preallocated device pools and in-place page writes.

The engine owns two pools ``[L, P, S, H, D]`` (layers x pages x page slots
x heads x head dim), allocated once and bf16 by default: decode reads
every cached byte each step, so the stored element size is the lever.
Token ``t`` of a sequence lives at ``(page=block_table[t // S],
slot=t % S)``.

Where the JAX package threads the pools through its compiled programs and
donates them so XLA updates pages in place, the port writes in place with
``index_put_``.  And where the JAX writers scatter with ``mode="drop"`` to
the out-of-range page ``P`` (an idle decode lane, prompt padding), torch
has no drop mode: each pool is allocated with ``P + 1`` pages, page ``P``
is the trash page that takes the dropped writes, and
``PagedKVCache.k_pool``/``v_pool`` are views of the ``P`` real pages.  The
writers therefore take a layer of the *store* (``[P + 1, S, H, D]``) and
never need a host round trip to mask.
"""

from __future__ import annotations

import torch

from .._device import resolve_device

__all__ = ["PagedKVCache", "write_prompt_kv", "write_prompt_kv_at",
           "write_token_kv", "copy_page"]


def write_prompt_kv_at(store_l, kv, block_table_row, start, true_len):
    """Write a prompt's (or a suffix's) K or V into one layer, in place.

    ``store_l``: ``[P + 1, S, H, D]``, the trash page last.  ``kv``:
    ``[T, H, D]``; position ``t`` lands at absolute position ``start + t``.
    Positions ``t >= true_len`` (padding) go to the trash page."""
    trash, S = store_l.shape[0] - 1, store_l.shape[1]
    t = torch.arange(kv.shape[0], device=kv.device)
    posn = start + t
    # clamp keeps the table lookup in range for padding past the table
    idx = torch.clamp(posn // S, max=block_table_row.shape[0] - 1)
    pages = torch.where(t < true_len, block_table_row[idx],
                        torch.full_like(idx, trash))
    store_l.index_put_((pages, posn % S), kv.to(store_l.dtype))


def write_prompt_kv(store_l, kv, block_table_row, true_len):
    """:func:`write_prompt_kv_at` from position 0."""
    write_prompt_kv_at(store_l, kv, block_table_row, 0, true_len)


def write_token_kv(store_l, kv, block_tables, pos):
    """Write one decode token per batch lane into one layer, in place.

    ``kv``: ``[B, H, D]``.  ``pos``: ``[B]`` positions; ``pos < 0`` marks
    an idle lane, whose write goes to the trash page.  ``block_tables``:
    ``[B, N]``."""
    trash, S = store_l.shape[0] - 1, store_l.shape[1]
    b = torch.arange(pos.shape[0], device=pos.device)
    safe = pos.clamp_min(0)
    pages = torch.where(pos >= 0, block_tables[b, safe // S],
                        torch.full_like(safe, trash))
    store_l.index_put_((pages, safe % S), kv.to(store_l.dtype))


def copy_page(k_store, v_store, src, dst):
    """Fork-on-write: copy page ``src`` into page ``dst`` across every
    layer of both pools, in place."""
    k_store[:, dst] = k_store[:, src]
    v_store[:, dst] = v_store[:, src]


class PagedKVCache:
    """The engine-owned pool pair.  ``k_store``/``v_store`` hold
    ``num_pages + 1`` pages (the last is the trash page);
    ``k_pool``/``v_pool`` are views of the real pages."""

    def __init__(self, n_layers, num_pages, page_size, n_heads, d_head,
                 dtype=torch.bfloat16, device=None):
        self.n_layers = int(n_layers)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.n_heads = int(n_heads)
        self.d_head = int(d_head)
        self.dtype = dtype
        shape = (self.n_layers, self.num_pages + 1, self.page_size,
                 self.n_heads, self.d_head)
        device = resolve_device(device)
        self.k_store = torch.zeros(shape, dtype=dtype, device=device)
        self.v_store = torch.zeros(shape, dtype=dtype, device=device)

    @property
    def k_pool(self):
        return self.k_store[:, :self.num_pages]

    @property
    def v_pool(self):
        return self.v_store[:, :self.num_pages]

    @property
    def page_bytes(self):
        """Bytes one page holds across K and V."""
        return (2 * self.page_size * self.n_heads * self.d_head
                * self.k_store.element_size())

    @property
    def pool_bytes(self):
        return self.n_layers * self.num_pages * self.page_bytes
