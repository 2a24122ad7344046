"""Paged attention for the serving engine: decode and suffix prefill.

Plain PyTorch (the JAX package's counterpart is jnp, not Pallas).  The KV
cache lives in page pools ``[P, S, H, D]`` (``serving.kv_cache``) and a
sequence's token ``t`` sits at page ``block_table[t // S]``, slot
``t % S``, so attention gathers K/V through the block table: one gather
per pool, then a masked softmax.

Two decode lowerings, chosen by :func:`paged_attn_mode`:

* ``paged`` (default): each page's softmax pieces ``(m, l, acc)`` in one
  batched op over the page axis, then merged over the pages with the
  online-softmax rules (the ``-inf`` / ``m_safe`` guards) -- the math of
  the JAX package's ``lax.scan`` over pages, without a Python loop over
  pages (which would cost a launch per page per layer);
* ``dense``: the reference -- the same gather flattened to ``[B, T, H, D]``
  and one full-width masked softmax.

Dtype discipline: pages keep their storage dtype; the dots are fp32 dots
of the exactly upcast values (the JAX ``preferred_element_type=float32``
result), the softmax state is fp32, and probabilities are cast to the
value dtype before the second dot.  An all-masked row (an idle lane)
yields zeros, never NaN.
"""

from __future__ import annotations

import os

import torch

__all__ = ["paged_decode_attention", "paged_prefill_attention",
           "paged_attn_mode"]

_NEG_INF = float("-inf")


def paged_attn_mode(mode=None):
    """The decode lowering: the explicit argument wins, else
    ``CHAINERMN_TPU_PAGED_ATTN`` (``paged`` default, ``dense`` the
    reference)."""
    if mode is None:
        mode = os.environ.get("CHAINERMN_TPU_PAGED_ATTN", "paged")
    if mode not in ("paged", "dense"):
        raise ValueError(
            f"CHAINERMN_TPU_PAGED_ATTN={mode!r} invalid (paged|dense)")
    return mode


def _finite_or_zero(m):
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def _masked_softmax_stats(s, valid):
    """NaN-free masked softmax pieces: ``(p, l)`` with all-masked rows
    giving ``p == 0``."""
    s = s.masked_fill(~valid, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(torch.isfinite(s), torch.exp(s - _finite_or_zero(m)),
                    torch.zeros_like(s))
    return p, p.sum(dim=-1, keepdim=True)


def _pv(p, v, spec):
    """``einsum(spec, p cast to v's dtype, v)`` accumulated in fp32."""
    return torch.einsum(spec, p.to(v.dtype).float(), v.float())


def paged_prefill_attention(q, k_pool, v_pool, block_table_row, start,
                            true_len, scale=None):
    """Suffix attention for a prefix-shared prefill.

    ``q``: ``[T, H, D]``, query ``t`` at absolute position ``start + t``.
    The suffix's K/V must already be written into the pools, so one gather
    per pool through ``block_table_row`` (``[N]``) covers the whole
    context.  Query ``t`` sees positions ``<= start + t``.  Returns
    ``[T, H, D]`` in ``q.dtype``.  (``true_len`` is unused: causality
    already keeps padding out of every valid query.)"""
    del true_len
    T, H, D = q.shape
    S = k_pool.shape[1]
    N = block_table_row.shape[0]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    k = k_pool[block_table_row].reshape(N * S, H, D)
    v = v_pool[block_table_row].reshape(N * S, H, D)
    s = torch.einsum("thd,khd->htk", q.float(), k.float()) * scale
    kpos = torch.arange(N * S, device=q.device)[None, None, :]
    qpos = start + torch.arange(T, device=q.device)[None, :, None]
    p, l = _masked_softmax_stats(s, kpos <= qpos)
    p = p / l.clamp_min(1e-30)
    return _pv(p, v, "htk,khd->thd").to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, block_table, ctx_len,
                           scale=None, mode=None):
    """One decode step of attention for a batch of cached sequences.

    ``q``: ``[B, H, D]``, one query per sequence.  ``k_pool``/``v_pool``:
    ``[P, S, H, D]``.  ``block_table``: ``[B, N]`` page ids (entries past
    the live prefix may hold any valid page id; ``ctx_len`` masks them).
    ``ctx_len``: ``[B]`` valid context lengths, ``0`` for an idle lane
    (output zeros).  Returns ``[B, H, D]`` in ``q.dtype``."""
    B, H, D = q.shape
    S = k_pool.shape[1]
    N = block_table.shape[1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    mode = paged_attn_mode(mode)
    k_pages = k_pool[block_table]          # [B, N, S, H, D]
    v_pages = v_pool[block_table]
    ctx = ctx_len.reshape(B, 1, 1)

    if mode == "dense":
        k = k_pages.reshape(B, N * S, H, D)
        v = v_pages.reshape(B, N * S, H, D)
        s = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale
        kpos = torch.arange(N * S, device=q.device)[None, None, :]
        p, l = _masked_softmax_stats(s, kpos < ctx)
        p = p / l.clamp_min(1e-30)
        return _pv(p, v, "bht,bthd->bhd").to(q.dtype)

    # per page: m_n, l_n, acc_n over its S slots, all pages at once
    s = torch.einsum("bhd,bnshd->bhns", q.float(), k_pages.float()) * scale
    kpos = torch.arange(N * S, device=q.device).reshape(1, 1, N, S)
    s = s.masked_fill(kpos >= ctx.reshape(B, 1, 1, 1), _NEG_INF)
    m_n = s.amax(dim=-1, keepdim=True)                  # [B, H, N, 1]
    p = torch.where(torch.isfinite(s), torch.exp(s - _finite_or_zero(m_n)),
                    torch.zeros_like(s))
    l_n = p.sum(dim=-1, keepdim=True)
    acc_n = _pv(p, v_pages, "bhns,bnshd->bhnd")         # [B, H, N, D]
    # merge over pages: rescale each page to the row's running maximum,
    # with an all-masked page (m_n = -inf) weighted 0
    m = m_n.amax(dim=2, keepdim=True)
    w = torch.where(torch.isfinite(m_n), torch.exp(m_n - _finite_or_zero(m)),
                    torch.zeros_like(m_n))
    l = (w * l_n).sum(dim=2)                            # [B, H, 1]
    acc = (w * acc_n).sum(dim=2)                        # [B, H, D]
    return (acc / l.clamp_min(1e-30)).to(q.dtype)
