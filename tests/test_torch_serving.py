"""The port's serving path against the JAX package's.

Module by module (the KV writers with their drop semantics, the paged
decode and suffix-prefill attention, the allocator) and then the slice as
a whole: the port's and the JAX ``ServingEngine`` run the same requests on
the same weights and must emit identical greedy token lists in fp32.
Tolerances: fp32 atol 1e-5 (summation order only); bf16 within the
decode-parity suite's band (0.25).
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.ops import paged_attention as jpa
from chainermn_tpu.serving import BlockAllocator as JaxAllocator
from chainermn_tpu.serving import Request as JaxRequest
from chainermn_tpu.serving import ServingEngine as JaxEngine
from chainermn_tpu.serving import kv_cache as jkv
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.ops import paged_attention as pa
from chainermn_tpu_torch.serving import (BlockAllocator, PagedKVCache,
                                         Request, ServingEngine,
                                         decode_program, kv_cache,
                                         prefill_program)

VOCAB = 101
KW = dict(n_vocab=VOCAB, d_model=32, n_heads=2, n_layers=2, max_len=128)
ATOL = 1e-5
BF16_BAND = 0.25
P, S, H, D = 6, 4, 2, 8


def _pool(rng):
    return rng.normal(0, 1, (P, S, H, D)).astype(np.float32)


def _store(pool):
    """A port layer store: the JAX pool plus a trash page."""
    return torch.from_numpy(np.concatenate(
        [pool, np.zeros((1, S, H, D), np.float32)]))


# -- KV writers -------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 3])
def test_prompt_writers_drop_padding_like_jax(start):
    rng = np.random.RandomState(start)
    pool = _pool(rng)
    kv = rng.normal(0, 1, (9, H, D)).astype(np.float32)
    bt = np.array([4, 1, 5, 0], np.int32)
    true_len = 6                       # positions 6..8 are padding
    ref = np.asarray(jkv.write_prompt_kv_at(jnp.asarray(pool),
                                            jnp.asarray(kv), jnp.asarray(bt),
                                            start, true_len))
    store = _store(pool)
    kv_cache.write_prompt_kv_at(store, torch.from_numpy(kv),
                                torch.from_numpy(bt).long(), start, true_len)
    np.testing.assert_array_equal(store[:P].numpy(), ref)


def test_token_writer_drops_idle_lanes_like_jax():
    rng = np.random.RandomState(1)
    pool = _pool(rng)
    kv = rng.normal(0, 1, (3, H, D)).astype(np.float32)
    bts = np.array([[2, 3], [5, 1], [0, 4]], np.int32)
    pos = np.array([5, -1, 2], np.int32)      # lane 1 idle
    ref = np.asarray(jkv.write_token_kv(jnp.asarray(pool), jnp.asarray(kv),
                                        jnp.asarray(bts), jnp.asarray(pos)))
    store = _store(pool)
    kv_cache.write_token_kv(store, torch.from_numpy(kv),
                            torch.from_numpy(bts).long(),
                            torch.from_numpy(pos).long())
    np.testing.assert_array_equal(store[:P].numpy(), ref)


def test_copy_page_like_jax():
    rng = np.random.RandomState(2)
    k, v = [rng.normal(0, 1, (2, P, S, H, D)).astype(np.float32)
            for _ in range(2)]
    rk, rv = jkv.copy_page(jnp.asarray(k), jnp.asarray(v), 1, 4)
    cache = PagedKVCache(2, P, S, H, D, dtype=torch.float32, device="cpu")
    cache.k_pool.copy_(torch.from_numpy(k))
    cache.v_pool.copy_(torch.from_numpy(v))
    kv_cache.copy_page(cache.k_store, cache.v_store, 1, 4)
    np.testing.assert_array_equal(cache.k_pool.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(cache.v_pool.numpy(), np.asarray(rv))


# -- paged attention --------------------------------------------------------

@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_decode_attention_matches_jax(mode):
    rng = np.random.RandomState(3)
    kp, vp = _pool(rng), _pool(rng)
    q = rng.normal(0, 1, (4, H, D)).astype(np.float32)
    bts = np.array([[0, 2, 5], [1, 3, 4], [5, 0, 1], [2, 2, 2]], np.int32)
    ctx = np.array([9, 4, 0, 12], np.int32)   # lane 2 idle
    ref = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bts),
        jnp.asarray(ctx), mode=mode))
    got = pa.paged_decode_attention(
        *[torch.from_numpy(a) for a in (q, kp, vp)],
        torch.from_numpy(bts).long(), torch.from_numpy(ctx).long(),
        mode=mode).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert np.all(got[2] == 0)                # idle lane: zeros, not NaN


def test_prefill_attention_matches_jax():
    rng = np.random.RandomState(4)
    kp, vp = _pool(rng), _pool(rng)
    q = rng.normal(0, 1, (5, H, D)).astype(np.float32)
    bt = np.array([3, 0, 4, 1], np.int32)
    ref = np.asarray(jpa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        7, 4))
    got = pa.paged_prefill_attention(
        *[torch.from_numpy(a) for a in (q, kp, vp)],
        torch.from_numpy(bt).long(), 7, 4).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_paged_attn_mode_resolution(monkeypatch):
    assert pa.paged_attn_mode("dense") == "dense"
    monkeypatch.setenv("CHAINERMN_TPU_PAGED_ATTN", "dense")
    assert pa.paged_attn_mode() == "dense"
    with pytest.raises(ValueError):
        pa.paged_attn_mode("bogus")


def test_allocator_churn_matches_jax():
    """Same call sequence, same block tables, refcounts and trie matches
    (the copied host module stays in step with the reference)."""
    a, b = BlockAllocator(12, 4), JaxAllocator(12, 4)
    rng = np.random.RandomState(5)
    base = tuple(int(t) for t in rng.randint(0, 50, 10))
    for alloc in (a, b):
        alloc.ensure("p", 11)
        alloc.register_prefix("p", base)
        pages, matched, n_full, partial = alloc.match_prefix(base + (7,), 10)
        alloc.share("q", pages)
        alloc.fork("q", n_full)
        alloc.ensure("q", 14)
        alloc.free("p")
        alloc.ensure("r", 9)
    for sid in ("q", "r"):
        assert a.block_table(sid) == b.block_table(sid)
    assert a.free_pages == b.free_pages and a.check() and b.check()


# -- the slice as a whole ---------------------------------------------------

def _models():
    return JaxLM(seed=0, **KW), TransformerLM(seed=0, device="cpu", **KW)


def _run(engine_cls, request_cls, model, prompts, max_new, stagger,
         **kw):
    eng = engine_cls(model, page_size=8, max_batch=4, max_context=64,
                     page_dtype=kw.pop("page_dtype"), **kw)
    reqs = [request_cls(p, max_new_tokens=max_new, request_id=i)
            for i, p in enumerate(prompts)]
    if stagger:
        # the provider decodes alone for two steps, then the borrowers
        # join and fork its partial tail page
        eng.submit(reqs[0])
        eng.step(now=0.0)
        eng.step(now=0.0)
        reqs = reqs[1:]
    for r in reqs:
        eng.submit(r)
    eng.drain(now=0.0, max_steps=500)
    done = sorted(eng.completed, key=lambda r: r.request_id)
    return eng, [list(r.prompt) + list(r.tokens) for r in done]


def _both(prompts, max_new=6, stagger=False, **kw):
    jm, tm = _models()
    je, jt = _run(JaxEngine, JaxRequest, jm, prompts, max_new, stagger,
                  page_dtype=jnp.float32, **kw)
    te, tt = _run(ServingEngine, Request, tm, prompts, max_new, stagger,
                  page_dtype=torch.float32, device="cpu", **kw)
    assert len(tt) == len(prompts)
    assert tt == jt                       # identical greedy tokens
    assert te.allocator.check() and te.allocator.used_pages == 0
    return je, te


def _chat_prompts(rng, shared_len=20, tails=(0, 9, 3)):
    base = rng.randint(0, VOCAB, shared_len).astype(np.int32)
    return [np.concatenate([base, rng.randint(0, VOCAB, n)
                            .astype(np.int32)]) for n in tails]


def test_engine_matches_jax_distinct_prompts():
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, VOCAB, n).astype(np.int32)
               for n in (5, 13, 8, 17, 3)]
    je, te = _both(prompts, num_pages=64)
    assert te.full_prefills == 5 and te.prefix_hits == je.prefix_hits == 0


def test_engine_matches_jax_shared_prefix_with_fork():
    """A 20-token system prompt at page size 8: the provider's prompt is
    the system prompt alone, so both borrowers hit and fork its partial
    tail page after the provider has written into it."""
    prompts = _chat_prompts(np.random.RandomState(1))
    je, te = _both(prompts, stagger=True, num_pages=64)
    assert te.prefix_hits == je.prefix_hits == 2
    assert te.forks >= 1 and je.forks >= 1
    assert te.forks == je.forks


def test_engine_matches_jax_under_eviction():
    prompts = [np.random.RandomState(i).randint(0, VOCAB, 16)
               .astype(np.int32) for i in range(3)]
    je, te = _both(prompts, max_new=16, num_pages=6)
    assert te.evictions > 0 and te.evictions == je.evictions


def test_prefill_and_decode_match_one_shot_forward():
    """Prefill + N paged decode steps equal the one-shot forward at each
    position (fp32 atol 1e-5), for both decode lowerings."""
    model = TransformerLM(seed=0, device="cpu", **KW)
    full = np.random.RandomState(7).randint(0, VOCAB, 14)
    with torch.no_grad():
        ref = model.logits(torch.from_numpy(full)[None])[0].numpy()
    for mode in ("paged", "dense"):
        cache = PagedKVCache(2, 16, 4, 2, 16, dtype=torch.float32,
                             device="cpu")
        bt = torch.arange(8)
        tokens = torch.zeros((1, 16), dtype=torch.long)
        tokens[0, :9] = torch.from_numpy(full[:9])
        logits = prefill_program(model, cache, tokens, 9, bt)
        np.testing.assert_allclose(logits.numpy(), ref[8], atol=ATOL)
        for pos in range(9, 14):
            logits, _ = decode_program(
                model, cache, torch.tensor([int(full[pos]), 0]),
                torch.tensor([pos, -1]), torch.stack([bt, bt]), mode=mode)
            np.testing.assert_allclose(logits[0].numpy(), ref[pos],
                                       atol=ATOL)


def test_bf16_pages_within_band():
    model = TransformerLM(seed=0, compute_dtype=torch.bfloat16,
                          device="cpu", **KW)
    full = np.random.RandomState(3).randint(0, VOCAB, 12)
    with torch.no_grad():
        ref = model.logits(torch.from_numpy(full)[None])[0].float().numpy()
    cache = PagedKVCache(2, 8, 8, 2, 16, device="cpu")
    assert cache.k_store.dtype == torch.bfloat16
    bt = torch.arange(2)
    logits = prefill_program(model, cache, torch.from_numpy(full[:8])[None],
                             8, bt)
    assert np.abs(logits.numpy() - ref[7]).max() < BF16_BAND
    for pos in range(8, 12):
        logits, _ = decode_program(model, cache, torch.tensor([full[pos]]),
                                   torch.tensor([pos]), bt[None],
                                   mode="paged")
        assert np.abs(logits[0].numpy() - ref[pos]).max() < BF16_BAND


#: a stand-in for a communicator of one rank on the CPU
_ONE_RANK = SimpleNamespace(size=1, rank=0, device=torch.device("cpu"))


@pytest.mark.parametrize("option,match", [
    ({"tp": 2}, "needs tp_comm"),
    ({"tp": 3}, "must divide n_heads=2"),
    ({"tp": 2, "tp_comm": _ONE_RANK}, "tp_comm has 1"),
    ({"decode_device": "meta"}, "name two devices")])
def test_unported_engine_options_raise(option, match):
    """The engine options the port refuses, each with a ``ValueError``:
    tensor parallelism without a communicator of ``tp`` ranks or over a
    head count ``tp`` does not divide (the JAX engine's refusals of too
    few devices and of ``n_heads % tp``), and a ``decode_device`` that is
    not the engine's ``device``."""
    model = TransformerLM(seed=0, device="cpu", **KW)
    with pytest.raises(ValueError, match=match):
        ServingEngine(model, num_pages=8, page_size=8, max_context=32,
                      device="cpu", **option)


def test_engine_refuses_a_model_on_another_device():
    model = TransformerLM(seed=0, device="cpu", **KW)
    with pytest.raises(ValueError, match="lies on"):
        ServingEngine(model, num_pages=8, page_size=8, max_context=32,
                      device="meta")
