"""The port's speculative decoding and chunked prefill against the JAX
package's (twins of ``tests/serving_tests/test_spec_decode.py``).

The same seeded weights and prompts go through the JAX ``ServingEngine``
and the port's, fp32 on the CPU: the token lists and the counters
(``spec_*``, ``draft_dispatches``, ``chunk_prefills``,
``chunked_admissions``, ``evictions``, ``prefix_hits``) must be identical,
and the port's speculative and chunked outputs must equal its own vanilla
ones (greedy speculation and chunking never change a token).  Then module
by module: ``write_span_kv`` (dropped writes to the trash page),
``paged_verify_attention`` (idle lanes included), ``spec_verify_program``,
``ngram_propose`` and the scheduler's chunk state.  Tolerance: fp32 atol
1e-5 (summation order only).

The JAX side stays at one layer and two lanes, as its file does, so its
compiles stay cheap; the ragged-batch and mid-stream-join twins take four
lanes and the combined twin two layers.  The port is eager: it has no
``warmup()`` and no trace counters, so the JAX test
``test_spec_and_chunk_never_retrace_after_warmup`` has no twin here.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from chainermn_tpu.core.link import extract_state
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.ops import paged_attention as jpa
from chainermn_tpu.serving import PagedKVCache as JaxKV
from chainermn_tpu.serving import Request as JaxRequest
from chainermn_tpu.serving import RequestScheduler as JaxScheduler
from chainermn_tpu.serving import ServingEngine as JaxEngine
from chainermn_tpu.serving import kv_cache as jkv
from chainermn_tpu.serving import ngram_propose as jax_ngram_propose
from chainermn_tpu.serving import prefill_program as jax_prefill
from chainermn_tpu.serving import spec_verify_program as jax_spec_verify
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.ops import paged_attention as pa
from chainermn_tpu_torch.serving import (BlockAllocator, PagedKVCache,
                                         Request, RequestScheduler,
                                         ServingEngine, ngram_propose,
                                         prefill_program,
                                         prefix_prefill_program,
                                         serve_spec_k, spec_verify_program,
                                         write_span_kv)

VOCAB = 101
ATOL = 1e-5
COUNTERS = ("spec_steps", "spec_lane_steps", "spec_proposed",
            "spec_accepted", "spec_emitted", "draft_dispatches",
            "chunk_prefills", "chunked_admissions", "evictions",
            "prefix_hits", "admissions", "decode_steps")
P, S, H, D = 6, 4, 2, 8


def _cfg(n_layers=1):
    return dict(n_vocab=VOCAB, d_model=32, n_heads=2, max_len=128,
                n_layers=n_layers)


def _models(seed=0, n_layers=1):
    cfg = _cfg(n_layers)
    return (JaxLM(seed=seed, **cfg),
            TransformerLM(seed=seed, device="cpu", **cfg))


def _engine(engine_cls, model, **kw):
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_context", 64)
    if engine_cls is ServingEngine:
        kw["device"] = "cpu"
    return engine_cls(model, **kw)


def _submit(eng, request_cls, prompts, max_new, arrivals=None):
    for i, p in enumerate(prompts):
        eng.submit(request_cls(p, max_new_tokens=max_new, request_id=i,
                               arrival_time=0.0 if arrivals is None
                               else arrivals[i]))


def _finish(eng, t=0.0):
    while eng.running or eng.prefilling or eng.scheduler.pending():
        eng.step(now=t)
        t += 1.0
    return eng


def _serve(engine_cls, request_cls, model, prompts, max_new=8,
           arrivals=None, **kw):
    eng = _engine(engine_cls, model, **kw)
    _submit(eng, request_cls, prompts, max_new, arrivals)
    return _finish(eng)


def _seqs(eng):
    """Final sequences (original prompt + every generated token), keyed by
    the first prompt token: stable across eviction folding."""
    return {int(r.prompt[0]): [int(x) for x in r.prompt] + list(r.tokens)
            for r in eng.completed}


def _counters(eng):
    return {k: getattr(eng, k) for k in COUNTERS}


def _prompts(rng, lengths):
    out = []
    for i, L in enumerate(lengths):
        p = rng.randint(0, VOCAB, L).astype(np.int32)
        p[0] = i   # distinct keys for _seqs
        out.append(p)
    return out


def _twin(prompts, max_new=8, arrivals=None, n_layers=1, draft=None,
          **kw):
    """The JAX and the port engine on the same load: identical sequences
    and counters, the port's pool back whole; returns both engines and
    the port's vanilla run (no speculation, no chunking).  ``draft``:
    ``"self"`` (the target drafts for itself) or the seed of a draft
    model."""
    jm, tm = _models(n_layers=n_layers)
    jkw, tkw = dict(kw), dict(kw)
    if draft == "self":
        jkw["draft_model"], tkw["draft_model"] = jm, tm
    elif draft is not None:
        jkw["draft_model"], tkw["draft_model"] = _models(seed=draft,
                                                         n_layers=n_layers)
    je = _serve(JaxEngine, JaxRequest, jm, prompts, max_new, arrivals, **jkw)
    te = _serve(ServingEngine, Request, tm, prompts, max_new, arrivals,
                **tkw)
    van_kw = {k: v for k, v in kw.items()
              if k not in ("spec_k", "chunk_tokens", "chunk_budget")}
    van = _serve(ServingEngine, Request, tm, prompts, max_new, arrivals,
                 **van_kw)
    assert len(te.completed) == len(prompts)
    assert _seqs(te) == _seqs(je)
    assert _counters(te) == _counters(je)
    assert _seqs(te) == _seqs(van)
    assert te.allocator.used_pages == 0 and te.allocator.check()
    assert not te.prefilling and not te.running
    return je, te, van


# -- speculative decoding: the engine twins ---------------------------------


@pytest.mark.parametrize("spec_k", [1, 4])
def test_spec_solo_twin(spec_k):
    p = _prompts(np.random.RandomState(spec_k), [9])
    _, te, _ = _twin(p, max_new=10, spec_k=spec_k)
    assert te.spec_steps > 0
    assert te.spec_emitted == 9   # prefill emits token 1 of 10


def test_spec_batched_ragged_twin():
    prompts = _prompts(np.random.RandomState(0), (4, 9, 14, 19))
    _, te, _ = _twin(prompts, max_new=8, max_batch=4, spec_k=4)
    assert te.spec_lane_steps >= te.spec_steps > 0


def test_spec_mid_stream_join_twin():
    prompts = _prompts(np.random.RandomState(1), (5, 8, 12, 6))
    _twin(prompts, max_new=8, arrivals=[0.0, 0.0, 3.0, 5.0], max_batch=4,
          spec_k=3)


def _forced_eviction(engine_cls, request_cls, model, prompts, **kw):
    """Three steps, then the youngest running lane evicted by hand, then
    to the end: the same eviction point on every engine."""
    eng = _engine(engine_cls, model, **kw)
    _submit(eng, request_cls, prompts, 10)
    t = 0.0
    for _ in range(3):
        eng.step(now=t)
        t += 1.0
    eng._evict(eng.running[-1], t)
    _finish(eng, t)
    assert eng.evictions == 1
    assert any(r.preemptions > 0 for r in eng.completed)
    return eng


def test_spec_parity_across_forced_same_point_eviction_twin():
    jm, tm = _models()
    prompts = _prompts(np.random.RandomState(2), (6, 10, 15))
    je = _forced_eviction(JaxEngine, JaxRequest, jm, prompts, spec_k=4)
    te = _forced_eviction(ServingEngine, Request, tm, prompts, spec_k=4)
    van = _forced_eviction(ServingEngine, Request, tm, prompts)
    assert _seqs(te) == _seqs(je) == _seqs(van)
    assert _counters(te) == _counters(je)
    assert te.allocator.used_pages == 0 and te.allocator.check()


def test_self_draft_accepts_everything_and_cuts_dispatches_twin():
    """The target as its own draft: every proposal verifies, so an 8-token
    decode tail costs ceil(8 / (K + 1)) = 3 verify dispatches where
    vanilla decode pays 8."""
    p = _prompts(np.random.RandomState(3), [8])
    _, te, van = _twin(p, max_new=9, spec_k=2, draft="self")
    assert te.spec_steps == 3 and van.decode_steps == 8
    assert te.spec_proposed == te.spec_accepted > 0
    assert te.spec_emitted == 8
    assert te.draft_dispatches > 0


def test_separate_draft_model_twin():
    prompts = _prompts(np.random.RandomState(4), (6, 11))
    _, te, _ = _twin(prompts, max_new=8, spec_k=3, draft=1)
    assert te.draft_dispatches > 0
    assert te.spec_accepted <= te.spec_proposed


def test_spec_counters_measure_dispatch_economics_twin():
    prompts = _prompts(np.random.RandomState(5), (5, 9))
    _, te, _ = _twin(prompts, max_new=8, spec_k=4)
    assert te.spec_lane_steps >= te.spec_steps > 0
    assert 0 <= te.spec_accepted <= te.spec_proposed
    assert te.spec_emitted / te.spec_lane_steps >= 1.0


def test_ngram_self_draft_dispatches_nothing_twin():
    assert list(ngram_propose([1, 2, 3, 1, 2, 3, 1, 2], 3)) == [3, 1, 2]
    assert list(ngram_propose([7], 2)) == [7, 7]
    _, te, _ = _twin(_prompts(np.random.RandomState(6), [7]), max_new=6,
                     spec_k=3)
    assert te.draft_dispatches == 0 and te.draft_s > 0


# -- chunked prefill: the engine twins --------------------------------------


@pytest.mark.parametrize("chunk_budget", [None, 32])
def test_chunked_prefill_matches_unchunked_twin(chunk_budget):
    """One chunk a step (the default budget) or two."""
    prompts = _prompts(np.random.RandomState(7), (5, 20, 50))
    _, te, van = _twin(prompts, max_new=6, chunk_tokens=16,
                       chunk_budget=chunk_budget)
    assert te.chunked_admissions >= 2      # the 20- and 50-token prompts
    assert te.chunk_prefills > te.chunked_admissions
    # chunks run the suffix path: only the one unchunked prompt used the
    # flash prefill
    assert te.full_prefills == 1 and van.full_prefills == 3


def test_chunked_prefix_hit_twin():
    """A chunked admission that starts at a prefix hit: the borrower shares
    the provider's system-prompt pages (forking the partial one) and
    chunks only its unmatched 31 tokens, from the matched cursor on."""
    rng = np.random.RandomState(15)
    system = rng.randint(0, VOCAB, 20).astype(np.int32)
    prompts = [system.copy(),
               np.concatenate([system, rng.randint(0, VOCAB, 30)
                               .astype(np.int32)])]
    _, te, van = _twin(prompts[1:], max_new=6)   # the borrower alone
    jm, tm = _models()
    runs = []
    for engine_cls, request_cls, model in ((JaxEngine, JaxRequest, jm),
                                           (ServingEngine, Request, tm),
                                           (ServingEngine, Request, tm)):
        kw = {"chunk_tokens": 16} if len(runs) < 2 else {}
        eng = _engine(engine_cls, model, **kw)
        eng.submit(request_cls(prompts[0], max_new_tokens=8, request_id=0))
        eng.step(now=0.0)
        eng.step(now=1.0)
        eng.submit(request_cls(prompts[1], max_new_tokens=6, request_id=1,
                               arrival_time=2.0))
        runs.append(_finish(eng, 2.0))
    je, tc, tv = runs
    done = {r.request_id: r.tokens for r in tc.completed}
    assert done == {r.request_id: r.tokens for r in je.completed} \
        == {r.request_id: r.tokens for r in tv.completed}
    assert _counters(tc) == _counters(je)
    assert tc.prefix_hits == 1 and tc.chunked_admissions == 2
    assert tc.forks == je.forks == 1
    assert done[1] == te.completed[0].tokens    # the hit changes nothing
    assert tc.allocator.used_pages == 0 and tc.allocator.check()


def test_chunk_boundary_logits_match_oneshot():
    """A 37-token prompt in chunks of 16 + 16 + 5 through the engine's
    chunk path (``prefix_prefill_program`` from ``start=0``): at every
    chunk boundary the logits of the one-shot forward, the port's and the
    JAX model's, atol 1e-5; the JAX chunk-0 variant (a flash prefill)
    gives the same first row."""
    jm, tm = _models()
    L, chunk = 37, 16
    full = np.random.RandomState(8).randint(0, VOCAB, L).astype(np.int32)
    ref = np.asarray(jm.logits(jnp.asarray(full[None])))[0]
    with torch.no_grad():
        own = tm.logits(torch.from_numpy(full).long()[None])[0].numpy()
    np.testing.assert_allclose(own, ref, atol=ATOL)
    blk = tm.blocks[0].attn
    kv = PagedKVCache(1, 64, 8, blk.n_heads, blk.d_head,
                      dtype=torch.float32, device="cpu")
    alloc = BlockAllocator(64, 8)
    alloc.ensure(0, L + 1)
    row = np.zeros(8, np.int64)               # max_context 64 / page 8
    t = alloc.block_table(0)
    row[:len(t)] = t
    bt = torch.from_numpy(row)
    start = 0
    while start < L:
        n = min(chunk, L - start)
        toks = torch.zeros((1, chunk), dtype=torch.long)
        toks[0, :n] = torch.from_numpy(full[start:start + n])
        logits = prefix_prefill_program(tm, kv, toks, n, start, bt)
        np.testing.assert_allclose(logits.numpy(), ref[start + n - 1],
                                   atol=ATOL,
                                   err_msg=f"chunk boundary {start + n}")
        if start == 0:
            jkv_ = JaxKV(1, 64, 8, blk.n_heads, blk.d_head,
                         dtype=jnp.float32)
            _, _, jl = jax_prefill(jm, extract_state(jm), jkv_.k_pool,
                                   jkv_.v_pool, jnp.asarray(toks.numpy()
                                                            .astype(np.int32)),
                                   jnp.int32(n), jnp.asarray(row, jnp.int32))
            np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                       atol=ATOL)
        start += n


def test_prompt_longer_than_largest_bucket_twin():
    prompts = _prompts(np.random.RandomState(9), [50])
    _, te, _ = _twin(prompts, max_new=6, chunk_tokens=16)
    assert tuple(te.prefill_buckets) == (16,)
    assert te.chunked_admissions == 1


def _mid_chunk_eviction(engine_cls, request_cls, model, prompt):
    eng = _engine(engine_cls, model, chunk_tokens=16)
    _submit(eng, request_cls, [prompt], 6)
    t = 0.0
    for _ in range(3):
        if eng.prefilling and eng.prefilling[0]._chunk_pos > 0:
            break
        eng.step(now=t)
        t += 1.0
    req = eng.prefilling[0]
    assert 0 < req._chunk_pos < 50         # genuinely mid-chunk
    assert eng.allocator.used_pages > 0
    eng._evict(req, t)
    assert req._chunk_pos == 0 and req.preemptions == 1
    assert eng.allocator.used_pages == 0 and eng.allocator.check()
    assert not eng.prefilling
    return _finish(eng, t)


def test_mid_chunk_eviction_frees_pages_and_resets_cursor_twin():
    jm, tm = _models()
    prompt = _prompts(np.random.RandomState(10), [50])[0]
    je = _mid_chunk_eviction(JaxEngine, JaxRequest, jm, prompt)
    te = _mid_chunk_eviction(ServingEngine, Request, tm, prompt)
    van = _serve(ServingEngine, Request, tm, [prompt], max_new=6)
    assert _seqs(te) == _seqs(je) == _seqs(van)
    assert _counters(te) == _counters(je)


def test_spec_plus_chunk_combined_twin():
    """Both at once, two layers: chunks interleave with verify steps and a
    long prompt joins lanes already speculating."""
    prompts = _prompts(np.random.RandomState(11), (5, 40, 9))
    _, te, _ = _twin(prompts, max_new=8, arrivals=[0.0, 1.0, 2.0],
                     n_layers=2, spec_k=3, chunk_tokens=16)
    assert te.spec_steps > 0 and te.chunked_admissions == 1


def test_spec_k_env_hatch_and_validation(monkeypatch):
    _, tm = _models()
    with pytest.raises(ValueError):
        _engine(ServingEngine, tm, spec_k=-1)
    monkeypatch.setenv("CHAINERMN_TPU_SERVE_SPEC", "off")
    assert serve_spec_k(4) == 0
    eng = _engine(ServingEngine, tm, spec_k=4, draft_model=tm)
    assert eng.spec_k == 0 and eng.draft_model is None
    monkeypatch.delenv("CHAINERMN_TPU_SERVE_SPEC")
    assert serve_spec_k(4) == 4
    with pytest.raises(ValueError, match="multiple of"):
        _engine(ServingEngine, tm, chunk_tokens=12)
    with pytest.raises(ValueError, match="exceeds"):
        _engine(ServingEngine, tm, chunk_tokens=128)
    short = TransformerLM(seed=1, device="cpu",
                          **dict(_cfg(), max_len=32))
    with pytest.raises(ValueError, match="draft_model max_len"):
        _engine(ServingEngine, tm, spec_k=2, draft_model=short)
    on_meta = TransformerLM(seed=1, device="meta", **_cfg())
    with pytest.raises(ValueError, match="draft model lies on"):
        _engine(ServingEngine, tm, spec_k=2, draft_model=on_meta)


# -- module twins -----------------------------------------------------------


def _pool(rng):
    return rng.normal(0, 1, (P, S, H, D)).astype(np.float32)


def test_span_writer_drops_like_jax():
    """Idle lanes (``start < 0``) and slots past ``n_valid`` go to the
    trash page; the real pages end as the JAX drop-mode scatter leaves
    them."""
    rng = np.random.RandomState(12)
    pool = _pool(rng)
    kv = rng.normal(0, 1, (3, 4, H, D)).astype(np.float32)
    bts = np.array([[2, 3, 1], [5, 1, 0], [0, 4, 2]], np.int32)
    start = np.array([3, -1, 6], np.int32)     # lane 1 idle
    n_valid = np.array([4, 4, 2], np.int32)    # lane 2 writes two slots
    ref = np.asarray(jkv.write_span_kv(
        jnp.asarray(pool), jnp.asarray(kv), jnp.asarray(bts),
        jnp.asarray(start), jnp.asarray(n_valid)))
    store = torch.from_numpy(np.concatenate(
        [pool, np.zeros((1, S, H, D), np.float32)]))
    write_span_kv(store, torch.from_numpy(kv), torch.from_numpy(bts).long(),
                  torch.from_numpy(start).long(),
                  torch.from_numpy(n_valid).long())
    np.testing.assert_array_equal(store[:P].numpy(), ref)
    assert not np.array_equal(ref, pool)       # the live slots did write


def test_verify_attention_matches_jax():
    rng = np.random.RandomState(13)
    kp, vp = _pool(rng), _pool(rng)
    q = rng.normal(0, 1, (3, 4, H, D)).astype(np.float32)
    bts = np.array([[0, 2, 5], [1, 3, 4], [5, 0, 1]], np.int32)
    start = np.array([5, -2, 8], np.int32)     # lane 1 idle
    ref = np.asarray(jpa.paged_verify_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bts),
        jnp.asarray(start)))
    got = pa.paged_verify_attention(
        *[torch.from_numpy(a) for a in (q, kp, vp)],
        torch.from_numpy(bts).long(), torch.from_numpy(start).long()).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert np.all(got[1] == 0)                 # idle lane: zeros, not NaN


def test_spec_verify_program_matches_jax():
    """One verify step over a prefilled context on both sides: the logits
    rows (atol 1e-5), the argmax rows and the pools written."""
    jm, tm = _models(n_layers=2)
    rng = np.random.RandomState(14)
    blk = tm.blocks[0].attn
    lens = (11, 6)
    jk = JaxKV(2, 16, 8, blk.n_heads, blk.d_head, dtype=jnp.float32)
    tk = PagedKVCache(2, 16, 8, blk.n_heads, blk.d_head,
                      dtype=torch.float32, device="cpu")
    state = extract_state(jm)
    bts = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [0, 0, 0, 0]], np.int32)
    for b, L in enumerate(lens):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :L] = rng.randint(0, VOCAB, L)
        jk.k_pool, jk.v_pool, _ = jax_prefill(
            jm, state, jk.k_pool, jk.v_pool, jnp.asarray(toks),
            jnp.int32(L), jnp.asarray(bts[b]))
        prefill_program(tm, tk, torch.from_numpy(toks).long(), L,
                        torch.from_numpy(bts[b]).long())
    span = rng.randint(0, VOCAB, (3, 5)).astype(np.int32)
    start = np.array([11, 6, -1], np.int32)    # lane 2 idle
    n_valid = np.array([5, 3, 0], np.int32)
    k_pool, v_pool, jlog, jg = jax_spec_verify(
        jm, state, jk.k_pool, jk.v_pool, jnp.asarray(span),
        jnp.asarray(start), jnp.asarray(n_valid), jnp.asarray(bts))
    tlog, tg = spec_verify_program(
        tm, tk, torch.from_numpy(span).long(),
        torch.from_numpy(start).long(), torch.from_numpy(n_valid).long(),
        torch.from_numpy(bts).long())
    assert tlog.shape == (3, 5, VOCAB) and tlog.dtype == torch.float32
    for b, nv in enumerate(n_valid):
        np.testing.assert_allclose(tlog[b, :nv].numpy(),
                                   np.asarray(jlog)[b, :nv], atol=ATOL)
        np.testing.assert_array_equal(tg[b, :nv].numpy(),
                                      np.asarray(jg)[b, :nv])
    np.testing.assert_allclose(tk.k_pool.numpy(), np.asarray(k_pool),
                               atol=ATOL)
    np.testing.assert_allclose(tk.v_pool.numpy(), np.asarray(v_pool),
                               atol=ATOL)


@pytest.mark.parametrize("seed", range(4))
def test_ngram_propose_matches_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(50):
        hist = rng.randint(0, 1 + seed * 3, rng.randint(1, 40))
        for k in (0, 1, 3, 4):
            for n in (1, 3):
                got = ngram_propose(hist, k, n)
                want = jax_ngram_propose(hist, k, n)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


def test_scheduler_chunk_state_matches_jax():
    """``requeue_front`` resets the chunk cursor (and folds the tokens),
    and ``pick_victim`` prefers mid-chunk prompts, youngest first, past
    those owning no unique page, as the JAX scheduler does."""
    from chainermn_tpu_torch.serving import EvictionStalledError
    out = []
    for sched_cls, req_cls in ((RequestScheduler, Request),
                               (JaxScheduler, JaxRequest)):
        sched = sched_cls()
        reqs = [req_cls(np.arange(1, 6), max_new_tokens=4, request_id=i)
                for i in range(4)]
        reqs[0]._chunk_pos = 16
        reqs[0].tokens = [7, 8]
        sched.requeue_front(reqs[0])
        alloc = BlockAllocator(16, 4)
        for r in reqs[:3]:
            alloc.ensure(r.request_id, 9)            # three pages each
        alloc.share(3, alloc.block_table(2)[:1])    # 3 owns nothing alone
        running, prefilling = reqs[:2], reqs[2:]
        pick = sched_cls.pick_victim
        picks = [pick(running, alloc, prefilling=prefilling).request_id,
                 pick(running, None, prefilling=prefilling).request_id,
                 pick(running, alloc, prefilling=[]).request_id,
                 pick([], None, prefilling=None)]
        with pytest.raises(Exception) as stalled:
            pick([], alloc, prefilling=[reqs[3]])
        out.append((reqs[0]._chunk_pos, [int(t) for t in reqs[0].prompt],
                    reqs[0].max_new_tokens, reqs[0].preemptions,
                    sched.next_admission().request_id, picks,
                    type(stalled.value).__name__, str(stalled.value)))
    assert out[0] == out[1]
    assert out[0][:6] == (0, [1, 2, 3, 4, 5, 7, 8], 2, 1, 0, [2, 3, 1, None])
    assert out[0][6] == EvictionStalledError.__name__


def test_chunk_stride_churn_matches_jax():
    """The chunk-stride churn of the JAX allocator suite, on the port's
    allocator and the JAX one in step: admissions growing in page-multiple
    chunk strides, mid-chunk evictions and restarts from chunk 0 give the
    same block tables, and the pool is conserved at every op."""
    from chainermn_tpu.serving import BlockAllocator as JaxAllocator
    from chainermn_tpu_torch.serving import PagePoolExhaustedError
    from chainermn_tpu.serving import PagePoolExhaustedError as JaxPoolError
    rng = np.random.RandomState(20)
    a, b = BlockAllocator(32, 4), JaxAllocator(32, 4)
    chunk = 8                                  # 2 pages a stride
    live = {}                                  # sid -> covered positions

    def both(fn):
        """``fn`` on both allocators: True when both fit, False when the
        pool is dry on both."""
        outs = []
        for alloc, err in ((a, PagePoolExhaustedError),
                           (b, JaxPoolError)):
            try:
                fn(alloc)
                outs.append(True)
            except err:
                outs.append(False)
        assert outs[0] == outs[1]
        return outs[0]

    for step in range(400):
        op = rng.randint(4)
        if op == 0 and len(live) < 6:          # admit: first chunk
            sid = f"c{step}"
            if both(lambda al: al.ensure(sid, chunk)):
                live[sid] = chunk
        elif op == 1 and live:                 # advance one chunk
            sid = rng.choice(sorted(live))
            if both(lambda al: al.ensure(sid, live[sid] + chunk)):
                live[sid] += chunk
            else:                              # the mid-chunk eviction
                both(lambda al: al.free(sid))
                del live[sid]
        elif op in (2, 3) and live:            # evict; 3 restarts at 0
            sid = rng.choice(sorted(live))
            both(lambda al: al.free(sid))
            del live[sid]
            if op == 3 and both(lambda al: al.ensure(sid, chunk)):
                live[sid] = chunk
        assert a.check() and b.check()
        assert a.used_pages == b.used_pages \
            == sum(a.pages_for(n) for n in live.values())
        assert {s: a.block_table(s) for s in live} \
            == {s: b.block_table(s) for s in live}
    for sid in list(live):
        both(lambda al: al.free(sid))
    assert a.free_pages == b.free_pages == 32
