"""The port's disaggregated prefill and tensor-parallel decode against the
JAX package's (twins of ``tests/serving_tests/test_prefix_sharing.py:
269-380``).

Weights: the JAX ``TransformerLM`` (d 32, 2 heads, 2 layers) saved with
the JAX ``save_npz`` and read by the port's ``load_npz``; fp32 pages of 8
on the CPU.  Disaggregation: the staggered chat load (a provider and two
borrowers sharing a 20-token system prompt) through both engines with
``disagg=True``: tokens equal to the port's own disagg-off run and to the
JAX engine's, ``transfers`` and ``transferred_page_bytes`` equal to the
JAX engine's, the ``CHAINERMN_TPU_SERVE_DISAGG`` hatch both ways; chunked
prefill's disagg branch with two long misses in a row (the second waits
for the one scratch pool), and a short miss arriving while a long one is
between its chunks (it waits too); a draft model under disaggregation;
``insert_pages`` against the JAX one.  Tensor parallelism: one spawned
2-rank gloo world for the module (tp=2 over both ranks, and a tp world of
one on each rank over a group of its own) against the port's tp=1 and the
JAX engine's tp=2 over two of ``tests/conftest.py``'s CPU devices.

Tolerances: tokens and counters exactly; the tp=2 decode logits within
fp32 atol 1e-5 of tp=1 (the JAX test's bound: the two head halves meet in
``proj`` after the gather, so only the summation order of the products
can differ); a tp world of one bitwise (the slice of every head is the
whole tensor, and the gather of one rank a copy).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.serializers import save_npz
from chainermn_tpu.serving import Request as JaxRequest
from chainermn_tpu.serving import ServingEngine as JaxEngine
from chainermn_tpu.serving import kv_cache as jkv
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.serializers import load_npz
from chainermn_tpu_torch.serving import (PagedKVCache, Request,
                                         ServingEngine, insert_pages,
                                         serve_disagg_mode)
from tests.test_torch_communicator import spawn_ranks

VOCAB = 101
KW = dict(n_vocab=VOCAB, d_model=32, n_heads=2, n_layers=2, max_len=128)
ATOL = 1e-5
DISAGG_COUNTERS = ("transfers", "transferred_page_bytes", "chunk_prefills",
                   "chunked_admissions", "evictions", "prefix_hits",
                   "admissions")


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """The JAX model's weights, for the port (and the spawned ranks)."""
    f = str(tmp_path_factory.mktemp("disagg_tp") / "lm.npz")
    save_npz(f, JaxLM(seed=0, **KW))
    return f


def _port_model(npz_file, seed=0):
    return load_npz(npz_file, TransformerLM(seed=seed, device="cpu", **KW))


def _chat_prompts(rng, shared_len=20, tails=(0, 9, 3)):
    """The JAX suite's provider and borrowers: a 20-token system prompt
    (2 full pages and a partial one at page size 8), the provider's
    prompt the system prompt alone."""
    base = rng.randint(0, VOCAB, shared_len).astype(np.int32)
    return [np.concatenate([base, rng.randint(0, VOCAB, n)
                            .astype(np.int32)]) for n in tails]


def _run(engine_cls, request_cls, model, prompts, max_new=6, stagger=False,
         **kw):
    """The JAX suite's ``_run_engine``: ``stagger`` lets the provider
    decode alone for two steps before the borrowers join.  Returns the
    engine and each request's prompt and tokens."""
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_context", 64)
    if engine_cls is JaxEngine:
        kw["page_dtype"] = jnp.float32
    else:
        kw.update(page_dtype=torch.float32, device="cpu")
    eng = engine_cls(model, **kw)
    reqs = [request_cls(p, max_new_tokens=max_new, request_id=i)
            for i, p in enumerate(prompts)]
    if stagger:
        eng.submit(reqs[0])
        eng.step(now=0.0)
        eng.step(now=0.0)
        reqs = reqs[1:]
    for r in reqs:
        eng.submit(r)
    eng.drain(now=0.0)
    assert not eng.running and not eng.prefilling
    # an eviction folds a request's tokens into its prompt: compare whole
    # sequences
    seqs = {r.request_id: [int(t) for t in r.prompt] + list(r.tokens)
            for r in eng.completed}
    return eng, [seqs[k] for k in sorted(seqs)]


def _counters(eng):
    return {k: getattr(eng, k) for k in DISAGG_COUNTERS}


# -- disaggregated prefill ------------------------------------------------


def test_disagg_equals_hatch_and_jax(npz, monkeypatch):
    """``test_disagg_trajectory_equals_single_mesh_hatch``'s twin: the
    disagg-on trajectory equals disagg-off, and the JAX engine's; the
    misses ship (the hits run on the decode pool), metered as the JAX
    engine meters them; the env hatch ``off`` wins over the constructor
    and ``on`` turns the split on."""
    model = _port_model(npz)
    prompts = _chat_prompts(np.random.RandomState(6))
    e_off, t_off = _run(ServingEngine, Request, model, prompts, stagger=True,
                        disagg=False)
    e_on, t_on = _run(ServingEngine, Request, model, prompts, stagger=True,
                      disagg=True)
    je, jt = _run(JaxEngine, JaxRequest, JaxLM(seed=0, **KW), prompts,
                  stagger=True, disagg=True)
    assert e_on.disagg and not e_off.disagg and je.disagg
    assert t_on == t_off == jt
    assert _counters(e_on) == _counters(je)
    # the provider misses and ships; both borrowers hit
    assert e_on.transfers == 1 and e_on.prefix_hits == 2
    assert e_on.transferred_page_bytes == je.transferred_page_bytes > 0
    assert e_off.transfers == e_off.transferred_page_bytes == 0
    assert e_on.full_prefills == e_off.full_prefills == 1
    assert e_on.allocator.check() and e_on.allocator.used_pages == 0
    monkeypatch.setenv("CHAINERMN_TPU_SERVE_DISAGG", "off")
    assert not serve_disagg_mode(True)
    e_hatch, t_hatch = _run(ServingEngine, Request, model, prompts,
                            stagger=True, disagg=True)
    assert not e_hatch.disagg and e_hatch.transferred_page_bytes == 0
    assert t_hatch == t_off
    for env in ("on", "1"):
        monkeypatch.setenv("CHAINERMN_TPU_SERVE_DISAGG", env)
        assert ServingEngine(model, num_pages=16, page_size=8, max_batch=2,
                             max_context=32, device="cpu").disagg
    assert not ServingEngine(model, num_pages=16, page_size=8, max_batch=2,
                             max_context=32, disagg=False,
                             device="cpu").disagg


def test_disagg_distinct_prompts_ship_every_miss(npz):
    """No prefix sharing: every admission is a miss and ships a block of
    the bucketed page count (a 13-token prompt, 2 pages, ships 2; a
    17-token one, 3 pages, ships 4), as the JAX engine counts them."""
    model = _port_model(npz)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, VOCAB, n).astype(np.int32)
               for n in (5, 13, 8, 17, 3)]
    _, t_off = _run(ServingEngine, Request, model, prompts, disagg=False)
    te, tt = _run(ServingEngine, Request, model, prompts, disagg=True)
    je, jt = _run(JaxEngine, JaxRequest, JaxLM(seed=0, **KW), prompts,
                  disagg=True)
    assert tt == t_off == jt
    assert _counters(te) == _counters(je)
    page = te.kv.page_bytes * te.kv.n_layers
    assert te.transfers == 5
    assert te.transferred_page_bytes == (1 + 2 + 1 + 4 + 1) * page


def test_disagg_chunked_misses_defer_like_jax(npz):
    """Chunked prefill's disagg branch: two long prefix misses in a row.
    The first streams its chunks into the scratch pool; the second waits
    at admission until the first has shipped (one mid-chunk miss in
    flight), then streams its own.  Tokens and counters equal the JAX
    engine's with the same options, and the port's unchunked,
    undisaggregated run."""
    model = _port_model(npz)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, VOCAB, n).astype(np.int32)
               for n in (40, 37, 6)]
    kw = dict(chunk_tokens=16, disagg=True, prefix_cache=False,
              max_context=64)
    _, t_van = _run(ServingEngine, Request, model, prompts, max_new=8,
                    prefix_cache=False)
    te, tt = _run(ServingEngine, Request, model, prompts, max_new=8, **kw)
    je, jt = _run(JaxEngine, JaxRequest, JaxLM(seed=0, **KW), prompts,
                  max_new=8, **kw)
    assert tt == jt == t_van
    assert _counters(te) == _counters(je)
    assert te.chunked_admissions == 2 and te.chunk_prefills == 6
    # both chunked misses and the short prompt ship once each
    assert te.transfers == 3
    assert te.deferred_admissions > 0
    assert te.allocator.check() and te.allocator.used_pages == 0


def test_disagg_one_shot_miss_waits_for_a_stream_in_flight(npz):
    """A short prefix miss that arrives while a long miss is between its
    chunks waits until the stream has shipped: a one-shot prefill on the
    one scratch pool would overwrite the stream's written pages (scratch
    page 0 on), and the stream's later chunks and its ship would carry
    the short prompt's K/V.  Both prompts' tokens equal the disagg-off
    run with the same arrivals (the JAX engine admits the short miss at
    once, a by-design difference)."""
    model = _port_model(npz)
    rng = np.random.RandomState(13)
    long_p, short_p = (rng.randint(0, VOCAB, n).astype(np.int32)
                       for n in (40, 6))

    def run(disagg):
        eng = ServingEngine(model, num_pages=64, page_size=8, max_batch=4,
                            max_context=64, page_dtype=torch.float32,
                            device="cpu", prefix_cache=False,
                            chunk_tokens=16, disagg=disagg)
        eng.submit(Request(long_p, max_new_tokens=8, request_id=0))
        eng.step(now=0.0)          # the long miss's first chunk
        assert eng.prefilling and eng.prefilling[0]._chunk_pos == 16
        eng.submit(Request(short_p, max_new_tokens=8, request_id=1))
        eng.drain(now=0.0)
        assert eng.allocator.check() and eng.allocator.used_pages == 0
        return eng, {r.request_id: list(r.tokens) for r in eng.completed}

    e_off, t_off = run(False)
    e_on, t_on = run(True)
    assert t_on == t_off and len(t_on) == 2
    assert e_on.deferred_admissions > 0 and e_off.deferred_admissions == 0
    # the stream ships once after its last chunk, the short miss once
    assert e_on.transfers == 2 and e_on.chunk_prefills == 3


def test_disagg_chunked_under_eviction_like_jax(npz):
    """The same load in a pool too small for it: mid-chunk misses are
    evicted and re-admitted from chunk 0, and the counters
    (``evictions`` among them) still equal the JAX engine's."""
    model = _port_model(npz)
    rng = np.random.RandomState(12)
    prompts = [rng.randint(0, VOCAB, n).astype(np.int32)
               for n in (40, 37, 30)]
    kw = dict(chunk_tokens=16, disagg=True, num_pages=9, max_context=56)
    te, tt = _run(ServingEngine, Request, model, prompts, max_new=12, **kw)
    je, jt = _run(JaxEngine, JaxRequest, JaxLM(seed=0, **KW), prompts,
                  max_new=12, **kw)
    _, t_van = _run(ServingEngine, Request, model, prompts, max_new=12,
                    num_pages=64, max_context=56)
    assert tt == jt == t_van
    assert _counters(te) == _counters(je)
    assert te.evictions > 0 and te.transfers >= 3


def test_disagg_with_a_draft_model_equals_vanilla(npz):
    """Speculation with a draft model under disaggregation: the draft's
    prefill stays on the decode pool (its pages are the target's block
    tables), and the tokens are the vanilla run's."""
    model = _port_model(npz)
    draft = TransformerLM(seed=1, device="cpu", **KW)
    prompts = _chat_prompts(np.random.RandomState(7))
    _, t_van = _run(ServingEngine, Request, model, prompts, max_new=8)
    te, tt = _run(ServingEngine, Request, model, prompts, max_new=8,
                  disagg=True, spec_k=3, draft_model=draft)
    assert tt == t_van
    assert te.spec_steps > 0 and te.draft_dispatches > 0
    assert te.transfers == 1


def test_insert_pages_matches_jax_and_pads_onto_the_trash_page():
    """``insert_pages`` against the JAX one: the real pages equal the JAX
    pool's, and the padding rows (id ``P``) reach only the trash page."""
    L, P, S, H, D = 2, 6, 4, 2, 8
    rng = np.random.RandomState(0)
    pool = rng.normal(0, 1, (L, P, S, H, D)).astype(np.float32)
    block = rng.normal(0, 1, (L, 4, S, H, D)).astype(np.float32)
    rows = np.array([3, 0, P, P], np.int32)
    ref = np.asarray(jkv.insert_pages(jnp.asarray(pool), jnp.asarray(block),
                                      jnp.asarray(rows)))
    cache = PagedKVCache(L, P, S, H, D, dtype=torch.float32, device="cpu")
    cache.k_pool.copy_(torch.from_numpy(pool))
    insert_pages(cache.k_store, torch.from_numpy(block),
                 torch.from_numpy(rows).long())
    np.testing.assert_array_equal(cache.k_pool.numpy(), ref)
    trash = cache.k_store[:, P].numpy()
    assert any(np.array_equal(trash, block[:, j]) for j in (2, 3))


# -- tensor parallelism: one 2-rank gloo world ------------------------------


def _tp_prompts():
    return _chat_prompts(np.random.RandomState(8))


def _tp_worker(rank, npz_file, draft_npz):
    """Every tp run on this rank: tp=1 without a communicator (the
    reference), tp=2 over the world (plain, chunked, speculative with a
    draft model, disaggregated), a tp world of one over a group of this
    rank alone, and the program-level decode logits at each."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.communicators import MeshCommunicator
    from chainermn_tpu_torch.serving import decode_program, prefill_program
    model = _port_model(npz_file)
    draft = _port_model(draft_npz, seed=1)
    prompts = _tp_prompts()
    tp2 = create_communicator("naive", device="cpu")
    # each rank's group of one (new_group is collective over the world)
    ones = [dist.new_group([r]) for r in range(2)]
    tp1 = MeshCommunicator(device="cpu", group=ones[rank])
    out = {"rank": tp2.rank}

    def run(name, comm=None, tp=1, **kw):
        before = dict(comm.calls) if comm is not None else {}
        eng, toks = _run(ServingEngine, Request, model, prompts, tp=tp,
                         tp_comm=comm, **kw)
        calls = {k: comm.calls[k] - before.get(k, 0)
                 for k in ("allgather", "bcast")} if comm else {}
        out[name] = {"tokens": toks, "calls": calls,
                     "decode_steps": eng.decode_steps,
                     "admissions": eng.admissions,
                     "kv_heads": eng.kv.n_heads,
                     "pool_ok": eng.allocator.check()
                     and eng.allocator.used_pages == 0,
                     **_counters(eng)}

    run("tp1")
    run("tp2", tp2, tp=2)
    run("tp2_chunks", tp2, tp=2, chunk_tokens=8)
    run("tp2_spec", tp2, tp=2, spec_k=2)
    run("tp2_spec_draft", tp2, tp=2, spec_k=2, draft_model=draft)
    run("tp2_disagg", tp2, tp=2, disagg=True)
    run("tp2_disagg_chunks", tp2, tp=2, disagg=True, chunk_tokens=8)
    run("tp1_disagg", disagg=True)
    run("world_of_one", tp1, tp=1)

    # program level (the JAX test's :350-372): prefill 11 tokens, then one
    # decode step, with the pools of every head, of this rank's half
    # (tp=2) and of every head over a group of one
    rng = np.random.RandomState(9)
    prompt = rng.randint(0, VOCAB, 11)
    toks = torch.zeros((1, 16), dtype=torch.long)
    toks[0, :11] = torch.from_numpy(prompt)
    bt = torch.arange(8)
    logits = {}
    for name, comm, heads in (("tp1", None, 2), ("tp2", tp2, 1),
                              ("world_of_one", tp1, 2)):
        kv = PagedKVCache(2, 16, 8, heads, 16, dtype=torch.float32,
                          device="cpu")
        first = prefill_program(model, kv, toks, 11, bt, tp_comm=comm)
        lg, _ = decode_program(model, kv, torch.tensor([int(prompt[-1])]),
                               torch.tensor([11]), bt[None], mode="paged",
                               tp_comm=comm)
        logits[name] = (first, lg)
    out["logits"] = logits
    tp1.finalize()
    return out


@pytest.fixture(scope="module")
def tp_runs(npz, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_world")
    draft_npz = str(tmp / "draft.npz")
    save_npz(draft_npz, JaxLM(seed=1, **KW))
    ranks = spawn_ranks(tmp, _tp_worker, world=2, npz_file=npz,
                        draft_npz=draft_npz)
    jax2, jt2 = _run(JaxEngine, JaxRequest, JaxLM(seed=0, **KW),
                     _tp_prompts(), tp=2)
    jax1, _ = _run(JaxEngine, JaxRequest, JaxLM(seed=0, **KW),
                   _tp_prompts(), disagg=True)
    return ranks, jt2, jax1


def test_tp2_trajectory_equals_tp1_and_jax_tp2(tp_runs):
    """``test_tp_decode_matches_single_chip``'s engine half: tp=2 over two
    ranks holds half the heads a rank and emits the tp=1 tokens, which
    are the JAX tp=2 engine's; both ranks hold the same streams."""
    ranks, jax_tp2, _ = tp_runs
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["tp2"]["tokens"] == r["tp1"]["tokens"] == jax_tp2
        assert r["tp2"]["kv_heads"] == 1 and r["tp1"]["kv_heads"] == 2
        assert r["tp2"]["pool_ok"]


def test_tp2_gathers_once_a_layer_and_broadcasts_once_a_dispatch(tp_runs):
    """Per layer of each dispatch one all-gather of the attention output;
    one broadcast of the tokens per decode dispatch and per admission."""
    for r in tp_runs[0]:
        run = r["tp2"]
        # an admission is one prefill dispatch, full or suffix
        dispatches = run["decode_steps"] + run["admissions"]
        assert run["calls"]["allgather"] == KW["n_layers"] * dispatches
        assert run["calls"]["bcast"] == run["decode_steps"] \
            + run["admissions"]


@pytest.mark.parametrize("run", ["tp2_chunks", "tp2_spec", "tp2_spec_draft",
                                 "tp2_disagg", "tp2_disagg_chunks"])
def test_tp2_composes_with_each_option(tp_runs, run):
    """tp=2 with chunked prefill, speculation (n-gram and a draft model
    whose pools stay whole) and disaggregation (each rank ships its own
    heads' pages) gives the tp=1 tokens on both ranks."""
    ranks = tp_runs[0]
    for r in ranks:
        assert r[run]["tokens"] == r["tp1"]["tokens"], run
        assert r[run]["pool_ok"]
    assert ranks[0][run]["tokens"] == ranks[1][run]["tokens"]


def test_tp2_disagg_ships_each_ranks_shard(tp_runs):
    """Under disagg x tp each rank ships the pages of its own heads: the
    ranks' ``transferred_page_bytes`` sum to the JAX engine's count (and
    to the port's tp=1 count), and each rank ships as often."""
    ranks, _, jax_disagg = tp_runs
    shipped = [r["tp2_disagg"]["transferred_page_bytes"] for r in ranks]
    assert shipped[0] == shipped[1]
    assert sum(shipped) == jax_disagg.transferred_page_bytes \
        == ranks[0]["tp1_disagg"]["transferred_page_bytes"] > 0
    assert all(r["tp2_disagg"]["transfers"] == jax_disagg.transfers
               for r in ranks)


def test_tp2_decode_logits_within_fp32_of_tp1(tp_runs):
    """The program-level twin (the JAX test's :350-372): the prefill's and
    one decode step's logits at tp=2 within fp32 atol 1e-5 of tp=1."""
    for r in tp_runs[0]:
        for got, want in zip(r["logits"]["tp2"], r["logits"]["tp1"]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                       rtol=0)


def test_tp_world_of_one_is_bitwise_the_engine_without_tp(tp_runs):
    """tp=1 over a communicator of one runs the slice, the gather and the
    broadcast at a group of one: the logits bitwise, the tokens equal."""
    for r in tp_runs[0]:
        assert r["world_of_one"]["tokens"] == r["tp1"]["tokens"]
        assert r["world_of_one"]["calls"]["allgather"] > 0
        for got, want in zip(r["logits"]["world_of_one"],
                             r["logits"]["tp1"]):
            assert torch.equal(got, want)
