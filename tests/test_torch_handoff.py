"""The port's prefill/decode handoff (models/paging's export/adopt layer,
serve_loop(prefill_only=True) and serve_loop(adopt=[...])) against the
JAX package's on the CPU, at tiny f32 widths.

Tolerance: exact.  Block hashes, elided payloads, adoption ids and stats
equal the JAX package's over identical pools; greedy tokens across the
handoff equal the unified loop's, and both equal JAX's unified tokens;
each handoff's fields equal JAX's.  The handoff crosses between the
frameworks in both directions through numpy (`_to_jax`, `_to_port`): the
block table and the blake2b hashes are the wire format.  The cases
mirror tests/test_zdisagg.py.

One deliberate difference (ROADMAP Queue 3): the port's adopt_blocks
resolves every block before it allocates, so a refused adoption leaves
the pool and the registry as they were; JAX's has allocated the blocks
before the one it refuses.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_serving_util import (int8_models, one_torch_thread, pool_pair,
                                      prompts, tiny_models)
from tests.torch_serving_util import handoff_to_jax as _to_jax
from tests.torch_serving_util import handoff_to_port as _to_port
from tests.torch_serving_util import row_to_jax as _row_to_jax
from tf_operator_tpu.models import paging as jp
from tf_operator_tpu.models.serving import serve_loop as jax_serve
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import paging as tp
from tf_operator_tpu_torch.models.serving import KVHandoff, serve_loop


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tiny tensors run on one torch thread (the JAX side
    keeps its own pool)."""
    with one_torch_thread():
        yield

KW = dict(slots=2, max_new_tokens=10, block_size=4)


@pytest.fixture(scope="module")
def setup():
    return tiny_models()


def _schedule(results):
    return [(r.tokens, r.admitted_at_step, r.finished_at_step, r.slot,
             r.kv_blocks) for r in results]


def _fields(hand):
    """What a handoff holds besides its bytes (the two frameworks' KV
    agree in tokens, not in every bit, so their hashes differ)."""
    return [(h.prompt_len, h.budget, h.first_token, h.completed, h.prefix_len,
             None if h.export is None else
             (len(h.export), h.export.payload_blocks(), h.export.shared,
              h.export.nbytes()))
            for h in hand]


# --------------------------------------------------------- wire primitives
def _three_exports(mod, cache):
    """tests/test_zdisagg.py:196's senders: one lane of 4 blocks (2
    shared) exported three times with one sent_hashes set; block 3
    repeats block 2's bytes, so its payload also rides once."""
    ids = [1, 2, 3, 3]
    sent: set = set()
    return [mod.export_blocks(cache, ids, [True, True, False, False], 4,
                              sent_hashes=sent) for _ in range(3)]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_export_hashes_and_elisions_match_jax(kind):
    jcache, tcache = pool_pair(kind)
    jexp, texp = _three_exports(jp, jcache), _three_exports(tp, tcache)
    for j, t in zip(jexp, texp):
        assert t.hashes == j.hashes
        assert t.shared == j.shared
        assert list(t.payload) == list(j.payload)
        assert (len(t), t.payload_blocks(), t.nbytes()) == \
            (len(j), j.payload_blocks(), j.nbytes())
        for h in t.payload:
            got = jax.tree.leaves(_row_to_jax(t.payload[h]))
            want = jax.tree.leaves(j.payload[h])
            assert [np.asarray(a).tobytes() for a in got] == \
                [np.asarray(a).tobytes() for a in want]
    # the later exports elide the shared prefix's payload
    assert [t.payload_blocks() for t in texp] == [3, 1, 1]
    with pytest.raises(ValueError, match="length mismatch"):
        tp.export_blocks(tcache, [1, 2], [True], 4)


def test_adoption_sequence_matches_jax_and_restores_the_free_list():
    """tests/test_zdisagg.py:196: three adoptions (a fresh one, then two
    dedup hits on the shared blocks) give JAX's costs, ids and stats and
    the exported bytes; every lane's release restores the free list
    exactly and empties the registry."""
    jcache, tcache = pool_pair("f32")
    jexp, texp = _three_exports(jp, jcache), _three_exports(tp, tcache)
    jdst_c, tdst_c = pool_pair("f32", n=16, seed=1)
    jpool, tpool = jp.BlockPool(16, 4), tp.BlockPool(16, 4)
    jreg, treg = jp.HandoffRegistry(jpool), tp.HandoffRegistry(tpool)
    lanes = []
    for je, te in zip(jexp, texp):
        assert tp.adoption_cost(te, treg) == jp.adoption_cost(je, jreg)
        jdst_c, *jout = jp.adopt_blocks(jdst_c, jpool, je, jreg)
        tdst_c, *tout = tp.adopt_blocks(tdst_c, tpool, te, treg)
        assert tout == jout
        lanes.append(tout[1:3])
    for j, t in zip(jax.tree.leaves(jdst_c), tp._leaves(tdst_c)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert lanes[0][0] == lanes[1][0] == lanes[2][0]
    np.testing.assert_array_equal(tdst_c[0][0][lanes[1][1][0]].numpy(),
                                  tcache[0][0][3].numpy())
    for sh_ids, own_ids in lanes:
        treg.release(sh_ids)
        tpool.decref(own_ids)
    assert tpool.used == 0
    assert sorted(tpool._free) == list(range(1, 17))
    assert treg._id_of == {} and treg._hash_of == {}
    assert treg.dedup_hits == jreg.dedup_hits == 4


def _state(pool, reg):
    return (list(pool._free), list(pool._ref), dict(reg._id_of),
            dict(reg._hash_of), reg.dedup_hits)


def test_handoff_error_leaves_pool_and_registry_unchanged():
    """Block-size mismatch, and an elided shared payload whose hash the
    receiver never saw, raise HandoffError before anything changes.  The
    refused export's first block has its payload: JAX has allocated it
    when it raises at the second; the port has not."""
    jcache, tcache = pool_pair("f32")
    sent_j, sent_t = set(), set()
    for sent, mod, cache in ((sent_j, jp, jcache), (sent_t, tp, tcache)):
        mod.export_blocks(cache, [2], [True], 4, sent_hashes=sent)
    jel = jp.export_blocks(jcache, [1, 2], [False, True], 4,
                           sent_hashes=sent_j)
    tel = tp.export_blocks(tcache, [1, 2], [False, True], 4,
                           sent_hashes=sent_t)
    assert tel.payload_blocks() == jel.payload_blocks() == 1
    tdst = pool_pair("f32", seed=2)[1]
    tpool = tp.BlockPool(8, 4)
    treg = tp.HandoffRegistry(tpool)
    # some state first: one lane adopted and held
    full = tp.export_blocks(tcache, [3, 4], [True, False], 4)
    tp.adopt_blocks(tdst, tpool, full, treg)
    before = _state(tpool, treg)
    with pytest.raises(tp.HandoffError, match="resend"):
        tp.adopt_blocks(tdst, tpool, tel, treg)
    assert _state(tpool, treg) == before
    with pytest.raises(tp.HandoffError, match="block size"):
        tp.adopt_blocks(tdst, tp.BlockPool(8, 8), tel, None)
    mismatch = tp.BlockPool(8, 8)
    with pytest.raises(tp.HandoffError, match="block size"):
        tp.adopt_blocks(tdst, mismatch, full, tp.HandoffRegistry(mismatch))
    assert mismatch.used == 0
    # the JAX package raises the same error after allocating block 0
    jpool = jp.BlockPool(8, 4)
    with pytest.raises(jp.HandoffError, match="resend"):
        jp.adopt_blocks(pool_pair("f32", seed=2)[0], jpool, jel,
                        jp.HandoffRegistry(jpool))
    assert jpool.used == 1


# ------------------------------------------------------------ parity matrix
def _split(tmodel, reqs, adopt_kw=None, **kw):
    """The port's unified tokens, its prefill_only -> adopt tokens and
    the handoffs."""
    unified = serve_loop(tmodel, reqs, device="cpu", **kw)
    hand = serve_loop(tmodel, reqs, device="cpu", prefill_only=True, **kw)
    out = serve_loop(tmodel, reqs, device="cpu", adopt=hand,
                     **{**kw, **(adopt_kw or {})})
    return [r.tokens for r in unified], [r.tokens for r in out], hand


@pytest.mark.parametrize("case", ["plain", "int8_kv", "continuous_decode"])
def test_handoff_parity_matches_jax(setup, case):
    jmodel, params, tmodel = setup
    kw, jkw, adopt_kw = dict(KW), {}, None
    if case == "int8_kv":
        params, tmodel, jkw = int8_models(params)
        kw["kv_quant"] = True
    if case == "continuous_decode":
        adopt_kw = dict(scheduler="continuous")
    ps = prompts([6, 11, 3, 9], seed=1)
    uni, split, hand = _split(tmodel, ps, adopt_kw=adopt_kw, **kw)
    jps = [jnp.asarray(p) for p in ps]
    want = jax_serve(jmodel, params, jps, paged=True, paged_kernel="gather",
                     **jkw, **kw)
    jhand, jstats = jax_serve(jmodel, params, jps, paged=True,
                              paged_kernel="gather", prefill_only=True,
                              return_stats=True, **jkw, **kw)
    assert uni == split == [r.tokens for r in want]
    assert _fields(hand) == _fields(jhand)
    _, stats = serve_loop(tmodel, ps, device="cpu", adopt=hand,
                          return_stats=True, **{**kw, **(adopt_kw or {})})
    assert stats.handoff_adoptions == jstats.handoff_exports == sum(
        1 for h in hand if not h.completed)


@pytest.mark.parametrize("scheduler", ["slot", "continuous"])
def test_shared_prefix_handoff_dedups_the_wire(setup, scheduler):
    """tests/test_zdisagg.py:93: the prefill side serves suffixes over an
    unaligned prefix; the decode side takes the full prompts.  The prefix
    crosses the wire once (later exports elide it) and the receiver's
    registry resolves the elided blocks; tokens equal the unified
    prefix run's and JAX's."""
    jmodel, params, tmodel = setup
    pfx = prompts([10], seed=3)[0]
    sufs = prompts([5, 9, 3], seed=4)
    full = [np.concatenate([pfx, s]) for s in sufs]
    uni = serve_loop(tmodel, sufs, shared_prefix=pfx, device="cpu", **KW)
    hand, hstats = serve_loop(tmodel, sufs, shared_prefix=pfx, device="cpu",
                              prefill_only=True, return_stats=True, **KW)
    out, stats = serve_loop(tmodel, full, device="cpu", adopt=hand,
                            return_stats=True, scheduler=scheduler, **KW)
    want = jax_serve(jmodel, params, [jnp.asarray(s) for s in sufs],
                     paged=True, paged_kernel="gather",
                     shared_prefix=jnp.asarray(pfx), **KW)
    assert [r.tokens for r in uni] == [r.tokens for r in out] == \
        [r.tokens for r in want]
    payloads = [h.export.payload_blocks() for h in hand]
    blocks = [len(h.export) for h in hand]
    # 10 // 4 = 2 whole prefix blocks ship with the first export only
    assert blocks == [4, 5, 4]
    assert payloads == [4, 5 - 2, 4 - 2]
    assert hstats.cow_copies == 3 and hstats.handoff_exports == 3
    # the second lane's adoption finds the first's prefix blocks (the
    # third comes after both have finished, and adopts them afresh from
    # the batch's union of payloads)
    assert stats.prefix_block_hits == 2
    assert stats.handoff_adoptions == 3
    assert all(h.prefix_len == 10 and h.prompt_len == 10 + len(s)
               for h, s in zip(hand, sufs))


def test_preempted_adopted_lanes_adopt_again_as_jax(setup, monkeypatch):
    """The continuous decode side in a pool of 12: growing the adopted
    lanes preempts some, each is adopted again on readmission (its
    prefix blocks may have been freed meanwhile, so it resolves against
    the union of the batch's payloads), and the tokens, schedule and
    counters equal JAX's serve_loop(adopt=..., scheduler="continuous",
    pool_blocks=12) and the unified prefix run's tokens.  At the end the
    pool holds no block and the registry no hash."""
    jmodel, params, tmodel = setup
    pfx = prompts([10], seed=3)[0]
    sufs = prompts([5, 9, 3, 7], seed=4)
    full = [np.concatenate([pfx, s]) for s in sufs]
    kw = dict(slots=3, block_size=4, max_new_tokens=[14, 16, 12, 15])
    uni = serve_loop(tmodel, sufs, shared_prefix=pfx, device="cpu", **kw)
    hand = serve_loop(tmodel, sufs, shared_prefix=pfx, device="cpu",
                      prefill_only=True, **kw)
    registries = []

    class Recorded(tp.HandoffRegistry):
        def __init__(self, pool):
            super().__init__(pool)
            registries.append(self)

    monkeypatch.setattr(tp, "HandoffRegistry", Recorded)
    dkw = dict(kw, adopt=hand, scheduler="continuous", pool_blocks=12,
               return_stats=True)
    got, stats = serve_loop(tmodel, full, device="cpu", **dkw)
    want, jstats = jax_serve(jmodel, params, [jnp.asarray(f) for f in full],
                             paged=True, paged_kernel="gather",
                             **dict(dkw, adopt=[_to_jax(h) for h in hand]))
    assert [r.tokens for r in got] == [r.tokens for r in uni]
    assert _schedule(got) == _schedule(want)
    for name in ("preemptions", "admissions_blocked_on_memory",
                 "prefix_block_hits", "handoff_adoptions",
                 "kv_blocks_peak_used", "total_tokens"):
        assert getattr(stats, name) == getattr(jstats, name), name
    assert stats.preemptions > 0
    # every preemption is one adoption more
    assert stats.handoff_adoptions == len(hand) + stats.preemptions
    [reg] = registries
    assert reg.pool.used == 0
    assert reg._id_of == {} and reg._hash_of == {}


def test_completed_at_prefill_ship_no_export(setup):
    """A budget of 1, or EOS as the first token: the handoff is completed
    with no export, and the decode side answers it without a lane
    (slot -1), as JAX's does."""
    jmodel, params, tmodel = setup
    ps = prompts([6, 11, 3], seed=1)
    first = serve_loop(tmodel, ps, device="cpu", **KW)
    eos = first[1].tokens[0]
    for kw in (dict(KW, max_new_tokens=[1, 5, 5]), dict(KW, eos_id=eos)):
        hand = serve_loop(tmodel, ps, device="cpu", prefill_only=True, **kw)
        jhand = jax_serve(jmodel, params, [jnp.asarray(p) for p in ps],
                          paged=True, paged_kernel="gather",
                          prefill_only=True, **kw)
        assert _fields(hand) == _fields(jhand)
        done = [i for i, h in enumerate(hand) if h.completed]
        assert done and all(hand[i].export is None for i in done)
        out = serve_loop(tmodel, ps, device="cpu", adopt=hand, **kw)
        uni = serve_loop(tmodel, ps, device="cpu", **kw)
        assert [r.tokens for r in out] == [r.tokens for r in uni]
        assert [out[i].slot for i in done] == [-1] * len(done)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_handoff_crosses_between_frameworks(setup, kv_quant):
    """ROADMAP item 6, Gate 2: JAX's handoffs, through numpy, adopt into
    the port; the port's adopt into JAX's serve_loop(adopt=...); both
    give JAX's unified tokens.  The prefix makes the wire carry elided
    blocks both ways."""
    jmodel, params, tmodel = setup
    jkw = {}
    if kv_quant:
        params, tmodel, jkw = int8_models(params)
    kw = dict(KW, kv_quant=kv_quant)
    pfx = prompts([10], seed=3)[0]
    sufs = prompts([5, 9, 3], seed=4)
    full = [np.concatenate([pfx, s]) for s in sufs]
    jfull = [jnp.asarray(f) for f in full]
    want = [r.tokens for r in jax_serve(jmodel, params, jfull, paged=True,
                                        paged_kernel="gather", **jkw, **kw)]
    jhand = jax_serve(jmodel, params, [jnp.asarray(s) for s in sufs],
                      paged=True, paged_kernel="gather",
                      shared_prefix=jnp.asarray(pfx), prefill_only=True,
                      **jkw, **kw)
    thand = serve_loop(tmodel, sufs, shared_prefix=pfx, device="cpu",
                       prefill_only=True, **kw)
    assert _fields(thand) == _fields(jhand)
    got, stats = serve_loop(tmodel, full, device="cpu",
                            adopt=[_to_port(h) for h in jhand],
                            return_stats=True, **kw)
    back, jstats = jax_serve(jmodel, params, jfull, paged=True,
                             paged_kernel="gather",
                             adopt=[_to_jax(h) for h in thand],
                             return_stats=True, **jkw, **kw)
    assert [r.tokens for r in got] == [r.tokens for r in back] == want
    for name in ("prefix_block_hits", "handoff_adoptions",
                 "admissions_blocked_on_memory", "kv_blocks_peak_used"):
        assert getattr(stats, name) == getattr(jstats, name), name
    assert stats.prefix_block_hits > 0


def test_handoff_validation_matches_jax(setup):
    """tests/test_zdisagg.py:148's refusals with the JAX package's words,
    plus prefill_only under the continuous scheduler, adopt with a shared
    prefix, a prompt_len that does not pair and a handoff with nothing to
    adopt."""
    jmodel, params, tmodel = setup
    ps = prompts([6, 4], seed=1)
    kw = dict(KW, max_new_tokens=4)
    hand = serve_loop(tmodel, ps, device="cpu", prefill_only=True, **kw)
    jhand = [_to_jax(h) for h in hand]
    empty = [KVHandoff(rid=i, prompt_len=len(p), budget=4, first_token=1)
             for i, p in enumerate(ps)]
    cases = [
        (ps, dict(prefill_only=True, adopt=hand), "two ENDS"),
        (ps, dict(prefill_only=True, scheduler="continuous"),
         "prefill_only rides the slot scheduler"),
        (ps, dict(adopt=hand, shared_prefix=[1, 2]), "refuses shared_prefix"),
        (ps[:1], dict(adopt=hand), "adopt has 2 handoffs for 1 requests"),
        (ps, dict(adopt=hand, max_new_tokens=9), "budgets must match"),
        (ps[::-1], dict(adopt=hand), "prompt_len 6 != request length 4"),
        (ps, dict(adopt=empty), "nothing to adopt"),
    ]
    for reqs, extra, match in cases:
        with pytest.raises(ValueError, match=match) as terr:
            serve_loop(tmodel, reqs, device="cpu", **{**kw, **extra})
        if "adopt" in extra and extra["adopt"] is hand:
            extra = dict(extra, adopt=jhand)
        if extra.get("adopt") is empty:
            extra = dict(extra, adopt=[_to_jax(h) for h in empty])
        with pytest.raises(ValueError, match=match) as jerr:
            jax_serve(jmodel, params, [jnp.asarray(p) for p in reqs],
                      paged=True, **{**kw, **extra})
        assert str(terr.value) == str(jerr.value)


def test_windowed_handoffs_refuse_naming_item_3(setup):
    """Sliding-window tables (ROADMAP item 3) now serve, and a handoff
    adopts only into a table of its own kind: a windowed export into a
    linear model, and a linear export into a sliding-window model, raise
    HandoffError before the loop starts; the sliding-window model's
    prefill side ships its ring (export.window)."""
    _, _, tmodel = setup
    ps = prompts([6, 4], seed=1)
    hand = serve_loop(tmodel, ps, device="cpu", prefill_only=True, **KW)
    windowed = [dataclasses.replace(h, export=tp.BlockExport(
        4, h.export.hashes, h.export.shared, h.export.payload,
        window={"ring": 4})) for h in hand]
    with pytest.raises(tp.HandoffError, match="ring of 4 slots"):
        serve_loop(tmodel, ps, device="cpu", adopt=windowed, **KW)
    wcfg = tl.tiny(dtype=torch.float32, max_len=128, sliding_window=8)
    wmodel = tl.Llama.from_params(
        wcfg, bridge.init_params(wcfg, 0, device="cpu"), device="cpu")
    with pytest.raises(tp.HandoffError, match="sender shipped None"):
        serve_loop(wmodel, ps, device="cpu", adopt=hand, **KW)
    whand = serve_loop(wmodel, ps, device="cpu", prefill_only=True, **KW)
    assert [h.export.window["ring"] for h in whand] == [32, 32]
