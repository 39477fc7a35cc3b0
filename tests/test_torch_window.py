"""The port's sliding-window paged serving against the JAX package's on
the CPU, at tiny f32 widths (llama.tiny(sliding_window=16, max_len=256),
block size 4, as tests/test_zpagedkernel.py and tests/test_zcontbatch.py
run it): the window admission math and the ring rotation, the modular
block write, the ring's sizing, serve_loop over a modular table under
both schedulers, and the windowed prefill/decode handoff in both
directions.

Tolerance: exact.  Plans, rotation edits, write indices and written
bytes, ring lengths and refusals equal the JAX package's; greedy tokens,
the schedule and the pool counters (window_evicted_blocks, cow_copies,
prefix_block_hits, kv_blocks_peak_used) equal JAX's paged windowed
serve_loop; a windowed export's `window` dict equals JAX's.  The JAX side
reads through its gather path (the Pallas kernel's plain reference on
the CPU), the port's through paged_attention's plain version.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_serving_util import (handoff_to_jax, handoff_to_port,
                                      int8_models, one_torch_thread, prompts,
                                      schedule, tiny_models)
from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models import paging as jp
from tf_operator_tpu.models import quant as jq
from tf_operator_tpu.models.serving import serve_loop as jax_serve
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import paging as tp
from tf_operator_tpu_torch.models import quant as tq
from tf_operator_tpu_torch.models.serving import serve_loop


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tiny tensors run on one torch thread (the JAX side
    keeps its own pool)."""
    with one_torch_thread():
        yield

STATS = ("window_evicted_blocks", "cow_copies", "prefix_block_hits",
         "kv_blocks_peak_used", "admissions_blocked_on_memory",
         "total_tokens")


@pytest.fixture(scope="module")
def w16():
    """window 16: the ring (128 positions, a 128-multiple) holds far more
    than the window, so a wrap never needs the rotation's copy."""
    return tiny_models(max_len=256, sliding_window=16)


@pytest.fixture(scope="module")
def w16_int8(w16):
    """w16's weights quantized: (int8 params, the port's model over them,
    JAX's serve_loop keywords), shared by the int8 cases."""
    return int8_models(w16[1], max_len=256, sliding_window=16)


@pytest.fixture(scope="module")
def w120():
    """window 120 over the same 128-position ring: a decode block that
    wraps onto a shared slot still sees its positions, so the rotation
    copies the shared block into the shadow first."""
    return tiny_models(max_len=256, sliding_window=120)


# ------------------------------------------------------- host-side math
def test_plan_window_request_matches_jax():
    """Every (prompt, budget, block size, ring, prefix, slack) of a grid
    plans exactly as the JAX package's: slots needed, shared, private,
    CoW and the shadows the ring rotates out."""
    n = 0
    for bs in (1, 4, 16):
        for ring in (1, 3, 8, 288):
            for prompt in (1, 5, 16, 17, 40, 300, 4609):
                for new in (1, 7, 128):
                    for pfx in (0, 1, 4, 16, 33):
                        if pfx > prompt:
                            continue
                        for slack in (0, 7):
                            args = (prompt, new, bs, ring, pfx, slack)
                            assert tp.plan_window_request(*args) == \
                                jp.plan_window_request(*args), args
                            n += 1
    assert n > 1000


@pytest.mark.parametrize("seed", [7, 11])
def test_window_rotation_matches_jax_and_never_leaks(seed):
    """tests/test_zpagedkernel.py:321's seeded churn, driven through the
    port's and the JAX package's WindowRotation in step: every advance
    gives the same edits, releases and evictions, every released shared
    id is decref'd once, the reserved shadows cover every swap, and after
    teardown the free list is the whole pool again."""
    rnd = random.Random(seed)
    bs, ring, window = 4, 8, 16
    for trial in range(30):
        n_pfx = rnd.randint(0, 4)
        pool = tp.BlockPool(num_blocks=64, block_size=bs)
        pfx_ids = pool.alloc(n_pfx) if n_pfx else []
        lanes = []
        for _ in range(rnd.randint(1, 3)):
            prompt = rnd.randint(n_pfx * bs + 1, 20)
            max_new = rnd.randint(1, 60)
            slack = rnd.randint(0, 7)
            plan = tp.plan_window_request(prompt, max_new, bs, ring,
                                          n_pfx * bs, slack)
            needed, shared, private, _cow, rotated = plan
            own = pool.alloc(private)
            if shared:
                pool.incref(pfx_ids[:shared])
            slot_ids = (pfx_ids[:shared] + own[:private - rotated]
                        + [0] * (ring - needed))
            args = (slot_ids, shared, own[private - rotated:], bs, window)
            lanes.append((tp.WindowRotation(*args), jp.WindowRotation(*args),
                          list(pfx_ids[:shared]), own,
                          prompt + max_new + slack))
        for rot, jrot, shared_ids, own, final_pos in lanes:
            p = 0
            while p < final_pos - 1:
                p = min(final_pos - 1, p + rnd.randint(1, 9))
                q_min = max(0, p - rnd.randint(0, 20))
                got = rot.advance(p, q_min)
                assert got == jrot.advance(p, q_min)
                edits, released, evicted = got
                assert evicted >= len(edits)
                for _slot, new_id, copy_src in edits:
                    assert new_id in own
                    if copy_src is not None:
                        assert copy_src in shared_ids
                for rid in released:
                    assert rid in shared_ids
                    shared_ids.remove(rid)
                if released:
                    pool.decref(released)
                assert pool.used <= pool.num_blocks
            assert (rot.slots, rot.shared_slots, rot.next_block) == \
                (jrot.slots, jrot.shared_slots, jrot.next_block)
        for _r, _j, shared_ids, own, _f in lanes:
            if shared_ids:
                pool.decref(shared_ids)
            pool.decref(own)
        if pfx_ids:
            pool.decref(pfx_ids)
        assert pool.used == 0, trial
        assert sorted(pool._free) == list(range(1, 65)), trial


def test_rotation_copy_rule_matches_jax():
    """tests/test_zpagedkernel.py:373: a wrap whose old positions are
    still inside the window copies the shared block into the shadow, and
    copy_block leaves the shared source as it was; a wrap wholly past
    the window drops the block without a copy."""
    for window, copy in ((16, 2), (4, None)):
        args = ([2, 3, 4], 1, [5], 4, window)
        rot, jrot = tp.WindowRotation(*args), jp.WindowRotation(*args)
        got = rot.advance(upto_pos=12, q_min=12)
        assert got == jrot.advance(upto_pos=12, q_min=12)
        assert got == ([(0, 5, copy)], [2], 1)
    cfg = tl.tiny(dtype=torch.float32)
    cache = tp.init_block_pool(cfg, 6, 4, device="cpu")
    cache[0][0][2] = 3.25
    before = cache[0][0][2].clone()
    tp.copy_block(cache, 2, 5)
    assert torch.equal(cache[0][0][5], before)
    assert torch.equal(cache[0][0][2], before)


# ------------------------------------------------------ the modular write
@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_modular_write_matches_jax(kind):
    """paged_cache_write(modular=True) against the JAX package's: per-lane
    positions that wrap the 3-slot ring (each row modulo its own table),
    a frozen lane whose all-scratch row lands in block 0, and one start
    for every row; the linear write still clamps.  int8 pools quantize
    on the write through the same index.  Bit for bit."""
    rng = np.random.default_rng(0)
    n, bs, kv, d = 9, 4, 2, 8
    table = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
    for pos, length in ((np.array([9, 22, 5], np.int32), 3),
                        (np.array([11, 0, 40], np.int32), 1), (13, 6)):
        for modular in (True, False):
            val = rng.standard_normal((3, length, kv, d)).astype(np.float32)
            base = rng.standard_normal((n + 1, bs, kv, d)).astype(np.float32)
            if kind == "int8":
                jpool = jq.QTensor(
                    q=jnp.zeros(base.shape, jnp.int8),
                    scale=jnp.ones(base.shape[:3] + (1,), jnp.float32))
                tpool = tq.QTensor(q=torch.zeros(base.shape, dtype=torch.int8),
                                   scale=torch.ones(base.shape[:3] + (1,)))
            else:
                jpool, tpool = jnp.asarray(base), torch.from_numpy(base.copy())
            want = jp.paged_cache_write(
                jpool, jnp.asarray(val),
                jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos,
                jnp.asarray(table), modular)
            t_pos = (torch.from_numpy(pos) if isinstance(pos, np.ndarray)
                     else pos)
            got = tp.paged_cache_write(tpool, torch.from_numpy(val), t_pos,
                                       torch.from_numpy(table), modular)
            pairs = ([(got.q, want.q), (got.scale, want.scale)]
                     if kind == "int8" else [(got, want)])
            for g, w in pairs:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------- cache sizing
def test_cache_sizing_matches_jax():
    """auto_cache_len, chunk_align_cache and check_prefill_chunk on a
    grid of configs, prompts and chunks: the same lengths, and the same
    refusals in the same words."""
    n = 0
    for window in (None, 16, 120, 4096):
        for max_len in (256, 8192):
            tcfg = tl.tiny(max_len=max_len, sliding_window=window)
            jcfg = jl.tiny(max_len=max_len, sliding_window=window)
            for prompt in (1, 20, 150, 4000):
                for total in (prompt + 1, prompt + 128):
                    if total > max_len:
                        continue
                    for chunk in (None, 8, 64, 512):
                        assert tl.auto_cache_len(tcfg, prompt, total, chunk) \
                            == jl.auto_cache_len(jcfg, prompt, total, chunk)
                        n += 1
    assert n > 100
    for c in (1, 100, 128, 250, 256, 300, 9000):
        for chunk in (8, 96, 128, 512):
            for max_len in (256, 8192):
                assert tl.chunk_align_cache(c, chunk, max_len) == \
                    jl.chunk_align_cache(c, chunk, max_len)
    for args in ((8, 128, 16, True), (24, 128, 120, True),
                 (24, 128, 120, False), (96, 128, None, True),
                 (512, 4608, 4096, True), (640, 4608, 4096, True),
                 (512, 4600, 4096, False)):
        outcome = []
        for mod in (tl, jl):
            try:
                mod.check_prefill_chunk(*args, who="draft ")
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], args


def test_mistral_7b_matches_jax_preset():
    got = dataclasses.asdict(tl.mistral_7b())
    want = dataclasses.asdict(jl.mistral_7b())
    # the same fields, the MoE knobs among them (off in this preset)
    assert set(want) == set(got)
    assert want["n_experts"] == got["n_experts"] == 0
    for key, val in got.items():
        if key == "dtype":
            assert val == torch.bfloat16 and want[key] == jnp.bfloat16
        else:
            assert val == want[key], key
    assert got["sliding_window"] == 4096 and got["vocab_size"] == 32000
    assert tl.mistral_7b(n_layers=2, sliding_window=64).n_layers == 2


# ------------------------------------------------------ serve_loop parity
@pytest.fixture
def copy_calls(monkeypatch):
    """copy_block calls in each framework's serve loop: the boundary
    CoW's and the rotation's."""
    calls = {"port": 0, "jax": 0}

    def counted(mod, name):
        fn = mod.copy_block

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, "copy_block", wrapper)

    counted(tp, "port")
    counted(jp, "jax")
    return calls


CASES = {
    # decode runs far past the 128-position ring (tests/test_zpagedkernel.py:264)
    "slot": dict(lens=[20, 35], kw=dict(max_new_tokens=120)),
    "continuous": dict(lens=[20, 35],
                       kw=dict(max_new_tokens=120, scheduler="continuous")),
    # a 150-token prompt streams past the ring (tests/test_zcontbatch.py:164)
    "slot_chunked": dict(lens=[20, 150, 9],
                         kw=dict(max_new_tokens=40, prefill_chunk=8)),
    "continuous_chunked": dict(lens=[20, 150, 9],
                               kw=dict(max_new_tokens=40, prefill_chunk=8,
                                       scheduler="continuous")),
    # a 10-token prefix (2 shared blocks and a CoW block) rotated out
    # without a copy (tests/test_zpagedkernel.py:286)
    "prefix": dict(lens=[20, 35], pfx=10, kw=dict(max_new_tokens=120)),
    "prefix_continuous_chunked": dict(
        lens=[12, 140, 30], pfx=16,
        kw=dict(max_new_tokens=40, prefill_chunk=8, scheduler="continuous")),
    # window 120: the rotation copies the shared blocks into their shadows
    "prefix_copy": dict(lens=[20, 35, 50], pfx=10, window=120,
                        kw=dict(max_new_tokens=100, slots=2)),
    "prefix_copy_continuous": dict(lens=[20, 35, 50], pfx=10, window=120,
                                   kw=dict(max_new_tokens=100,
                                           scheduler="continuous")),
    # int8 KV (tests/test_kv_quant.py:102): the quantize-on-write wraps too
    "int8_kv": dict(lens=[20, 150, 9], pfx=16, int8=True,
                    kw=dict(max_new_tokens=40, prefill_chunk=8)),
    "int8_kv_continuous": dict(lens=[20, 35], int8=True,
                               kw=dict(max_new_tokens=120,
                                       scheduler="continuous")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_windowed_serve_loop_matches_jax(w16, w120, w16_int8, copy_calls,
                                        case):
    """serve_loop over a modular table against JAX's paged windowed
    serve_loop: greedy tokens, the schedule, the pool counters and the
    copy_block calls (boundary CoWs plus rotation copies) equal.  Every
    case wraps the ring; the window-120 cases make rotation copies."""
    c = CASES[case]
    jmodel, params, tmodel = w120 if c.get("window") == 120 else w16
    jkw = {}
    if c.get("int8"):
        params, tmodel, jkw = w16_int8
    kw = dict(dict(slots=2, block_size=4), **c["kw"])
    if c.get("int8"):
        kw["kv_quant"] = True
    ps = prompts(c["lens"], seed=8)
    pfx = prompts([c["pfx"]], seed=5)[0] if c.get("pfx") else None
    got, st = serve_loop(tmodel, ps, device="cpu", shared_prefix=pfx,
                         return_stats=True, **kw)
    want, jst = jax_serve(
        jmodel, params, [jnp.asarray(p) for p in ps], paged=True,
        paged_kernel="gather", return_stats=True,
        shared_prefix=None if pfx is None else jnp.asarray(pfx), **jkw, **kw)
    assert schedule(got) == schedule(want)
    for name in STATS:
        assert getattr(st, name) == getattr(jst, name), name
    assert st.window_evicted_blocks > 0
    assert copy_calls["port"] == copy_calls["jax"]
    if pfx is not None:
        assert st.prefix_block_hits > 0
        assert st.cow_copies == (len(ps) if c["pfx"] % 4 else 0)
    rotation_copies = copy_calls["port"] - st.cow_copies
    assert (rotation_copies > 0) == (c.get("window") == 120), rotation_copies


def test_windowed_serving_returns_every_block(w16, monkeypatch):
    """After a windowed run over a shared prefix, the pool holds the
    prefix's blocks alone: every shadow, every rotated-out reference and
    every lane's ring came back."""
    _, _, tmodel = w16
    pools = []

    class Recorded(tp.BlockPool):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            pools.append(self)

    monkeypatch.setattr(tp, "BlockPool", Recorded)
    pfx = prompts([16], seed=5)[0]
    for scheduler in ("slot", "continuous"):
        serve_loop(tmodel, prompts([12, 140, 30], seed=8), device="cpu",
                   shared_prefix=pfx, slots=2, block_size=4,
                   max_new_tokens=40, prefill_chunk=8, scheduler=scheduler)
        pool = pools[-1]
        assert pool.used == 4
        assert pool._ref[1:5] == [1, 1, 1, 1]


@pytest.mark.parametrize("kw,match", [
    # a 144-token chunk: the ring is chunk-aligned under max_len to 144
    # positions, of which the window leaves 24 for the chunk
    (dict(lens=[150], max_new_tokens=4, prefill_chunk=144),
     "evict positions its own queries still attend"),
    (dict(lens=[150], max_new_tokens=4, prefill_chunk=102),
     "must be a multiple of block_size"),
    (dict(lens=[6], max_new_tokens=4, prefill_chunk=8, pfx=144),
     "exceeds the window ring"),
])
def test_window_refusals_match_jax(w120, kw, match):
    """A chunk that would evict its own queries' positions, a chunk of
    part blocks, and a shared prefix longer than the ring: refused in
    the JAX package's words.  (A prompt longer than the ring without a
    chunk cannot occur through the default sizing, which always holds
    the longest unchunked prompt.)"""
    jmodel, params, tmodel = w120
    kw = dict(kw)
    ps = prompts(kw.pop("lens"), seed=1)
    n_pfx = kw.pop("pfx", 0)
    pfx = prompts([n_pfx], seed=8)[0] if n_pfx else None
    kw.update(slots=2, block_size=4)
    with pytest.raises(ValueError, match=match) as terr:
        serve_loop(tmodel, ps, device="cpu", shared_prefix=pfx, **kw)
    with pytest.raises(ValueError, match=match) as jerr:
        jax_serve(jmodel, params, [jnp.asarray(p) for p in ps], paged=True,
                  shared_prefix=None if pfx is None else jnp.asarray(pfx),
                  **kw)
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------- the windowed handoff
HANDOFF = dict(slots=3, block_size=4, max_new_tokens=40, prefill_chunk=8)


def _handoff_prompts():
    """A 16-token prefix (4 shared blocks) and suffixes whose prompts
    stream past the 128-position ring (the 156-token one rotates the
    prefix out before its export) or wrap it while decoding."""
    return prompts([16], seed=5)[0], prompts([140, 9, 100], seed=8)


@pytest.fixture(scope="module")
def handoff_runs(w16):
    """The f32 handoff's runs that several tests read: the port's
    unified run, its prefill_only run (handoffs and stats) and JAX's
    prefill_only run, over _handoff_prompts."""
    jmodel, params, tmodel = w16
    pfx, sufs = _handoff_prompts()
    uni = serve_loop(tmodel, sufs, shared_prefix=pfx, device="cpu",
                     **HANDOFF)
    hand, hst = serve_loop(tmodel, sufs, shared_prefix=pfx, device="cpu",
                           prefill_only=True, return_stats=True, **HANDOFF)
    jhand = jax_serve(jmodel, params, [jnp.asarray(s) for s in sufs],
                      paged=True, paged_kernel="gather",
                      shared_prefix=jnp.asarray(pfx), prefill_only=True,
                      **HANDOFF)
    return dict(uni=uni, hand=hand, hst=hst, jhand=jhand)


@pytest.mark.parametrize("scheduler", ["slot", "continuous"])
def test_windowed_handoff_port_to_port(w16, handoff_runs, scheduler):
    """prefill_only then adopt on the port: the unified run's tokens; the
    exports' `window` dicts equal JAX's, and their hashes and elisions
    follow the ring's slot order."""
    tmodel = w16[2]
    pfx, sufs = _handoff_prompts()
    full = [np.concatenate([pfx, s]) for s in sufs]
    uni, hand, hst, jhand = (handoff_runs[k] for k in
                             ("uni", "hand", "hst", "jhand"))
    out, st = serve_loop(tmodel, full, device="cpu", adopt=hand,
                         scheduler=scheduler, return_stats=True, **HANDOFF)
    assert [r.tokens for r in out] == [r.tokens for r in uni]
    assert [h.export.window for h in hand] == \
        [h.export.window for h in jhand]
    assert [h.export.shared for h in hand] == \
        [h.export.shared for h in jhand]
    wins = [h.export.window for h in hand]
    # the long prompt rotated the prefix out of its ring before export
    assert wins[0]["next_block"] > wins[0]["ring"] == 32
    assert wins[0]["shared_slots"] == [] and wins[1]["shared_slots"] == \
        [0, 1, 2, 3]
    assert hst.window_evicted_blocks > 0 and st.window_evicted_blocks > 0
    assert st.handoff_adoptions == 3 and st.prefix_block_hits > 0


def test_windowed_handoff_crosses_between_frameworks(w16, w16_int8,
                                                    handoff_runs):
    """JAX's windowed handoffs adopt into the port, the port's into JAX's
    serve_loop(adopt=...), int8 KV too: both give JAX's unified tokens,
    with equal adoption counters."""
    jmodel, params, tmodel = w16
    pfx, sufs = _handoff_prompts()
    full = [np.concatenate([pfx, s]) for s in sufs]
    jfull = [jnp.asarray(f) for f in full]
    for kv_quant in (False, True):
        jkw = {}
        p, m = params, tmodel
        if kv_quant:
            p, m, jkw = w16_int8
        kw = dict(HANDOFF, kv_quant=kv_quant)
        want = [r.tokens for r in jax_serve(
            jmodel, p, [jnp.asarray(s) for s in sufs], paged=True,
            paged_kernel="gather", shared_prefix=jnp.asarray(pfx),
            **jkw, **kw)]
        if kv_quant:
            jhand = jax_serve(jmodel, p, [jnp.asarray(s) for s in sufs],
                              paged=True, paged_kernel="gather",
                              shared_prefix=jnp.asarray(pfx),
                              prefill_only=True, **jkw, **kw)
            thand = serve_loop(m, sufs, shared_prefix=pfx, device="cpu",
                               prefill_only=True, **kw)
        else:
            # HANDOFF with f32 KV: handoff_runs' prefill_only runs
            jhand, thand = handoff_runs["jhand"], handoff_runs["hand"]
        got, st = serve_loop(m, full, device="cpu",
                             adopt=[handoff_to_port(h) for h in jhand],
                             return_stats=True, **kw)
        back, jst = jax_serve(jmodel, p, jfull, paged=True,
                              paged_kernel="gather",
                              adopt=[handoff_to_jax(h) for h in thand],
                              return_stats=True, **jkw, **kw)
        assert [r.tokens for r in got] == [r.tokens for r in back] == want
        for name in ("prefix_block_hits", "handoff_adoptions",
                     "window_evicted_blocks", "kv_blocks_peak_used"):
            assert getattr(st, name) == getattr(jst, name), name


def test_windowed_handoff_ring_mismatch_leaves_pool(w16, handoff_runs,
                                                    monkeypatch):
    """A windowed export whose ring is not the receiver's raises JAX's
    HandoffError before the loop builds its pool, so no block changes
    hands; the same export with its own ring adopts."""
    _, _, tmodel = w16
    pfx, sufs = _handoff_prompts()
    full = [np.concatenate([pfx, s]) for s in sufs]
    hand = handoff_runs["hand"]
    pools = []

    class Recorded(tp.BlockPool):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            pools.append(self)

    monkeypatch.setattr(tp, "BlockPool", Recorded)
    wrong = [dataclasses.replace(h, export=tp.BlockExport(
        h.export.block_size, h.export.hashes, h.export.shared,
        h.export.payload, dict(h.export.window, ring=31))) for h in hand]
    with pytest.raises(tp.HandoffError, match="sender shipped 31, this "
                       "pool's tables are 32 wide"):
        serve_loop(tmodel, full, device="cpu", adopt=wrong, **HANDOFF)
    assert pools == []
    serve_loop(tmodel, full, device="cpu", adopt=hand, **HANDOFF)
    assert len(pools) == 1 and pools[0].used == 0


def test_window_stats_field_and_mistral_serves():
    """A mistral_7b-shaped config cut to a tiny width (1 layer, window 8)
    serves windowed on the CPU through the same loop and wraps its ring;
    a linear model's run counts no window eviction."""
    cfg = tl.mistral_7b(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=1,
                        d_ff=64, n_layers=1, sliding_window=8, max_len=256,
                        dtype=torch.float32)
    model = tl.Llama.from_params(cfg, bridge.init_params(cfg, 0, "cpu"),
                                 device="cpu")
    ps = [p % 64 for p in prompts([30, 5], seed=2)]
    res, st = serve_loop(model, ps, device="cpu", slots=2, block_size=4,
                         max_new_tokens=120, prefill_chunk=8,
                         return_stats=True)
    assert [len(r.tokens) for r in res] == [120, 120]
    assert st.window_evicted_blocks > 0
    lcfg = tl.tiny(dtype=torch.float32)
    linear = tl.Llama.from_params(lcfg, bridge.init_params(lcfg, 0, "cpu"),
                                  device="cpu")
    _, lst = serve_loop(linear, prompts([6], seed=1), device="cpu",
                        max_new_tokens=4, block_size=4, return_stats=True)
    assert lst.window_evicted_blocks == 0
