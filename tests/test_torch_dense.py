"""The port's dense-cache decoding (tf_operator_tpu_torch.models.llama's
ring writes, init_cache and generate; speculative.speculative_generate;
serve_loop(paged=False); the generate_llama entry point) against the JAX
package, on the CPU at tiny f32 widths over one set of weights.

Exact: the ring writes (scalar, wrapping and per-row positions, f32 and
int8 caches) bit for bit; greedy generate one-pass, chunked, with EOS,
over a windowed ring smaller than the sequence, with int8 weights and
with int8 KV; greedy speculative_generate's tokens and stats, which also
equal generate's; dense serve_loop's tokens, schedule, non-clock
ServeStats and telemetry under both schedulers, over a prefix, a window
ring, int8 weights and KV, and with speculation.  The refusals carry
JAX's words.  Sampling cannot match jax.random, so sampled runs are
checked for seed determinism and for top_k=1 giving the greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_telemetry import assert_same_telemetry, run_pair
from tests.torch_serving_util import int8_models, port_model, prompts
from tests.torch_serving_util import tiny_models, to_torch
from tf_operator_tpu.data.tokenize import ByteTokenizer as JaxByteTokenizer
from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models import quant as jq
from tf_operator_tpu.models import speculative as jspec
from tf_operator_tpu_torch import generate_llama
from tf_operator_tpu_torch.engine import metrics as em
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import quant as tq
from tf_operator_tpu_torch.models.serving import serve_loop
from tf_operator_tpu_torch.models.speculative import speculative_generate

F32_DQ = tq.make_dequantizer(torch.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny models' ops gain nothing from torch's intra-op threads,
    which spin against the other test workers' threads on a shared
    machine: this file runs on one, and the count is put back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def wmodels(models):
    """tests/test_serving.py:94's windowed model (window 8, max_len 512)
    over models' weights, which a window leaves as they are."""
    kw = dict(max_len=512, sliding_window=8)
    params = models[1]
    return (jl.Llama(jl.tiny(dtype=jnp.float32, **kw)), params,
            port_model(params, **kw))


@pytest.fixture(scope="module")
def int8(models):
    """models' weights quantized: (int8 params, the port's model over
    them, JAX's keywords), shared by the int8-weight cases."""
    return int8_models(models[1])


@pytest.fixture(scope="module")
def draft(models):
    """A 1-layer draft of its own seeded weights (test_serving.py's
    _draft_setup): (JAX draft, its params, the port's)."""
    jdraft = jl.Llama(jl.tiny(dtype=jnp.float32, max_len=128, n_layers=1))
    dparams = jdraft.init(jax.random.PRNGKey(9), jnp.zeros((1, 8), jnp.int32),
                          train=False)["params"]
    return jdraft, dparams, port_model(dparams, n_layers=1)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _batch(lengths_n, length, seed):
    return np.stack(prompts([length] * lengths_n, seed))


# ------------------------------------------------------------ ring writes
WRITES = {
    # name: (pos, L, wrap)
    "scalar": (3, 4, False),
    "scalar_clamped": (6, 4, False),   # start clamps to C - L = 4
    "wrap": (6, 4, True),
    "vector": ([5, 1], 4, False),
    "vector_one": ([7, 2], 1, False),
}


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("case", list(WRITES))
def test_cache_write_matches_jax(case, kind):
    """_cache_write on a [2, 8, 2, 4] ring: the same payload (and
    scales) as JAX's _cache_write, bit for bit."""
    pos, l, wrap = WRITES[case]
    rng = np.random.default_rng(3)
    val = rng.standard_normal((2, l, 2, 4)).astype(np.float32)
    buf = rng.standard_normal((2, 8, 2, 4)).astype(np.float32)
    if kind == "int8":
        q = rng.integers(-127, 128, buf.shape).astype(np.int8)
        sc = rng.random((2, 8, 2, 1)).astype(np.float32)
        jbuf = jq.QTensor(q=jnp.asarray(q), scale=jnp.asarray(sc))
        tbuf = tq.QTensor(q=to_torch(q), scale=to_torch(sc))
    else:
        jbuf, tbuf = jnp.asarray(buf), to_torch(buf)
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) \
        else pos
    want = jl._cache_write(jbuf, jnp.asarray(val), jpos, wrap)
    got = tl._cache_write(tbuf, to_torch(val), tpos, wrap)
    if kind == "int8":
        assert np.array_equal(_np(got.q), np.asarray(want.q))
        assert np.array_equal(_np(got.scale), np.asarray(want.scale))
        assert got.q.data_ptr() == tbuf.q.data_ptr()   # in place
    else:
        assert np.array_equal(_np(got), np.asarray(want))
        assert got.data_ptr() == tbuf.data_ptr()


def test_per_row_write_longer_than_the_ring_is_refused():
    with pytest.raises(ValueError, match="would alias slots within a row"):
        tl._ring_write(torch.zeros((2, 4, 1)), torch.zeros((2, 5, 1)),
                       torch.tensor([0, 1]), False)


def test_init_cache_layout_and_refusals(models):
    """Per-layer (k, v) leaves [B, C, KV, D] as JAX lays them out (int8:
    zero payload, ones scales [B, C, KV, 1]); C above max_len and
    kv_quant with a dtype are refused with JAX's words."""
    jm, _, tm = models
    for kv_quant in (False, True):
        want = jl.init_cache(jm.cfg, 3, 32, kv_quant=kv_quant)
        got = tl.init_cache(tm.cfg, 3, 32, kv_quant=kv_quant, device="cpu")
        assert len(got) == len(want) == tm.cfg.n_layers
        for (gk, gv), (wk, wv) in zip(got, want):
            for g, w in ((gk, wk), (gv, wv)):
                pairs = ([(g.q, w.q), (g.scale, w.scale)] if kv_quant
                         else [(g, w)])
                for a, b in pairs:
                    assert _np(a).dtype == np.asarray(b).dtype
                    assert np.array_equal(_np(a), np.asarray(b))
    assert tl.init_cache(tm.cfg, 1, device="cpu")[0][0].shape[1] == 128
    with pytest.raises(ValueError, match="exceeds cfg.max_len 128"):
        tl.init_cache(tm.cfg, 1, 129, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tl.init_cache(tm.cfg, 1, 8, dtype=torch.float32, kv_quant=True,
                      device="cpu")


# ---------------------------------------------------------------- generate
GEN_CASES = {
    # name: (models fixture, generate keywords, int8 weights)
    "one_pass": ("models", {}, False),
    "chunked": ("models", dict(prefill_chunk=4), False),
    "eos": ("models", dict(eos_id="third"), False),
    # test_serving.py:94's shapes: a 16-slot ring under a window of 8,
    # 40-token prompts streamed in chunks of 4
    "window": ("wmodels", dict(cache_len=16, prefill_chunk=4), False),
    "int8_weights": ("models", {}, True),
    "int8_kv": ("models", dict(kv_quant=True), False),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_greedy_matches_jax(case, request):
    fixture, kw, int8 = GEN_CASES[case]
    jm, params, tm = request.getfixturevalue(fixture)
    length = 40 if fixture == "wmodels" else 12
    ps = _batch(3, length, seed=5)
    kw = dict(kw)
    if kw.get("eos_id") == "third":
        # an eos the run emits mid-stream: row 0's third token
        kw["eos_id"] = int(tl.generate(tm, ps, 10, device="cpu")[0, 2])
    jkw = dict(kw)
    if int8:
        params, tm, jkw2 = request.getfixturevalue("int8")
        jkw.update(jkw2)
        kw["params_transform"] = F32_DQ
    want = np.asarray(jl.generate(jm, params, jnp.asarray(ps), 10, **jkw))
    got = tl.generate(tm, ps, 10, device="cpu", **kw)
    assert got.shape == (3, 10) and got.dtype == torch.long
    assert np.array_equal(_np(got), want)
    if case == "chunked":
        # one-pass = chunked
        assert torch.equal(tl.generate(tm, ps, 10, device="cpu"), got)
    if case == "eos":
        row = _np(got)[0]
        assert (row[2:] == kw["eos_id"]).all() and row[2] == kw["eos_id"]


@pytest.mark.parametrize("kw,exc,match", [
    (dict(max_new_tokens=-1), ValueError, "max_new_tokens must be >= 0"),
    (dict(max_new_tokens=200), ValueError, "exceeds RoPE table length"),
    (dict(cache_len=16), ValueError, "exceeds cache length 16"),
    (dict(prefill_chunk=5, cache_len=128), ValueError,
     "must divide cache_len 128"),
    (dict(prefill_chunk=0, cache_len=128), ValueError,
     "prefill_chunk must be >= 1"),
    (dict(eos_id=256), ValueError, "eos_id 256 out of range"),
    (dict(top_k=300), ValueError, "top_k must be in"),
    (dict(temperature=0.5), ValueError, "needs a generator"),
    (dict(params_transform=lambda p: p), ValueError, "params_transform"),
    (dict(cache_sharding=object()), NotImplementedError, "item 11"),
])
def test_generate_refusals(models, kw, exc, match):
    _, _, tm = models
    kw = dict(dict(max_new_tokens=8), **kw)
    with pytest.raises(exc, match=match):
        tl.generate(tm, _batch(2, 12, seed=1), kw.pop("max_new_tokens"),
                    device="cpu", **kw)


def test_generate_edges(models, wmodels):
    """max_new_tokens 0 and 1; a window ring smaller than the window and
    a one-pass prompt longer than the ring are refused as JAX refuses
    them."""
    _, _, tm = models
    ps = _batch(2, 12, seed=1)
    assert tl.generate(tm, ps, 0, device="cpu").shape == (2, 0)
    assert torch.equal(tl.generate(tm, ps, 1, device="cpu"),
                       tl.generate(tm, ps, 4, device="cpu")[:, :1])
    wm = wmodels[2]
    with pytest.raises(ValueError, match="cache_len 6 < sliding window 8"):
        tl.generate(wm, _batch(2, 4, seed=1), 8, cache_len=6, device="cpu")
    with pytest.raises(ValueError, match="single-pass prefill write"):
        tl.generate(wm, _batch(1, 40, seed=1), 8, cache_len=16,
                    device="cpu")


def test_sampled_generate_is_seeded_and_top_k_one_is_greedy(models):
    _, _, tm = models
    ps = _batch(2, 12, seed=2)
    run = lambda seed, **kw: tl.generate(
        tm, ps, 10, temperature=0.9, device="cpu",
        generator=torch.Generator().manual_seed(seed), **kw)
    assert torch.equal(run(3, top_p=0.9), run(3, top_p=0.9))
    assert not torch.equal(run(3), run(4))
    assert torch.equal(run(5, top_k=1), tl.generate(tm, ps, 10,
                                                    device="cpu"))


# ------------------------------------------------------ speculative_generate
SPEC_CASES = {
    # name: (models fixture, self draft, keywords)
    "seeded_draft": ("models", False, dict(k=3)),
    "self_draft_eos": ("models", True, dict(k=3, eos_id="third")),
    # a 16-slot ring under a window of 8 (>= window + k): the verify
    # write wraps the ring
    "window_wrap": ("wmodels", True, dict(k=3, cache_len=16,
                                          draft_cache_len=16,
                                          prefill_chunk=4)),
    "int8_kv": ("models", False, dict(k=2, kv_quant=True)),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_speculative_generate_matches_jax_and_generate(case, request, draft):
    fixture, self_draft, kw = SPEC_CASES[case]
    jm, params, tm = request.getfixturevalue(fixture)
    jd, dparams, td = (jm, params, tm) if self_draft else draft
    length = 40 if fixture == "wmodels" else 12
    ps = _batch(3, length, seed=6)
    kw = dict(kw)
    if kw.get("eos_id") == "third":
        kw["eos_id"] = int(tl.generate(tm, ps, 12, device="cpu")[1, 2])
    want, jstats = jspec.speculative_generate(
        jm, params, jd, dparams, jnp.asarray(ps), 12, return_stats=True,
        **kw)
    got, stats = speculative_generate(tm, td, ps, 12, return_stats=True,
                                      device="cpu", **kw)
    assert np.array_equal(_np(got), np.asarray(want))
    assert stats == jstats
    assert stats["proposed_drafts"] > 0
    if self_draft:
        assert stats["accepted_drafts"] > 0
    gen_kw = {k: v for k, v in kw.items()
              if k in ("eos_id", "cache_len", "prefill_chunk", "kv_quant")}
    assert torch.equal(got, tl.generate(tm, ps, 12, device="cpu", **gen_kw))


@pytest.mark.parametrize("kw,exc,match", [
    (dict(k=0), ValueError, "k must be >= 1"),
    (dict(vocab=True), ValueError, "speculation compares token ids"),
    (dict(max_new_tokens=120), ValueError, "speculation headroom"),
    (dict(cache_len=16), ValueError,
     "target cache_len 16 < 28 — a full-causal model"),
    (dict(window=True, cache_len=10), ValueError,
     "target cache_len 10 < window 8 \\+ k 4"),
    (dict(prefill_chunk=5, cache_len=28), ValueError,
     "must divide target cache_len 28"),
    (dict(eos_id=-2), ValueError, "out of range"),
    (dict(temperature=0.5), ValueError, "needs a generator"),
    (dict(draft_transform=lambda p: p), ValueError, "draft_transform"),
    (dict(draft_cache_sharding=object()), NotImplementedError, "item 11"),
])
def test_speculative_generate_refusals(models, wmodels, draft, kw, exc,
                                       match):
    kw = dict(kw)
    tm = (wmodels if kw.pop("window", False) else models)[2]
    td = draft[2]
    if kw.pop("vocab", False):
        cfg = tl.tiny(dtype=torch.float32, n_layers=1, vocab_size=128)
        td = tl.Llama.from_params(cfg, bridge.init_params(cfg, 0,
                                                          device="cpu"),
                                  device="cpu")
    if tm.cfg.sliding_window is not None:
        td = tm
    n = kw.pop("max_new_tokens", 8)
    with pytest.raises(exc, match=match):
        speculative_generate(tm, td, _batch(2, 15, seed=1), n,
                             device="cpu", **kw)


def test_speculative_generate_feeds_acceptance_family(models):
    """tests/test_serving_telemetry.py:172 on the port: the proposed
    counter of path="speculative_generate" grows by the call's own
    proposed drafts, the accepted one by at least its accepted."""
    _, _, tm = models
    labels = {"path": "speculative_generate"}
    before = em.SERVING_PROPOSED_DRAFTS.get(labels)
    _, stats = speculative_generate(tm, tm, _batch(1, 8, seed=11), 12, k=3,
                                    return_stats=True, device="cpu")
    assert em.SERVING_PROPOSED_DRAFTS.get(labels) == (
        before + stats["proposed_drafts"])
    assert em.SERVING_ACCEPTED_DRAFTS.get(labels) >= stats["accepted_drafts"]


def test_sampled_speculation_is_seeded_and_top_k_one_is_greedy(models,
                                                               draft):
    _, _, tm = models
    td = draft[2]
    ps = _batch(2, 12, seed=4)
    run = lambda seed, **kw: speculative_generate(
        tm, td, ps, 10, k=2, temperature=0.8, device="cpu",
        generator=torch.Generator().manual_seed(seed), **kw)
    assert torch.equal(run(3, top_p=0.9), run(3, top_p=0.9))
    assert torch.equal(run(5, top_k=1), tl.generate(tm, ps, 10,
                                                    device="cpu"))


# -------------------------------------------------------- serve_loop dense
LENS, BUDGETS = [5, 13, 3, 9, 17], [8, 5, 9, 6, 7]
# the tiny cases stream prompts in chunks of 8, so that JAX compiles each
# segment shape once for all of them
SERVE_CASES = {
    # name: (models fixture, keywords, int8 weights, draft)
    "slot": ("models", dict(prefill_chunk=8), False, False),
    "continuous": ("models", dict(scheduler="continuous",
                                  prefill_chunks_per_sync=1,
                                  prefill_chunk=8), False, False),
    "prefix": ("models", dict(shared_prefix=8, prefill_chunk=8), False,
               False),
    # test_serving.py:94: 16-slot rings under a window of 8
    "window": ("wmodels", dict(cache_len=16, prefill_chunk=4), False,
               False),
    "int8": ("models", dict(kv_quant=True), True, False),
    "spec_slot": ("models", dict(spec_k=2, steps_per_sync=3,
                                 prefill_chunk=8), False, True),
    "spec_continuous": ("models", dict(spec_k=2, steps_per_sync=3,
                                       scheduler="continuous",
                                       prefill_chunk=8, eos_id="mid"),
                        False, True),
    # speculation over windowed rings of both models (the self-draft)
    "spec_window": ("wmodels", dict(spec_k=3, cache_len=16,
                                    prefill_chunk=4), False, True),
}


def _schedule(res):
    return [(r.tokens, r.admitted_at_step, r.finished_at_step, r.slot,
             r.accepted_drafts, r.proposed_drafts, r.kv_blocks)
            for r in res]


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_dense_serve_loop_matches_jax(case, request, draft):
    """Dense serve_loop against JAX's default (dense) serve_loop: tokens,
    schedule, drafts, non-clock ServeStats and telemetry equal."""
    fixture, kw, int8, spec = SERVE_CASES[case]
    jm, params, tm = request.getfixturevalue(fixture)
    reqs = prompts([40, 22, 33] if fixture == "wmodels" else LENS, 1)
    kw = dict(dict(slots=2, max_new_tokens=BUDGETS[:len(reqs)],
                   steps_per_sync=4), **kw)
    jax_kw, port_kw = {}, {}
    if "shared_prefix" in kw:
        kw["shared_prefix"] = prompts([kw["shared_prefix"]], 3)[0]
    if kw.get("eos_id") == "mid":
        kw["eos_id"] = serve_loop(tm, reqs, paged=False, device="cpu",
                                  slots=2, max_new_tokens=8)[1].tokens[2]
    if int8:
        params, tm, jax_kw = request.getfixturevalue("int8")
        jax_kw = dict(jax_kw)
        port_kw = dict(params_transform=F32_DQ)
    if spec:
        jd, dparams, td = ((jm, params, tm) if fixture == "wmodels"
                           else draft)
        jax_kw.update(draft=jd, draft_params=dparams)
        port_kw.update(draft=td)
    (jres, jst, jseen), (tres, tst, tseen) = run_pair(
        (jm, params, tm), reqs, jax_kw=jax_kw, port_kw=port_kw, paged=False,
        **kw)
    assert _schedule(tres) == _schedule(jres)
    assert_same_telemetry((jres, jst, jseen), (tres, tst, tseen))
    assert not tst.paged and tst.kv_blocks_total == 0
    if spec:
        assert tst.proposed_drafts > 0


def test_dense_window_continuous_gives_the_slot_tokens(wmodels):
    """The continuous scheduler over windowed dense rings (JAX's dense
    continuous loop reaches its paged-only window rotation here and
    raises NameError, so the port is held against its own slot run,
    which test_dense_serve_loop_matches_jax[window] holds against
    JAX's): the same tokens, every request streaming through its ring."""
    tm = wmodels[2]
    reqs = prompts([40, 22, 33], 1)
    kw = dict(slots=2, max_new_tokens=BUDGETS[:3], steps_per_sync=4,
              cache_len=16, prefill_chunk=4, paged=False, device="cpu")
    slot = serve_loop(tm, reqs, **kw)
    cont = serve_loop(tm, reqs, scheduler="continuous", **kw)
    assert [r.tokens for r in cont] == [r.tokens for r in slot]


def test_dense_equals_paged_and_ignores_block_knobs(models):
    """Greedy tokens are the same under either layout, and dense mode
    ignores block_size and pool_blocks as JAX does."""
    _, _, tm = models
    reqs = prompts(LENS, 1)
    kw = dict(slots=2, max_new_tokens=BUDGETS, device="cpu")
    dense = serve_loop(tm, reqs, paged=False, **kw)
    odd = serve_loop(tm, reqs, paged=False, block_size=3, pool_blocks=1,
                     **kw)
    paged = serve_loop(tm, reqs, block_size=4, **kw)
    assert [r.tokens for r in dense] == [r.tokens for r in paged]
    assert _schedule(odd) == _schedule(dense)
    assert all(r.kv_blocks == 0 for r in dense)


def test_sampled_dense_serving_is_seeded_and_top_k_one_is_greedy(models):
    _, _, tm = models
    reqs = prompts(LENS, 2)
    kw = dict(slots=2, max_new_tokens=6, paged=False, device="cpu",
              temperature=0.9)
    run = lambda seed, **k: [r.tokens for r in serve_loop(
        tm, reqs, generator=torch.Generator().manual_seed(seed), **kw, **k)]
    assert run(3, top_p=0.9) == run(3, top_p=0.9)
    greedy = serve_loop(tm, reqs, slots=2, max_new_tokens=6, paged=False,
                        device="cpu")
    assert run(5, top_k=1) == [r.tokens for r in greedy]


@pytest.mark.parametrize("kw,match", [
    (dict(cache_len=16, max_new_tokens=8), "cannot stream past its cache"),
    (dict(window=True, cache_len=8, draft="self", spec_k=3),
     "cache_len 8 < target requirement 11 \\(window 8 \\+ spec_k 3"),
    (dict(window=True, cache_len=16), "pass prefill_chunk to stream it"),
    (dict(window=True, cache_len=16, prefill_chunk=5),
     "must divide cache_len 16"),
    (dict(prefill_only=True), "paged-only"),
    (dict(adopt=[]), "paged-only"),
])
def test_dense_serve_refusals(models, wmodels, kw, match):
    kw = dict(kw)
    tm = (wmodels if kw.pop("window", False) else models)[2]
    if kw.get("draft") == "self":
        kw["draft"] = tm
    reqs = prompts([40, 22] if tm.cfg.sliding_window else [30, 9], 1)
    kw = dict(dict(slots=2, max_new_tokens=10), **kw)
    with pytest.raises(ValueError, match=match):
        serve_loop(tm, reqs, paged=False, device="cpu", **kw)


# ---------------------------------------------------------- generate_llama
def _tokens(out: str):
    line = [l for l in out.splitlines() if l.startswith("tokens: ")][-1]
    return [int(t) for t in line[len("tokens: ["):-1].split(", ")]


def test_generate_llama_smoke_runs_on_the_cpu(capsys):
    """--smoke --device cpu decodes; the speculative run (a 1-layer
    draft) and int8 weights and KV run too, and greedy speculation gives
    the plain run's tokens."""
    base = ["--smoke", "--device", "cpu", "--prompt", "hello", "--max-new",
            "8"]
    assert generate_llama.main(base) == 0
    plain = _tokens(capsys.readouterr().out)
    assert len(plain) == 8 and all(0 <= t < 256 for t in plain)
    assert generate_llama.main(base + ["--draft-layers", "1", "--spec-k",
                                       "2"]) == 0
    out = capsys.readouterr().out
    assert "target forwards" in out and _tokens(out) == plain
    assert generate_llama.main(base + ["--int8", "--int8-kv",
                                       "--prefill-chunk", "2"]) == 0
    assert "kv cache: int8" in capsys.readouterr().out


@pytest.mark.parametrize("argv,exc,match", [
    (["--ckpt-dir", "x"], NotImplementedError, "item 9"),
    (["--draft-ckpt-dir", "x"], NotImplementedError, "item 9"),
    (["--hf-dir", "x"], NotImplementedError, "item 10"),
    (["--tokenizer", "x"], NotImplementedError, "item 10"),
    (["--model", "mixtral"], NotImplementedError, "item 10"),
])
def test_generate_llama_refusals_name_their_items(argv, exc, match):
    with pytest.raises(exc, match=match):
        generate_llama.main(["--smoke", "--device", "cpu", "--prompt", "hi"]
                            + argv)


def test_generate_llama_without_weights_and_the_tokenizer():
    """No --smoke, no weights: JAX's words.  The byte tokenizer is the
    JAX package's."""
    with pytest.raises(SystemExit, match="no weights: pass --ckpt-dir"):
        generate_llama.main(["--prompt", "hi", "--device", "cpu"])
    text = "héllo\x00 wörld"
    mine, theirs = generate_llama.ByteTokenizer(), JaxByteTokenizer()
    assert mine.encode(text) == theirs.encode(text)
    ids = theirs.encode(text) + [0, 7]
    assert mine.decode(ids) == theirs.decode(ids)
    assert (mine.vocab_size, mine.eos_id) == (theirs.vocab_size,
                                              theirs.eos_id)


def test_draft_config_is_the_model_cut_to_its_first_layers():
    """--draft-layers n builds the smoke config at n layers from the same
    seed: the draft's weights are the target's first n layers."""
    cfg = tl.tiny(tie_embeddings=True, dtype=torch.float32, max_len=256)
    t = generate_llama.build_model(cfg, False, torch.device("cpu"))
    d = generate_llama.build_model(dataclasses.replace(cfg, n_layers=1),
                                   False, torch.device("cpu"))
    td = t.state_dict()
    for k, v in d.state_dict().items():
        assert torch.equal(v, td[k]), k
