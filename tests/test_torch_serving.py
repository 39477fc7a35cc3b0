"""The port's serve_loop (tf_operator_tpu_torch.models.serving) against the
JAX package's serve_loop(paged=True) on the CPU, at tiny f32 widths.

Both run the same host schedule over the same bridged weights, so a
greedy run must give identical tokens AND identical per-request schedule
fields: the step a request went live, the step it finished, its lane and
its KV blocks.  The JAX side reads through its gather oracle, the port
through the paged kernel's plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_serving_util import one_torch_thread
from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models.serving import serve_loop as jax_serve
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models.serving import serve_loop

LENS = [5, 13, 3, 9, 17]
BUDGETS = [8, 5, 9, 6, 7]



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tiny tensors run on one torch thread (the JAX side
    keeps its own pool)."""
    with one_torch_thread():
        yield

@pytest.fixture(scope="module")
def setup():
    jcfg = jl.tiny(dtype=jnp.float32, max_len=128)
    jmodel = jl.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                         train=False)["params"]
    tcfg = tl.tiny(dtype=torch.float32, max_len=128)
    tmodel = tl.Llama.from_params(
        tcfg, bridge.params_from_jax(tcfg, jax.tree.map(np.asarray, params)),
        device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in LENS]
    return jmodel, params, tmodel, prompts


def _schedule(results):
    return [(r.tokens, r.admitted_at_step, r.finished_at_step, r.slot,
             r.kv_blocks) for r in results]


def _both(setup, **kw):
    jmodel, params, tmodel, prompts = setup
    want, jstats = jax_serve(jmodel, params, [jnp.asarray(p) for p in prompts],
                             paged=True, paged_kernel="gather",
                             return_stats=True, **kw)
    got, stats = serve_loop(tmodel, prompts, device="cpu", return_stats=True,
                            **kw)
    return got, stats, want, jstats


@pytest.mark.parametrize("case", ["gate_chunked", "one_segment"])
def test_serve_loop_matches_jax_schedule(setup, case):
    """5 ragged requests through 2 lanes with block size 4.
    gate_chunked: 8-token prefill segments and a 7-block pool, so the
    memory gate holds the queue head; one_segment: whole-prompt prefill,
    the default pool and 3-step sync blocks."""
    kw = dict(slots=2, max_new_tokens=BUDGETS, block_size=4)
    if case == "gate_chunked":
        kw.update(prefill_chunk=8, pool_blocks=7, steps_per_sync=4)
    else:
        kw.update(steps_per_sync=3)
    got, stats, want, jstats = _both(setup, **kw)
    assert _schedule(got) == _schedule(want)
    assert [len(r.tokens) for r in got] == BUDGETS
    assert stats.admissions_blocked_on_memory == \
        jstats.admissions_blocked_on_memory
    assert stats.wasted_lane_steps == jstats.wasted_lane_steps
    assert stats.kv_blocks_peak_used == jstats.kv_blocks_peak_used
    if case == "gate_chunked":
        assert stats.admissions_blocked_on_memory > 0
        assert stats.kv_blocks_peak_used <= 7
    assert stats.total_tokens == sum(BUDGETS) == jstats.total_tokens
    assert stats.requests == 5 and stats.paged_kernel == "plain"
    assert len(stats.per_request) == 5


def test_serve_loop_eos_matches_jax(setup):
    """An eos_id the run really emits: take a token request 1 emits
    mid-stream without eos, then serve with it as eos_id.  Requests that
    emit it stop there (eos included), and the schedules still agree."""
    kw = dict(slots=2, max_new_tokens=BUDGETS, block_size=4,
              prefill_chunk=8, steps_per_sync=4)
    first, _, _, _ = _both(setup, **kw)
    eos = first[1].tokens[2]
    got, _, want, _ = _both(setup, eos_id=eos, **kw)
    assert _schedule(got) == _schedule(want)
    stopped = [r for r in got if r.tokens[-1] == eos]
    assert got[1].tokens == first[1].tokens[:first[1].tokens.index(eos) + 1]
    assert any(len(r.tokens) < b for r, b in zip(stopped, BUDGETS))


def test_tied_model_serves_the_jax_tokens():
    """A tied-embedding tiny model (the train recipe's head): bridged
    without an lm_head, it serves the JAX package's greedy tokens and
    schedule."""
    jcfg = jl.tiny(dtype=jnp.float32, max_len=128, tie_embeddings=True)
    jmodel = jl.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32),
                         train=False)["params"]
    assert "lm_head" not in params
    tcfg = tl.tiny(dtype=torch.float32, max_len=128, tie_embeddings=True)
    tmodel = tl.Llama.from_params(
        tcfg, bridge.params_from_jax(tcfg, jax.tree.map(np.asarray, params)),
        device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in LENS]
    got, _, want, _ = _both((jmodel, params, tmodel, prompts), slots=2,
                            max_new_tokens=BUDGETS, block_size=4,
                            prefill_chunk=8, steps_per_sync=4)
    assert _schedule(got) == _schedule(want)


def test_sampling_is_seeded_by_the_generator(setup):
    _, _, tmodel, prompts = setup
    kw = dict(slots=2, max_new_tokens=6, block_size=4, temperature=0.9,
              top_k=20, top_p=0.9, device="cpu")
    runs = [[r.tokens for r in serve_loop(
        tmodel, prompts, generator=torch.Generator().manual_seed(s), **kw)]
        for s in (3, 3, 4)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert all(0 <= t < 256 for toks in runs[0] for t in toks)


@pytest.mark.parametrize("kw,item", [
    (dict(paged=False, cache_sharding=object()), "kv_cache_sharding"),
    (dict(paged=False, draft_cache_sharding=object()),
     "kv_cache_sharding"),
    (dict(cache_sharding=object()), "kv_cache_sharding"),
    (dict(draft_cache_sharding=object()), "kv_cache_sharding"),
])
def test_refused_options_name_their_roadmap_item(setup, kw, item):
    """A cache sharding that is not one KvCacheSharding is refused, as
    JAX refuses anything but one NamedSharding, naming where to make
    one (tensor-parallel serving itself runs:
    tests/test_torch_tp_serving.py)."""
    _, _, tmodel, prompts = setup
    with pytest.raises(ValueError, match=item):
        serve_loop(tmodel, prompts, device="cpu", **kw)


def test_speculation_does_not_hand_off(setup):
    """A draft beside prefill_only is refused with the JAX package's
    reason: the two pools would have to ship."""
    _, _, tmodel, prompts = setup
    with pytest.raises(ValueError, match="does not hand off"):
        serve_loop(tmodel, prompts, device="cpu", draft=tmodel,
                   prefill_only=True)


@pytest.mark.parametrize("kw,match", [
    (dict(prefill_chunk=6, block_size=4), "multiple of block_size"),
    (dict(pool_blocks=2, block_size=4), "grow pool_blocks"),
    (dict(max_new_tokens=[4, 4]), "one budget per request"),
    (dict(max_new_tokens=0), "max_new_tokens"),
    (dict(eos_id=256), "eos_id"),
    (dict(temperature=0.5), "generator"),
    (dict(scheduler="fifo"), "scheduler"),
    (dict(max_new_tokens=120), "max_len"),
    (dict(prefill_chunks_per_sync=1), "needs prefill_chunk"),
    (dict(prefill_chunks_per_sync=0, prefill_chunk=8, block_size=4),
     "prefill_chunks_per_sync must be >= 1"),
    (dict(prefill_only=True, adopt=[]), "two ENDS of a handoff"),
    (dict(paged=False, prefill_only=True), "paged-only"),
    (dict(paged=False, adopt=[]), "paged-only"),
    (dict(cache_len=64), "dense-ring knob"),
    (dict(prefill_only=True, scheduler="continuous"),
     "prefill_only rides the slot scheduler"),
    (dict(adopt=[], shared_prefix=[1, 2]), "adopt= refuses shared_prefix"),
    (dict(adopt=[]), "adopt has 0 handoffs for 5 requests"),
    (dict(shared_prefix=[]), "shared_prefix must be non-empty"),
    (dict(shared_prefix=[1, 2, 3], prefill_chunk=8, block_size=4),
     "shared_prefix length 3 must be a multiple of prefill_chunk 8"),
    (dict(shared_prefix=[1, 2], pool_blocks=5, block_size=4),
     r"\(\+1 shared prefix blocks\), but the pool has 5"),
])
def test_validation_matches_jax_refusals(setup, kw, match):
    _, _, tmodel, prompts = setup
    with pytest.raises(ValueError, match=match):
        serve_loop(tmodel, prompts, device="cpu", **kw)


@pytest.mark.parametrize("transform", [lambda p: p, "bf16 dequantizer"])
def test_params_transform_takes_only_the_dequantizer(setup, transform):
    """The port's model applies its own weights (int8 ones dequantized to
    cfg.dtype at each use): params_transform takes None or
    quant.make_dequantizer(cfg.dtype) and refuses any other callable,
    a dequantizer to another dtype included."""
    from tf_operator_tpu_torch.models import quant

    _, _, tmodel, prompts = setup
    if transform == "bf16 dequantizer":
        transform = quant.make_dequantizer(torch.bfloat16)
    with pytest.raises(ValueError, match="params_transform"):
        serve_loop(tmodel, prompts, device="cpu", params_transform=transform)
