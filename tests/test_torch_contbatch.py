"""The port's continuous scheduler (serve_loop(scheduler="continuous")),
its int8 serving and the slot loop's prefill_chunks_per_sync, against
the JAX package's serve_loop(paged=True, paged_kernel="gather") on the
CPU at tiny f32 widths.

Both run the same host schedule over the same bridged weights, so a
greedy run must give identical tokens AND identical per-request schedule
fields (the step a request went live, the step it finished, its lane and
its KV blocks) and the same scheduler counters: prompt tokens fused into
decode dispatches, preemptions, admissions blocked on memory, the pool's
peak and the wasted lane-steps.  The cases mirror
tests/test_zcontbatch.py (fused chunked prefill, preempt-to-queue under
a tight pool, int8 weights and KV) and tests/test_serving.py's int8
gate.  Sampling cannot match across jax.random and torch.Generator, so
the sampled case checks seed determinism and support only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_serving_util import one_torch_thread
from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models import quant as jq
from tf_operator_tpu.models.serving import serve_loop as jax_serve
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import quant as tq
from tf_operator_tpu_torch.models.serving import serve_loop

COUNTERS = ("fused_prefill_tokens", "preemptions",
            "admissions_blocked_on_memory", "kv_blocks_peak_used",
            "wasted_lane_steps", "total_tokens")



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
    return jmodel, params, tmodel


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lengths]


def _schedule(results):
    return [(r.tokens, r.admitted_at_step, r.finished_at_step, r.slot,
             r.kv_blocks) for r in results]


def _both(jmodel, params, tmodel, prompts, jax_kw=None, **kw):
    want, jstats = jax_serve(jmodel, params,
                             [jnp.asarray(p) for p in prompts], paged=True,
                             paged_kernel="gather", return_stats=True,
                             **(jax_kw or {}), **kw)
    got, stats = serve_loop(tmodel, prompts, device="cpu",
                            return_stats=True, **kw)
    assert _schedule(got) == _schedule(want)
    for name in COUNTERS:
        assert getattr(stats, name) == getattr(jstats, name), name
    return got, stats


def test_continuous_fused_chunked_prefill_matches_jax(setup):
    """Staggered budgets so a newcomer is admitted while a neighbour
    still decodes: its 8-token segments ride the decode dispatches."""
    jmodel, params, tmodel = setup
    prompts = _prompts([13, 6, 18, 9, 11], seed=3)
    budgets = [5, 16, 7, 12, 9]
    kw = dict(slots=2, max_new_tokens=budgets, block_size=8,
              prefill_chunk=8)
    got, stats = _both(jmodel, params, tmodel, prompts,
                       scheduler="continuous", **kw)
    assert stats.scheduler == "continuous"
    assert stats.fused_prefill_tokens > 0
    assert [len(r.tokens) for r in got] == budgets
    # the slot loop serves the same tokens
    slot = serve_loop(tmodel, prompts, device="cpu", **kw)
    assert [r.tokens for r in slot] == [r.tokens for r in got]


def test_continuous_preempts_to_queue_under_a_tight_pool(setup):
    """tests/test_zcontbatch.py's preempt-to-queue trace: budgets large
    enough that coverage growth hits a pool of 8 blocks, so lanes go
    back to the queue head, re-admit and finish with the slot loop's
    tokens; the pool's peak never passes its size."""
    jmodel, params, tmodel = setup
    prompts = _prompts([10, 14, 9, 12, 11, 13], seed=9)
    budgets = [24, 26, 20, 22, 25, 28]
    kw = dict(slots=4, max_new_tokens=budgets, block_size=8, pool_blocks=8)
    got, stats = _both(jmodel, params, tmodel, prompts,
                       scheduler="continuous", **kw)
    assert stats.preemptions > 0
    assert stats.kv_blocks_peak_used <= 8
    assert stats.admissions_blocked_on_memory > 0
    slot = serve_loop(tmodel, prompts, device="cpu", **kw)
    assert [r.tokens for r in slot] == [r.tokens for r in got]


def test_continuous_eos_matches_jax(setup):
    """An eos a run really emits: lanes freeze on the device the step
    they emit it, and the schedule still agrees."""
    jmodel, params, tmodel = setup
    prompts = _prompts([5, 13, 3, 9, 17], seed=1)
    kw = dict(slots=2, max_new_tokens=[8, 5, 9, 6, 7], block_size=4,
              prefill_chunk=8, steps_per_sync=4, scheduler="continuous")
    first = serve_loop(tmodel, prompts, device="cpu", **kw)
    eos = first[3].tokens[2]
    got, _ = _both(jmodel, params, tmodel, prompts, eos_id=eos, **kw)
    assert got[3].tokens == first[3].tokens[:first[3].tokens.index(eos) + 1]


@pytest.mark.parametrize("scheduler", ["slot", "continuous"])
def test_int8_weights_and_kv_match_jax(setup, scheduler):
    """tests/test_serving.py:108 and tests/test_zcontbatch.py:127: int8
    weights (quantize_params, dequantized to cfg.dtype at each use) and
    int8 KV, under either scheduler, with a chunked prefill.  The JAX
    side takes the quantized tree through make_dequantizer; the port's
    model takes the bridged QTensors as they are."""
    jmodel, params, _ = setup
    qp = jq.quantize_params(params)
    tcfg = tl.tiny(dtype=torch.float32, max_len=128)
    tmodel = tl.Llama.from_params(
        tcfg, bridge.params_from_jax(tcfg, jax.tree.map(np.asarray, qp)),
        device="cpu")
    prompts = _prompts([6, 9, 4, 17], seed=6)
    got, _ = _both(jmodel, qp, tmodel, prompts,
                   jax_kw=dict(params_transform=jq.make_dequantizer(
                       jnp.float32)),
                   slots=2, max_new_tokens=8, block_size=8, prefill_chunk=8,
                   kv_quant=True, scheduler=scheduler)
    assert all(len(r.tokens) == 8 for r in got)
    # the dequantizer is accepted, and is what the model already does
    again = serve_loop(tmodel, prompts, device="cpu", slots=2,
                       max_new_tokens=8, block_size=8, prefill_chunk=8,
                       kv_quant=True, scheduler=scheduler,
                       params_transform=tq.make_dequantizer(torch.float32))
    assert _schedule(again) == _schedule(got)


def test_slot_loop_prefill_chunks_per_sync_matches_jax(setup):
    """The slot loop streams at most one 4-token segment of a pending
    prompt per loop turn, with a decode block for the live lanes
    between; the tokens are those of the unbounded prefill."""
    jmodel, params, tmodel = setup
    prompts = _prompts([21, 6, 17, 30], seed=11)
    kw = dict(slots=2, max_new_tokens=[6, 9, 7, 5], block_size=4,
              prefill_chunk=4, steps_per_sync=2)
    got, _ = _both(jmodel, params, tmodel, prompts,
                   prefill_chunks_per_sync=1, **kw)
    whole = serve_loop(tmodel, prompts, device="cpu", **kw)
    assert [r.tokens for r in got] == [r.tokens for r in whole]
    assert _schedule(got) != _schedule(whole)  # the schedule did change


def test_continuous_sampling_is_seeded_by_the_generator(setup):
    _, _, tmodel = setup
    prompts = _prompts([13, 6, 18, 9], seed=12)
    kw = dict(slots=2, max_new_tokens=[5, 9, 4, 7], block_size=8,
              prefill_chunk=8, temperature=0.9, top_k=20, top_p=0.9,
              scheduler="continuous", device="cpu")
    runs = [[r.tokens for r in serve_loop(
        tmodel, prompts, generator=torch.Generator().manual_seed(s), **kw)]
        for s in (3, 3, 4)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert [len(t) for t in runs[0]] == [5, 9, 4, 7]
    assert all(0 <= t < 256 for toks in runs[0] for t in toks)
