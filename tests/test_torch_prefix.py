"""Shared-prefix serving in the port (serve_loop(shared_prefix=...) and
paging.copy_block) against the JAX package's serve_loop(paged=True,
paged_kernel="gather", shared_prefix=...) on the CPU, at tiny f32 widths.

Tolerance: exact.  Both run the same host schedule over the same bridged
weights, so a greedy run gives identical tokens, the same schedule per
request (the step it went live, the step it finished, its lane, its KV
blocks, shared prefix blocks included) and the same counters, the
boundary copies and the prefix blocks reused among them.  copy_block is
held bit for bit.  The cases mirror tests/test_serving.py (prefix
equals the concatenated prompts, chunked and unchunked, CoW over f32 and
int8 pools), tests/test_paging.py (copy_block) and
tests/test_zcontbatch.py (the continuous scheduler's step gate, sharers
admitted together).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_serving_util import (int8_models, pool_pair, prompts,
                                      tiny_models)
from tf_operator_tpu.models import paging as jp
from tf_operator_tpu.models.serving import serve_loop as jax_serve
from tf_operator_tpu_torch.models import paging as tp
from tf_operator_tpu_torch.models.serving import serve_loop

COUNTERS = ("cow_copies", "prefix_block_hits", "fused_prefill_tokens",
            "preemptions", "admissions_blocked_on_memory",
            "kv_blocks_peak_used", "wasted_lane_steps", "total_tokens")


@pytest.fixture(scope="module")
def setup():
    return tiny_models()


def _schedule(results):
    return [(r.tokens, r.admitted_at_step, r.finished_at_step, r.slot,
             r.kv_blocks) for r in results]


def _both(jmodel, params, tmodel, sufs, pfx, jax_params=None, jax_kw=None,
          **kw):
    """The JAX package's and the port's prefix runs: schedule and
    counters equal."""
    want, jstats = jax_serve(jmodel, jax_params or params,
                             [jnp.asarray(s) for s in sufs], paged=True,
                             paged_kernel="gather",
                             shared_prefix=jnp.asarray(pfx),
                             return_stats=True, **(jax_kw or {}), **kw)
    got, stats = serve_loop(tmodel, sufs, shared_prefix=pfx, device="cpu",
                            return_stats=True, **kw)
    assert _schedule(got) == _schedule(want)
    for name in COUNTERS:
        assert getattr(stats, name) == getattr(jstats, name), name
    return got, stats


# name: (prefix length, suffix lengths, serve_loop keywords)
CASES = {
    # 10 % 4 != 0: every admission copies the boundary block
    "cow_unchunked": (10, [5, 9, 3, 7, 6], dict(block_size=4)),
    "chunked": (16, [5, 9, 3, 7], dict(block_size=4, prefill_chunk=8)),
    "chunked_one_segment_a_turn": (16, [5, 9, 3, 7], dict(
        block_size=4, prefill_chunk=8, prefill_chunks_per_sync=1)),
    "continuous_chunked": (16, [5, 9, 3, 7], dict(
        block_size=8, prefill_chunk=8, scheduler="continuous")),
    "continuous_cow_unchunked": (10, [5, 9, 3, 7, 6], dict(
        block_size=4, scheduler="continuous")),
    # a pool of 14: coverage growth preempts lanes holding prefix blocks
    "continuous_preempts": (16, [6, 14, 9, 12, 11], dict(
        slots=3, block_size=4, scheduler="continuous", pool_blocks=14,
        max_new_tokens=[20, 22, 18, 24, 21])),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prefix_serving_matches_jax(setup, case):
    """Tokens, schedule and counters equal the JAX package's, and the
    tokens equal the port's own serving of the concatenated prompts."""
    jmodel, params, tmodel = setup
    p_len, lens, extra = CASES[case]
    pfx = prompts([p_len], seed=3)[0]
    sufs = prompts(lens, seed=4)
    kw = dict(dict(slots=2, max_new_tokens=8), **extra)
    got, stats = _both(jmodel, params, tmodel, sufs, pfx, **kw)
    n_shared = p_len // kw["block_size"]
    assert stats.prefix_block_hits >= n_shared * len(sufs)
    if p_len % kw["block_size"]:
        assert stats.cow_copies == len(sufs)
    if case == "continuous_preempts":
        assert stats.preemptions > 0
        assert stats.admissions_blocked_on_memory > 0
        assert stats.kv_blocks_peak_used <= 14
    # serving the suffixes over the prefix emits what serving the whole
    # prompts emits
    full = serve_loop(tmodel, [np.concatenate([pfx, s]) for s in sufs],
                      device="cpu", **kw)
    assert [r.tokens for r in got] == [r.tokens for r in full]
    # kv_blocks counts the shared blocks too
    assert all(r.kv_blocks >= n_shared for r in got)


@pytest.mark.parametrize("scheduler", ["slot", "continuous"])
def test_int8_kv_prefix_cow_matches_jax(setup, scheduler):
    """tests/test_paging.py:136 with int8 weights and KV: the unaligned
    prefix's boundary block is copied payload and scales alike, under
    either scheduler."""
    jmodel, params, _ = setup
    qp, tmodel, jkw = int8_models(params)
    pfx = prompts([10], seed=3)[0]
    sufs = prompts([5, 9, 3, 7, 6], seed=4)
    _, stats = _both(jmodel, params, tmodel, sufs, pfx, jax_params=qp,
                     jax_kw=jkw,
                     slots=2, max_new_tokens=8, block_size=4, kv_quant=True,
                     scheduler=scheduler)
    assert stats.cow_copies == 5
    assert stats.prefix_block_hits == 2 * 5


@pytest.mark.parametrize("scheduler", ["slot", "continuous"])
def test_prefix_sharers_admit_concurrently(setup, scheduler):
    """tests/test_zcontbatch.py:232: three suffixes over an aligned
    4-block prefix admit together into a pool of 10 (the prefix once
    plus 2 private blocks each); a gate that charged each sharer the
    prefix again would hold two of them."""
    jmodel, params, tmodel = setup
    pfx = prompts([64], seed=10)[0]
    sufs = prompts([16, 16, 16], seed=11)
    got, stats = _both(jmodel, params, tmodel, sufs, pfx, slots=3,
                       max_new_tokens=16, block_size=16, pool_blocks=10,
                       scheduler=scheduler)
    assert stats.admissions_blocked_on_memory == 0
    assert [r.admitted_at_step for r in got] == [0, 0, 0]
    assert [r.kv_blocks for r in got] == [6, 6, 6]


def _bytes_of(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(leaf)).tobytes()


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_copy_block_matches_jax_bits(kind):
    """tests/test_paging.py:120: copy_block copies one block across every
    layer's (k, v) pools, payload and scales of an int8 pool alike; the
    port's pools equal JAX's bit for bit afterwards, and the source
    block is unchanged."""
    jcache, tcache = pool_pair(kind)
    src_before = [_bytes_of(t[2]) for t in tp._leaves(tcache)]
    jout = jp.copy_block(jcache, jnp.int32(2), jnp.int32(5))
    tout = tp.copy_block(tcache, 2, 5)
    jleaves = jax.tree.leaves(jout)
    tleaves = tp._leaves(tout)
    assert len(jleaves) == len(tleaves) == (8 if kind == "int8" else 4)
    for j, t, before in zip(jleaves, tleaves, src_before):
        assert _bytes_of(t) == _bytes_of(j)
        assert _bytes_of(t[5]) == _bytes_of(t[2]) == before


@pytest.mark.parametrize("kw,match", [
    (dict(prefill_chunk=8), "multiple of"),
    (dict(empty_prefix=True), "non-empty"),
    (dict(empty_suffix=True), "suffix token"),
])
def test_prefix_validation_matches_jax_wording(setup, kw, match):
    """tests/test_serving.py:477's three refusals, with the JAX
    package's words."""
    jmodel, params, tmodel = setup
    pfx = prompts([10], seed=3)[0]
    sufs = prompts([5], seed=4)
    if kw.pop("empty_prefix", False):
        pfx = np.zeros((0,), np.int32)
    if kw.pop("empty_suffix", False):
        sufs = [np.zeros((0,), np.int32)]
    with pytest.raises(ValueError, match=match) as jerr:
        jax_serve(jmodel, params, [jnp.asarray(s) for s in sufs], paged=True,
                  shared_prefix=jnp.asarray(pfx), **kw)
    with pytest.raises(ValueError, match=match) as terr:
        serve_loop(tmodel, sufs, shared_prefix=pfx, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)
