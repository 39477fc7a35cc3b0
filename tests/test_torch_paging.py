"""The port's paged KV cache (tf_operator_tpu_torch.models.paging) against
the JAX package's models/paging.py: the copied host-side allocator and
block math must behave exactly like the originals, and the device-side
writes and gathers must land the same bytes in the same places."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tf_operator_tpu.models import paging as jpg
from tf_operator_tpu_torch.models import paging as tpg


# ------------------------------------------------------------- allocator
def _outcome(fn):
    """(result, None) or (None, (exception type, message))."""
    try:
        return fn(), None
    except (ValueError, RuntimeError) as e:
        return None, (type(e), str(e))


_ops = st.lists(st.tuples(st.sampled_from(["alloc", "incref", "decref"]),
                          st.integers(-1, 6), st.integers(0, 2 ** 16)),
                max_size=60)


@settings(max_examples=60, deadline=None)
@given(num_blocks=st.integers(1, 12), ops=_ops)
def test_block_pool_matches_original_under_random_ops(num_blocks, ops):
    """Any sequence of alloc / incref / decref, valid or not, gives the
    same ids, the same refusals (double free, foreign ids, exhaustion)
    and the same free list in the copy as in the original."""
    ours, theirs = tpg.BlockPool(num_blocks, 4), jpg.BlockPool(num_blocks, 4)
    held = []
    for op, n, pick in ops:
        if op == "alloc":
            a = _outcome(lambda: ours.alloc(n))
            b = _outcome(lambda: theirs.alloc(n))
            if a[0]:
                held.append(a[0])
        else:
            # an id list from what was handed out, or a foreign one
            ids = (held[pick % len(held)] if held and pick % 3
                   else [pick % (num_blocks + 3) - 1])
            a = _outcome(lambda: getattr(ours, op)(ids))
            b = _outcome(lambda: getattr(theirs, op)(ids))
        assert a == b
        assert ours._free == theirs._free and ours._ref == theirs._ref
        assert (ours.used, ours.free_blocks) == (theirs.used,
                                                 theirs.free_blocks)


def test_block_pool_alloc_order_and_refcounts():
    pool = tpg.BlockPool(num_blocks=4, block_size=8)
    ids = pool.alloc(2)
    assert ids == jpg.BlockPool(4, 8).alloc(2) == [1, 2]
    pool.incref(ids)
    pool.decref(ids)
    assert pool.used == 2
    assert pool.decref(ids) == 2 and pool.used == 0
    with pytest.raises(RuntimeError, match="double free"):
        pool.decref(ids)
    with pytest.raises(RuntimeError, match="incref"):
        pool.incref(ids)
    with pytest.raises(RuntimeError, match="double free"):
        pool.decref([0])  # the scratch block is never handed out
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(5)
    with pytest.raises(ValueError):
        tpg.BlockPool(0, 8)
    with pytest.raises(ValueError):
        tpg.BlockPool(2, 0)


@settings(deadline=None)
@given(tokens=st.integers(0, 500), bs=st.integers(1, 64))
def test_blocks_for_matches_original(tokens, bs):
    assert tpg.blocks_for(tokens, bs) == jpg.blocks_for(tokens, bs)


@settings(deadline=None)
@given(prompt=st.integers(1, 300), new=st.integers(1, 100),
       headroom=st.integers(0, 5), bs=st.integers(1, 32),
       prefix=st.integers(0, 300))
def test_plan_request_matches_original(prompt, new, headroom, bs, prefix):
    assert (tpg.plan_request(prompt, new, headroom, bs, prefix)
            == jpg.plan_request(prompt, new, headroom, bs, prefix))


def test_build_table_matches_original():
    for ids, width in (([3, 1, 2], 5), ([], 2), ([7], 1)):
        got = tpg.build_table(ids, width)
        assert got.dtype == torch.int32
        assert got.tolist() == np.asarray(jpg.build_table(ids,
                                                          width)).tolist()
    with pytest.raises(ValueError, match="exceeds width"):
        tpg.build_table([1, 2, 3], 2)


# -------------------------------------------------------- device writes
def _pools(seed, n=9, bs=4, kv=2, d=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n + 1, bs, kv, d)).astype(np.float32)


@pytest.mark.parametrize("pos,l", [
    (np.array([0, 5, 2], np.int32), 1),    # per-lane decode positions
    (np.array([3, 9, 1], np.int32), 3),    # multi-token, crossing blocks
    (np.array([7, 14, 4], np.int32), 2),   # past the table: clamped
    (2, 4),                                # one start for every row
])
def test_block_write_matches_original(pos, l):
    """Positions route through table[p // bs] at offset p % bs; past the
    table they clamp to the last column (a live lane's end-of-block
    overshoot lands in its own last block).  The frozen lane's table is
    all scratch, so its writes collide in block 0 — whose content is
    last-writer garbage no read sees; every other block must match."""
    pool = _pools(0)
    table = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
    rng = np.random.default_rng(1)
    val = rng.standard_normal((3, l, 2, 3)).astype(np.float32)
    want = np.asarray(jpg.paged_cache_write(
        jnp.asarray(pool), jnp.asarray(val), jnp.asarray(pos),
        jnp.asarray(table)))
    t_pos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
    got = torch.from_numpy(pool.copy())
    out = tpg.paged_cache_write(got, torch.from_numpy(val), t_pos,
                                torch.from_numpy(table))
    assert out is got  # in place
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])


def test_gather_blocks_matches_original():
    pool = _pools(2)
    table = np.array([[2, 7, 0], [9, 1, 4]], np.int32)
    got = tpg.gather_blocks(torch.from_numpy(pool), torch.from_numpy(table))
    want = jpg.gather_blocks(jnp.asarray(pool), jnp.asarray(table))
    assert tuple(got.shape) == (2, 12, 2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_block_pool_shapes_and_device():
    from tf_operator_tpu_torch.models import llama

    cfg = llama.tiny(n_layers=3)
    cache = tpg.init_block_pool(cfg, 5, 4, device="cpu")
    assert len(cache) == 3
    for k, v in cache:
        assert tuple(k.shape) == (6, 4, cfg.n_kv_heads, cfg.head_dim)
        assert k.dtype == v.dtype == cfg.dtype
        assert not k.any()
