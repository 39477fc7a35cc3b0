"""The decode split of the tensor-core paged-attention kernel, on the CPU.

At most 16 query rows per (kv head, lane) (decode), bf16 queries on the
card cut each lane's block table into chunks of `split_slots` slots; one
block per chunk writes a partial (m, l, unnormalized acc) and a second
kernel merges a row's chunks in chunk order.  Here:

  - the host rule (`split_slots`, `chunk_bounds`) covers every table
    slot exactly once, for any table, block size and grid (hypothesis);
  - the split algorithm written plainly in PyTorch
    (`paged_attention_split_plain`) equals the JAX package's Pallas
    kernel (`tf_operator_tpu.models.paged_attention.paged_attention`, in
    interpret mode on the CPU as tests/test_zpagedkernel.py runs it) on
    ragged lanes, a frozen lane, windows that empty whole chunks, modular
    ring tables and int8 pools.  f32 tolerance 1e-5: the two fold the
    same terms in another order (chunk partials merged by their maxima
    vs one online softmax over blocks).

Inputs are drawn with numpy from a seed and handed to both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tf_operator_tpu.models import paged_attention as jpa
from tf_operator_tpu.models import quant as jq
from tf_operator_tpu_torch.models import paged_attention as tpa
from tf_operator_tpu_torch.models import quant as tq

TOL = dict(rtol=1e-5, atol=1e-5)


@settings(max_examples=200, deadline=None)
@given(n_slots=st.integers(1, 300), bs=st.sampled_from([1, 4, 16, 64, 128]),
       rows=st.integers(1, 16), programs=st.integers(1, 2048))
def test_chunks_cover_every_slot_once(n_slots, bs, rows, programs):
    spc = tpa.split_slots(rows, n_slots, bs, programs)
    assert spc >= 1
    # whole 64-key tiles of at least SPLIT_MIN_KEYS keys (bs divides them)
    # or whole slots past them
    assert spc * bs >= tpa.SPLIT_MIN_KEYS
    seen = [s for lo, hi in tpa.chunk_bounds(n_slots, spc)
            for s in range(lo, hi)]
    assert seen == list(range(n_slots))
    # the kernel's chunk c starts at slot c * spc
    assert [lo for lo, _ in tpa.chunk_bounds(n_slots, spc)] == \
        list(range(0, n_slots, spc))


@pytest.mark.parametrize("rows", [17, 64, 2048])
def test_more_than_sixteen_rows_do_not_split(rows):
    assert tpa.split_slots(rows, 68, 16, 64) == 0


def test_split_rule_at_the_decode_shape():
    """llama3_8b decode, 8 lanes x 8 kv heads over 68 slots of 16: chunks
    of 128 keys (9 of them, 576 blocks, past 4 per SM of 132); a short
    table stays one chunk; one lane over a long table takes chunks of 512
    keys (128 chunks x 8 kv heads = 1024 blocks: at 1024 keys the grid
    would fall to 512, under 528)."""
    assert tpa.split_slots(4, 68, 16, 64) == 8
    assert len(tpa.chunk_bounds(68, 8)) == 9
    assert tpa.split_slots(4, 4, 16, 64) == 8  # one chunk covers it
    assert tpa.split_slots(1, 1024, 16, 8) == 8
    assert tpa.split_slots(4, 4096, 16, 8) == 32


def _pools(seed, n, bs, kv, d):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((n + 1, bs, kv, d)).astype(np.float32)
    v = rng.standard_normal((n + 1, bs, kv, d)).astype(np.float32)
    k[0] = 1e4  # poisoned scratch: a masking fault would show
    v[0] = 1e4
    return k, v


def _qtensor(pool, module):
    """int8 pool over head_dim with the scratch block poisoned (payload
    127, scale 1e4), as numpy arrays for either package's QTensor."""
    jqt = jq.quantize_tensor(pool, axes=(3,))
    q, scale = np.asarray(jqt.q).copy(), np.asarray(jqt.scale).copy()
    q[0], scale[0] = 127, 1e4
    if module == "jax":
        return jq.QTensor(jnp.asarray(q), jnp.asarray(scale))
    return tq.QTensor(torch.from_numpy(q), torch.from_numpy(scale))


def _both(q, k, v, table, pos, *, window, spc, int8=False):
    table = np.asarray(table, np.int32)
    pos = np.asarray(pos, np.int32)
    if int8:
        jk, jv = _qtensor(k, "jax"), _qtensor(v, "jax")
        tk, tv = _qtensor(k, "torch"), _qtensor(v, "torch")
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    want = jpa.paged_attention(jnp.asarray(q), jk, jv, jnp.asarray(table),
                               jnp.asarray(pos), window=window)
    got = tpa.paged_attention_split_plain(
        torch.from_numpy(q), tk, tv, torch.from_numpy(table),
        torch.from_numpy(pos), slots_per_chunk=spc, window=window)
    return got.numpy(), np.asarray(want)


# lane 0 long, lane 1 frozen (all scratch), lane 2 short, lane 3 ending on
# a chunk boundary (spc = 2 slots of 4)
TABLE = [[1, 2, 3, 4, 5, 6, 7, 0], [0] * 8, [8, 9, 0, 0, 0, 0, 0, 0],
         [10, 11, 12, 13, 0, 0, 0, 0]]
POS = [26, 0, 5, 15]


@pytest.mark.parametrize("spc", [1, 3, 8])
@pytest.mark.parametrize("l,g", [(1, 4), (3, 4), (16, 1)])
@pytest.mark.parametrize("window", [None, 6])
def test_split_matches_pallas_ragged_and_frozen(spc, l, g, window):
    """Ragged lanes, a frozen lane (every chunk scratch: the row
    finalizes to 0), contexts inside the first chunk and on a chunk
    boundary, and a window of 6 that leaves lane 0's first chunks
    empty; L*G = 4, 12 and 16 rows."""
    k, v = _pools(spc * 10 + l, 13, 4, 2, 8)
    q = np.random.default_rng(l).standard_normal(
        (4, l, 2 * g, 8)).astype(np.float32)
    pos = [max(p - l + 1, 0) for p in POS]
    got, want = _both(q, k, v, TABLE, pos, window=window, spc=spc)
    np.testing.assert_array_equal(got[1], np.zeros_like(got[1]))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("spc", [1, 2, 3])
@pytest.mark.parametrize("window", [None, 5])
def test_split_matches_pallas_modular_ring_table(spc, window):
    """Positions past T*bs on a modular table: each chunk's keys resolve
    through k = q - mod(q - slot, T*bs), so a chunk may hold the ring's
    newest and oldest positions at once."""
    k, v = _pools(40 + spc, 6, 4, 2, 8)
    q = np.random.default_rng(41).standard_normal(
        (2, 2, 4, 8)).astype(np.float32)
    got, want = _both(q, k, v, [[3, 1, 2], [4, 5, 6]], [17, 26],
                      window=window, spc=spc)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("spc", [1, 2, 8])
@pytest.mark.parametrize("window", [None, 6])
def test_split_matches_pallas_int8_pools(spc, window):
    """int8 pools: both dequantize (payload * scale, in q's dtype) before
    the products; the poisoned scratch block stays masked."""
    k, v = _pools(50 + spc, 13, 4, 2, 8)
    q = np.random.default_rng(51).standard_normal(
        (4, 1, 4, 8)).astype(np.float32)
    got, want = _both(q, k, v, TABLE, POS, window=window, spc=spc,
                      int8=True)
    np.testing.assert_allclose(got, want, **TOL)


def test_split_equals_the_plain_version_on_live_rows():
    """On lanes with visible keys the split's plain form and the wrapper's
    plain version (one softmax over the gathered view) agree at every
    chunk size; the CPU wrapper never counts a launch."""
    k, v = _pools(60, 13, 4, 2, 8)
    q = torch.from_numpy(np.random.default_rng(61).standard_normal(
        (4, 1, 4, 8)).astype(np.float32))
    args = (torch.from_numpy(k), torch.from_numpy(v),
            torch.tensor(TABLE, dtype=torch.int32),
            torch.tensor(POS, dtype=torch.int32))
    tpa.reset_launches()
    want = tpa.paged_attention(q, *args)
    for spc in (1, 2, 5, 8):
        got = tpa.paged_attention_split_plain(q, *args, slots_per_chunk=spc)
        torch.testing.assert_close(got[[0, 2, 3]], want[[0, 2, 3]], **TOL)
    assert tpa.launches == tpa.launches_mma == 0
