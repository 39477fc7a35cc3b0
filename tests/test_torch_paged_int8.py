"""int8 KV in the port's paged path against the JAX package on the CPU:
the int8 pool layout, the quantizing block write, the int8 gather, the
continuous scheduler's gate helpers, and K1q's plain version
(paged_attention_int8_plain) against the Pallas int8 kernel in interpret
mode (tests/test_zpagedkernel.py's way of running it).

The write is bit for bit (the same quantization of the same values).
The attention: f32 tolerance 2e-5, as the float kernel's (online softmax
over blocks vs one softmax); both sides dequantize to q's dtype before
the products, so bf16 keeps the float kernel's 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models import paged_attention as jpa
from tf_operator_tpu.models import paging as jpg
from tf_operator_tpu.models import quant as jq
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import paged_attention as tpa
from tf_operator_tpu_torch.models import paging as tpg
from tf_operator_tpu_torch.models import quant as tq

TOL = {np.float32: 2e-5, jnp.bfloat16: 2e-2}


def _qpool(seed, n, bs, kv, d):
    """An int8 pool from float draws, with the scratch block poisoned
    (payload 127, scale 1e4): a masking fault would shift every output."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((n + 1, bs, kv, d)).astype(np.float32)
    jqt = jq.quantize_tensor(pool, axes=(3,))
    q = np.asarray(jqt.q).copy()
    scale = np.asarray(jqt.scale).copy()
    q[0] = 127
    scale[0] = 1e4
    return q, scale


def _both(q, kp, vp, table, pos, window=None, dtype=np.float32):
    want = jpa.paged_attention(
        jnp.asarray(q, dtype),
        jq.QTensor(jnp.asarray(kp[0]), jnp.asarray(kp[1])),
        jq.QTensor(jnp.asarray(vp[0]), jnp.asarray(vp[1])),
        jnp.asarray(table), jnp.asarray(pos), window=window)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = tpa.paged_attention(
        torch.from_numpy(q).to(tdt),
        tq.QTensor(torch.from_numpy(kp[0]), torch.from_numpy(kp[1])),
        tq.QTensor(torch.from_numpy(vp[0]), torch.from_numpy(vp[1])),
        torch.from_numpy(np.asarray(table, np.int32)),
        torch.from_numpy(np.asarray(pos, np.int32)), window=window)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


RAGGED = dict(table=[[1, 2, 3, 4, 0, 0], [5, 6, 0, 0, 0, 0],
                     [7, 8, 9, 10, 11, 12]], pos=[13, 5, 21])


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("l,window", [(1, None), (3, None), (1, 6),
                                      (3, 6)])
def test_int8_plain_matches_pallas_ragged_lanes(dtype, l, window):
    rng = np.random.default_rng(l * 10 + (window or 0))
    q = rng.standard_normal((3, l, 4, 8)).astype(np.float32)
    kp, vp = _qpool(1, 12, 4, 2, 8), _qpool(2, 12, 4, 2, 8)
    got, want = _both(q, kp, vp, RAGGED["table"], RAGGED["pos"],
                      window=window, dtype=dtype)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("window", [None, 5])
def test_int8_plain_matches_pallas_modular_ring_table(window):
    """Positions past T*bs on a modular table: the ring formula with
    floor modulo, over int8 blocks."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 2, 4, 8)).astype(np.float32)
    kp, vp = _qpool(3, 6, 4, 2, 8), _qpool(4, 6, 4, 2, 8)
    got, want = _both(q, kp, vp, [[3, 1, 2], [4, 5, 6]], [17, 26],
                      window=window)
    np.testing.assert_allclose(got, want, rtol=TOL[np.float32],
                               atol=TOL[np.float32])


def test_int8_plain_live_rows_beside_frozen_lane():
    """A frozen lane's all-scratch table: the Pallas kernel finalizes it
    to 0 (so does K1q on the card); the plain version averages, and the
    serve loop discards it.  Live rows agree."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    kp, vp = _qpool(5, 5, 4, 2, 8), _qpool(6, 5, 4, 2, 8)
    got, want = _both(q, kp, vp, [[1, 2, 3], [0, 0, 0], [4, 5, 0]],
                      [9, 5, 6])
    np.testing.assert_array_equal(want[1], np.zeros_like(want[1]))
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]],
                               rtol=TOL[np.float32], atol=TOL[np.float32])


def test_int8_plain_is_the_float_read_of_the_dequantized_pools():
    """paged_attention_int8_plain = paged_attention_plain over pools
    dequantized to q's dtype (bits), and the CPU wrapper routes QTensor
    pools to it without counting a launch."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((3, 2, 4, 8))).bfloat16()
    kp, vp = (tq.QTensor(*map(torch.from_numpy, _qpool(s, 12, 4, 2, 8)))
              for s in (10, 11))
    table = torch.tensor(RAGGED["table"], dtype=torch.int32)
    pos = torch.tensor(RAGGED["pos"], dtype=torch.int32)
    tpa.reset_launches()
    got = tpa.paged_attention(q, kp, vp, table, pos)
    want = tpa.paged_attention_plain(q, kp.dequantize(torch.bfloat16),
                                     vp.dequantize(torch.bfloat16), table,
                                     pos)
    assert torch.equal(got, want)
    assert tpa.launches == tpa.launches_int8 == 0
    with pytest.raises(TypeError, match="QTensor"):
        tpa.paged_attention_int8_plain(q, kp.dequantize(), vp, table, pos)


# ----------------------------------------------------------------- pools
def test_init_block_pool_kv_quant_layout():
    cfg = tl.tiny(n_layers=2)
    cache = tpg.init_block_pool(cfg, 5, 4, device="cpu", kv_quant=True)
    jcache = jpg.init_block_pool(jl.tiny(n_layers=2), 5, 4, kv_quant=True)
    assert len(cache) == 2
    for (k, v), (jk, _) in zip(cache, jcache):
        for p in (k, v):
            assert isinstance(p, tq.QTensor)
            assert p.q.dtype == torch.int8 and not p.q.any()
            assert p.scale.dtype == torch.float32
            assert bool((p.scale == 1.0).all())
        assert tuple(k.q.shape) == tuple(jk.q.shape) == (6, 4, 2, 16)
        assert tuple(k.scale.shape) == tuple(jk.scale.shape) == (6, 4, 2, 1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tpg.init_block_pool(cfg, 5, 4, dtype=torch.float32, device="cpu",
                            kv_quant=True)


@pytest.mark.parametrize("pos,l", [
    (np.array([0, 5, 2], np.int32), 1),    # per-lane decode positions
    (np.array([3, 9, 1], np.int32), 3),    # multi-token, crossing blocks
    (np.array([7, 14, 4], np.int32), 2),   # past the table: clamped
    (2, 4),                                # one start for every row
])
def test_int8_block_write_matches_jax_bit_for_bit(pos, l):
    """The write quantizes over head_dim and stores payload and scale
    through one index, as JAX's paged_cache_write on a QTensor pool.
    Block 0 (the frozen lane's scratch) is last-writer garbage on both
    sides; every other block matches in payload and scale."""
    rng = np.random.default_rng(12)
    kq, ks = _qpool(13, 9, 4, 2, 16)
    table = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
    val = (rng.standard_normal((3, l, 2, 16)) * 3).astype(np.float32)
    val[0, 0, 1] = 0.0  # an all-zero (position, head): scale 1
    want = jpg.paged_cache_write(
        jq.QTensor(jnp.asarray(kq), jnp.asarray(ks)), jnp.asarray(val),
        jnp.asarray(pos), jnp.asarray(table))
    pool = tq.QTensor(torch.from_numpy(kq.copy()), torch.from_numpy(ks.copy()))
    t_pos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
    out = tpg.paged_cache_write(pool, torch.from_numpy(val), t_pos,
                                torch.from_numpy(table))
    assert out is pool
    np.testing.assert_array_equal(pool.q.numpy()[1:],
                                  np.asarray(want.q)[1:])
    np.testing.assert_array_equal(pool.scale.numpy()[1:],
                                  np.asarray(want.scale)[1:])


def test_int8_gather_matches_jax():
    kq, ks = _qpool(14, 9, 4, 2, 16)
    table = np.array([[2, 7, 0], [9, 1, 4]], np.int32)
    got = tpg.gather_blocks(tq.QTensor(torch.from_numpy(kq),
                                       torch.from_numpy(ks)),
                            torch.from_numpy(table))
    want = jpg.gather_blocks(jq.QTensor(jnp.asarray(kq), jnp.asarray(ks)),
                             jnp.asarray(table))
    assert isinstance(got, tq.QTensor)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


# ------------------------------------------- the continuous gate helpers
@pytest.mark.parametrize("bs", [1, 4, 16])
def test_blocks_to_cover_and_step_gate_match_jax(bs):
    for upto in range(0, 70, 3):
        for covered in range(0, 8):
            assert tpg.blocks_to_cover(upto, covered, bs) == \
                jpg.blocks_to_cover(upto, covered, bs)
    for free in range(0, 9):
        for need in range(0, 5):
            for lanes in range(0, 5):
                for ladder in (1, 2):
                    assert tpg.step_gate(free, need, lanes, ladder) == \
                        jpg.step_gate(free, need, lanes, ladder)
