"""The port's paged attention (tf_operator_tpu_torch.models.paged_attention)
against the JAX package's Pallas kernel (interpret mode on the CPU).

On the CPU the port's wrapper runs its plain version (gather_blocks +
cached_attention); the JAX side is the Pallas kernel itself, run the way
tests/test_zpagedkernel.py runs it.  Inputs are drawn with numpy from a
seed and handed to both.  f32 tolerance 2e-5: the two sum in different
orders (online softmax over blocks vs one softmax), nothing more.

The CUDA kernel runs only on a card: tests/test_torch_cuda_kernels.py
holds it against the same plain version (and skips without a card), and
chip_smoke.py does so at the serving shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import paged_attention as jpa
from tf_operator_tpu_torch.models import paged_attention as tpa

TOL = dict(rtol=2e-5, atol=2e-5)


def _case(seed, *, b, l, kv, g, d, bs, table, pos, n=None):
    rng = np.random.default_rng(seed)
    table = np.asarray(table, np.int32)
    n = n or int(table.max())
    k_pool = rng.standard_normal((n + 1, bs, kv, d)).astype(np.float32)
    v_pool = rng.standard_normal((n + 1, bs, kv, d)).astype(np.float32)
    # poison the scratch block: a masking fault would shift every output
    k_pool[0] = 1e4
    v_pool[0] = 1e4
    q = rng.standard_normal((b, l, kv * g, d)).astype(np.float32)
    return q, k_pool, v_pool, table, np.asarray(pos, np.int32)


def _both(q, k_pool, v_pool, table, pos, window=None, dtype=np.float32):
    want = jpa.paged_attention(
        jnp.asarray(q, dtype), jnp.asarray(k_pool, dtype),
        jnp.asarray(v_pool, dtype), jnp.asarray(table), jnp.asarray(pos),
        window=window)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = tpa.paged_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k_pool).to(tdt),
        torch.from_numpy(v_pool).to(tdt), torch.from_numpy(table),
        torch.from_numpy(pos), window=window)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


# lanes at ragged lengths with scratch padding; every query position stays
# inside its lane's allocated blocks (the serve loop's invariant)
RAGGED = dict(table=[[1, 2, 3, 4, 0, 0], [5, 6, 0, 0, 0, 0],
                     [7, 8, 9, 10, 11, 12]], pos=[13, 5, 21])


@pytest.mark.parametrize("l", [1, 3])
@pytest.mark.parametrize("window", [None, 6])
def test_plain_matches_pallas_ragged_lanes(l, window):
    args = _case(0, b=3, l=l, kv=2, g=2, d=8, bs=4, **RAGGED)
    got, want = _both(*args, window=window)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("window", [None, 5])
def test_plain_matches_pallas_modular_ring_table(window):
    """A modular table (sliding-window discipline): positions run past
    T*bs and the ring formula k = q - mod(q - slot, T*bs) resolves each
    slot's last-written position; floor modulo matters here, since
    q - slot is negative for slots ahead of the query in the ring."""
    table = [[3, 1, 2], [4, 5, 6]]
    args = _case(1, b=2, l=2, kv=2, g=2, d=8, bs=4, table=table,
                 pos=[17, 26])
    got, want = _both(*args, window=window)
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_matches_pallas_live_rows_beside_frozen_lane():
    """A frozen lane's table is all scratch: the Pallas kernel finalizes
    it to 0 and the plain version to a uniform average, which the serve
    loop discards either way.  Live rows agree."""
    args = _case(2, b=3, l=1, kv=2, g=2, d=8, bs=4,
                 table=[[1, 2, 3], [0, 0, 0], [4, 5, 0]], pos=[9, 5, 6])
    got, want = _both(*args)
    np.testing.assert_array_equal(want[1], np.zeros_like(want[1]))
    live = [0, 2]
    np.testing.assert_allclose(got[live], want[live], **TOL)


def test_plain_matches_pallas_bf16():
    """bf16 pools and queries: both round p to bf16 before the PV product
    (at different maxima, running vs final) and round the output to
    bf16, so they agree to a few bf16 ulps of O(1) outputs: 2e-2."""
    args = _case(3, b=3, l=3, kv=2, g=2, d=8, bs=4, **RAGGED)
    got, want = _both(*args, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_wrapper_scalar_pos_and_no_launch_on_cpu():
    """pos may be one int for every lane; CPU tensors never count as a
    kernel launch."""
    q, k_pool, v_pool, table, _ = _case(4, b=2, l=2, kv=2, g=2, d=8, bs=4,
                                        table=[[1, 2], [3, 4]], pos=[5, 5])
    tpa.reset_launches()
    args = [torch.from_numpy(a) for a in (q, k_pool, v_pool, table)]
    got_int = tpa.paged_attention(*args, 5)
    got_vec = tpa.paged_attention(*args, torch.tensor([5, 5]))
    assert torch.equal(got_int, got_vec)
    assert tpa.launches == 0


def test_wrapper_refuses_other_devices():
    q = torch.zeros((1, 1, 2, 8), device="meta")
    pool = torch.zeros((2, 4, 1, 8), device="meta")
    table = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpa.paged_attention(q, pool, pool, table, 0)
