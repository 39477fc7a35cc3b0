"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA card and nvcc; every test here carries the `cuda` marker and
skips without a card.  The file imports nothing of JAX, so it also runs
where JAX is not installed (tests/conftest.py imports it, hence
--noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

f32 tolerance 5e-5: the kernel folds blocks by online softmax, the plain
version takes one softmax, so sums run in another order.  bf16 tolerance
2e-2: both round p to bf16, at different maxima, and round the output to
bf16 (2^-8 relative).
"""
import numpy as np
import pytest
import torch

from tf_operator_tpu_torch.models import llama, paged_attention as tpa
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models.serving import serve_loop

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _case(seed, *, l, g, d, bs, table, pos, dtype):
    rng = np.random.default_rng(seed)
    table = torch.tensor(table, dtype=torch.int32)
    b, kv = table.shape[0], 2
    n = int(table.max())
    k_pool = torch.from_numpy(rng.standard_normal((n + 1, bs, kv, d)))
    v_pool = torch.from_numpy(rng.standard_normal((n + 1, bs, kv, d)))
    k_pool[0] = 1e4  # a masking fault would shift every output
    v_pool[0] = 1e4
    q = torch.from_numpy(rng.standard_normal((b, l, kv * g, d)))
    cuda = lambda t: t.to("cuda", dtype)
    return (cuda(q), cuda(k_pool), cuda(v_pool), table.cuda(),
            torch.tensor(pos, dtype=torch.int32).cuda())


RAGGED = dict(table=[[1, 2, 3, 4, 0, 0], [5, 6, 0, 0, 0, 0],
                     [7, 8, 9, 10, 11, 12]], pos=[13, 5, 21])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,g,d,window", [(1, 2, 8, None), (3, 2, 8, 6),
                                          (3, 4, 128, None),
                                          (1, 4, 128, 7)])
def test_kernel_matches_plain_ragged_lanes(dtype, l, g, d, window):
    args = _case(0, l=l, g=g, d=d, bs=4, dtype=dtype, **RAGGED)
    before = tpa.launches
    got = tpa.paged_attention(*args, window=window)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    want = tpa.paged_attention_plain(*args, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_long_prefill_modular_ring_and_frozen_lane(dtype):
    """L*G past the TPU kernel's 1024-row bound, a modular ring table
    with positions past T*bs, and a frozen lane that finalizes to 0."""
    table = [[3, 1, 2, 4, 5, 6, 7, 8], [0] * 8,
             [9, 10, 11, 12, 13, 14, 15, 16]]
    args = _case(1, l=300, g=4, d=64, bs=16, dtype=dtype, table=table,
                 pos=[140, 0, 0])
    for window in (None, 100):
        got = tpa.paged_attention(*args, window=window)
        want = tpa.paged_attention_plain(*args, window=window)
        assert bool((got[1] == 0).all())
        live = [0, 2]
        torch.testing.assert_close(got[live].float(), want[live].float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_kernel_reads_strided_queries():
    """q and out are indexed from their strides: a q sliced out of a
    wider tensor gives the same result as its contiguous copy."""
    q, k_pool, v_pool, table, pos = _case(2, l=3, g=2, d=8, bs=4,
                                          dtype=torch.float32, **RAGGED)
    wide = torch.zeros(q.shape[:3] + (2 * q.shape[3],), device="cuda")
    wide[..., :8] = q
    strided = wide[..., :8]
    assert not strided.is_contiguous()
    got = tpa.paged_attention(strided, k_pool, v_pool, table, pos)
    want = tpa.paged_attention(q, k_pool, v_pool, table, pos)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_refuses_what_it_does_not_take():
    q, k_pool, v_pool, table, pos = _case(3, l=1, g=2, d=8, bs=4,
                                          dtype=torch.float32, **RAGGED)
    with pytest.raises(TypeError, match="must match"):
        tpa.paged_attention(q, k_pool.half(), v_pool, table, pos)
    with pytest.raises(TypeError, match="float32 or"):
        tpa.paged_attention(q.half(), k_pool.half(), v_pool.half(), table,
                            pos)
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_attention(q, k_pool, v_pool, table.long(), pos)
    with pytest.raises(ValueError, match="window"):
        tpa.paged_attention(q, k_pool, v_pool, table, pos, window=0)
    with pytest.raises(ValueError, match="on cpu"):
        tpa.paged_attention(q, k_pool.cpu(), v_pool, table, pos)


def test_serve_loop_cuda_matches_cpu_tokens():
    """The tiny f32 model serves the same greedy tokens and schedule on
    the card (kernel) as on the CPU (plain version)."""
    cfg = llama.tiny(dtype=torch.float32, max_len=128)
    params = bridge.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n) for n in (5, 13, 3, 9, 17)]
    kw = dict(slots=2, max_new_tokens=[8, 5, 9, 6, 7], block_size=4,
              prefill_chunk=8, pool_blocks=7, steps_per_sync=4)
    out = []
    for dev in ("cuda", "cpu"):
        model = llama.Llama.from_params(cfg, params, device=dev)
        out.append([(r.tokens, r.admitted_at_step, r.finished_at_step,
                     r.slot, r.kv_blocks)
                    for r in serve_loop(model, prompts, device=dev, **kw)])
    assert out[0] == out[1]
