"""The port's CUDA kernels on the card, against their plain versions:
K1 (paged attention), K1q (paged attention over int8 pools),
K2f/K2q/K2kv (flash attention forward, dQ and dK/dV) and K3f/K3q/K3kv
(the ring flash attention steps); the shared-prefix and handoff block
operations (copy_block, scatter_blocks, export_blocks, adopt_blocks) on
the card against the CPU's bits; and dense-ring decoding (generate,
speculative_generate, serve_loop(paged=False)) on the card against the
CPU's tokens.

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
from tf_operator_tpu_torch.models import bridge, quant
from tf_operator_tpu_torch.models.serving import serve_loop
from tf_operator_tpu_torch.ops import flash_attention as tfa
from tf_operator_tpu_torch.ops import ring_flash as trf
from tf_operator_tpu_torch.ops import zigzag
from tf_operator_tpu_torch.parallel.ring import LocalRing

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


# the decode split's edges: with 8 lanes x 2 kv heads over 12 slots of 16
# (192 keys) the rule takes chunks of 8 slots (128 keys), so lane 1 ends
# inside the first chunk, lane 2 on the chunk boundary, lane 3 inside the
# second chunk and lane 4 at the table's end; lane 5 is frozen (every
# chunk scratch)
SPLIT_EDGE = dict(
    table=[[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12],
           [13, 14, 15, 0, 0, 0, 0, 0, 0, 0, 0, 0],
           [16, 17, 18, 19, 20, 21, 22, 23, 0, 0, 0, 0],
           [24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 0, 0],
           [34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45],
           [0] * 12],
    pos=[150, 40, 127, 150, 191, 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,g,window", [(1, 4, None), (1, 4, 100),
                                        (4, 4, None), (16, 1, None),
                                        (17, 1, None), (16, 1, 30)])
def test_kernel_split_edges(dtype, l, g, window):
    """Contexts ending inside the first chunk, on a chunk boundary and
    inside a chunk, a frozen lane whose chunks are all scratch (it
    finalizes to 0), a window that empties whole chunks, and L*G = 4, 16
    (the largest split) and 17 rows (direct); two launches give the same
    bits and count one call each, on the tensor cores in bf16."""
    pos = [max(p - l + 1, 0) for p in SPLIT_EDGE["pos"]]
    args = _case(10 + l, l=l, g=g, d=128, bs=16, dtype=dtype,
                 table=SPLIT_EDGE["table"], pos=pos)
    rows = l * g
    if dtype == torch.bfloat16:
        assert (tpa.split_slots(rows, 12, 16, 2 * 6) == 8) == (rows <= 16)
    before = (tpa.launches, tpa.launches_mma)
    got = tpa.paged_attention(*args, window=window)
    again = tpa.paged_attention(*args, window=window)
    torch.cuda.synchronize()
    mma = 2 if dtype == torch.bfloat16 else 0
    assert (tpa.launches, tpa.launches_mma) == (before[0] + 2,
                                                before[1] + mma)
    assert torch.equal(got, again)
    assert bool((got[5] == 0).all())
    want = tpa.paged_attention_plain(*args, window=window)
    live = [0, 1, 2, 3, 4]
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _wrapped_ring(l):
    """The window phase's tables: 288-slot modular rings of 16-position
    blocks (4608 positions) at window 4096.  Lanes 0-4 have wrapped
    (contexts 4609 to 7815, their rings permuted blocks), lane 5 has not
    (4200: 263 slots, the rest scratch), lane 6 is frozen (all scratch)."""
    n_slots, bs = 288, 16
    ctx = [4609, 5000, 6144, 7000, 7815, 4200]
    rng = np.random.default_rng(21)
    ids = (rng.permutation(6 * n_slots) + 1).tolist()
    table = []
    for i, c in enumerate(ctx):
        used = min(n_slots, -(-c // bs))
        table.append(ids[i * n_slots:i * n_slots + used]
                     + [0] * (n_slots - used))
    table.append([0] * n_slots)
    return table, [c - l for c in ctx] + [0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [1, 512])
def test_kernel_wrapped_window_ring(dtype, l):
    """K1 at the window phase's shapes (head_dim 128, G = 4) over rings
    that have wrapped, at window 4096: decode (L=1, split over the table
    in bf16, where whole chunks hold only positions that left the
    window) and a 512-token segment streamed past the ring; the frozen
    lane finalizes to 0, two launches give the same bits."""
    table, pos = _wrapped_ring(l)
    args = _case(30 + l, l=l, g=4, d=128, bs=16, dtype=dtype, table=table,
                 pos=pos)
    before = tpa.launches
    got = tpa.paged_attention(*args, window=4096)
    again = tpa.paged_attention(*args, window=4096)
    torch.cuda.synchronize()
    assert tpa.launches == before + 2
    assert torch.equal(got, again)
    assert bool((got[6] == 0).all())
    want = tpa.paged_attention_plain(*args, window=4096)
    live = [0, 1, 2, 3, 4, 5]
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [1, 40])
def test_kernel_block_size_64(dtype, l):
    """serve_loop's default block size: one pool block is one key tile."""
    table = [[1, 2, 3, 0], [4, 5, 6, 7], [8, 0, 0, 0]]
    args = _case(20 + l, l=l, g=4, d=128, bs=64, dtype=dtype, table=table,
                 pos=[150 - l, 250 - l, 60 - l])
    got = tpa.paged_attention(*args)
    assert torch.equal(got, tpa.paged_attention(*args))
    want = tpa.paged_attention_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_kernel_split_edges(dtype):
    """K1q on the split's edges (as test_kernel_split_edges), int8 pools
    with the scratch block poisoned; the bf16 call counts on the tensor
    cores."""
    q, k_pool, v_pool, table, pos = _case(
        30, l=1, g=4, d=128, bs=16, dtype=dtype, **SPLIT_EDGE)
    kq, vq = _int8_pools(k_pool, v_pool)
    before = tpa.launches_int8_mma
    got = tpa.paged_attention(q, kq, vq, table, pos, window=100)
    assert torch.equal(got, tpa.paged_attention(q, kq, vq, table, pos,
                                                window=100))
    torch.cuda.synchronize()
    assert tpa.launches_int8_mma == before + (
        2 if dtype == torch.bfloat16 else 0)
    assert bool((got[5] == 0).all())
    want = tpa.paged_attention_int8_plain(q, kq, vq, table, pos, window=100)
    torch.testing.assert_close(got[:5].float(), want[:5].float(),
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


# ------------------------------------------------------------------ K1q
def _int8_pools(k_pool, v_pool):
    """int8 pools quantized over head_dim from float draws, with the
    scratch block poisoned (payload 127, scale 1e4)."""
    out = []
    for p in (k_pool, v_pool):
        qt = quant.quantize_tensor(p.float(), axes=(3,))
        qt.q[0] = 127
        qt.scale[0] = 1e4
        out.append(qt)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,g,d,window", [(1, 2, 8, None), (3, 2, 8, 6),
                                          (3, 4, 128, None),
                                          (1, 4, 128, 7)])
def test_int8_kernel_matches_plain_ragged_lanes(dtype, l, g, d, window):
    """K1q against paged_attention_int8_plain: the same dequantized
    values (rounded to q's dtype before the products), so the K1
    tolerances hold; two launches give the same bits."""
    q, k_pool, v_pool, table, pos = _case(5, l=l, g=g, d=d, bs=4,
                                          dtype=dtype, **RAGGED)
    kq, vq = _int8_pools(k_pool, v_pool)
    before = (tpa.launches, tpa.launches_int8)
    got = tpa.paged_attention(q, kq, vq, table, pos, window=window)
    again = tpa.paged_attention(q, kq, vq, table, pos, window=window)
    torch.cuda.synchronize()
    assert (tpa.launches, tpa.launches_int8) == (before[0], before[1] + 2)
    assert torch.equal(got, again)
    want = tpa.paged_attention_int8_plain(q, kq, vq, table, pos,
                                          window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_kernel_long_prefill_ring_and_frozen_lane(dtype):
    table = [[3, 1, 2, 4, 5, 6, 7, 8], [0] * 8,
             [9, 10, 11, 12, 13, 14, 15, 16]]
    q, k_pool, v_pool, tbl, pos = _case(6, l=300, g=4, d=64, bs=16,
                                        dtype=dtype, table=table,
                                        pos=[140, 0, 0])
    kq, vq = _int8_pools(k_pool, v_pool)
    for window in (None, 100):
        got = tpa.paged_attention(q, kq, vq, tbl, pos, window=window)
        want = tpa.paged_attention_int8_plain(q, kq, vq, tbl, pos,
                                              window=window)
        assert bool((got[1] == 0).all())
        torch.testing.assert_close(got[[0, 2]].float(),
                                   want[[0, 2]].float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])


def test_int8_kernel_refuses_what_it_does_not_take():
    q, k_pool, v_pool, table, pos = _case(7, l=1, g=2, d=8, bs=4,
                                          dtype=torch.float32, **RAGGED)
    kq, vq = _int8_pools(k_pool, v_pool)
    with pytest.raises(TypeError, match="both be QTensor"):
        tpa.paged_attention(q, kq, v_pool, table, pos)
    bad = quant.QTensor(kq.q, kq.scale.double())
    with pytest.raises(ValueError, match="scales"):
        tpa.paged_attention(q, bad, vq, table, pos)
    with pytest.raises(ValueError, match="on cpu"):
        tpa.paged_attention(q, kq.to("cpu"), vq, table, pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_on_the_card_gives_the_two_pass_bits(dtype):
    """QTensor.dequantize takes the f32 product and rounds it as it is
    stored, in one pass: the bits of (q.float() * scale).to(dtype)."""
    g = torch.Generator(device="cpu").manual_seed(8)
    w = torch.randn((256, 2, 300), generator=g) * torch.rand(
        (1, 2, 300), generator=g)
    qt = quant.quantize_tensor(w.cuda(), axes=(0,))
    want = (qt.q.float() * qt.scale).to(dtype)
    assert torch.equal(qt.dequantize(dtype), want)


@pytest.mark.parametrize("scheduler", ["slot", "continuous"])
def test_int8_serve_loop_cuda_matches_cpu_tokens(scheduler):
    """int8 weights and int8 KV: the tiny f32 model serves the same
    greedy tokens and schedule on the card (K1q) as on the CPU."""
    cfg = llama.tiny(dtype=torch.float32, max_len=128)
    params = quant.quantize_params(bridge.init_params(cfg, seed=0,
                                                      device="cpu",
                                                      train=True))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n) for n in (5, 13, 3, 9, 17)]
    kw = dict(slots=2, max_new_tokens=[8, 5, 9, 6, 7], block_size=4,
              prefill_chunk=8, pool_blocks=7, steps_per_sync=4,
              kv_quant=True, scheduler=scheduler)
    out = []
    for dev in ("cuda", "cpu"):
        model = llama.Llama.from_params(
            cfg, {k: v.to(dev) for k, v in params.items()}, device=dev)
        before = tpa.launches
        out.append([(r.tokens, r.admitted_at_step, r.finished_at_step,
                     r.slot, r.kv_blocks)
                    for r in serve_loop(model, prompts, device=dev, **kw)])
        assert tpa.launches == before  # int8 pools never reach K1
    assert out[0] == out[1]


# ------------------------------------------------------------ dense rings
def _dense_models():
    cfg = llama.tiny(dtype=torch.float32, max_len=128)
    params = bridge.init_params(cfg, seed=0, device="cpu")
    return {dev: llama.Llama.from_params(
        cfg, {k: v.to(dev) for k, v in params.items()}, device=dev)
        for dev in ("cuda", "cpu")}


@pytest.mark.parametrize("kv_quant", [False, True])
def test_dense_generate_cuda_matches_cpu(kv_quant):
    """Dense rings (no kernel reads them): generate's greedy tokens, one
    pass and chunked, and speculative_generate's (the model as its own
    draft) on the card equal the CPU's; K1 is never launched."""
    from tf_operator_tpu_torch.models.speculative import speculative_generate

    models = _dense_models()
    prompt = np.random.default_rng(5).integers(0, 256, (3, 12))
    out = {}
    before = (tpa.launches, tpa.launches_int8)
    for dev, m in models.items():
        out[dev] = [llama.generate(m, prompt, 10, device=dev,
                                   kv_quant=kv_quant, **kw).cpu()
                    for kw in ({}, dict(prefill_chunk=4))]
        out[dev].append(speculative_generate(m, m, prompt, 10, k=3,
                                             device=dev,
                                             kv_quant=kv_quant).cpu())
    assert (tpa.launches, tpa.launches_int8) == before
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("scheduler", ["slot", "continuous"])
def test_dense_serve_loop_cuda_matches_cpu(scheduler):
    """serve_loop(paged=False): the same greedy tokens and schedule on
    the card as on the CPU, and no K1 launch."""
    models = _dense_models()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n) for n in (5, 13, 3, 9, 17)]
    kw = dict(slots=2, max_new_tokens=[8, 5, 9, 6, 7], prefill_chunk=8,
              steps_per_sync=4, scheduler=scheduler, paged=False)
    out = []
    before = tpa.launches
    for dev, m in models.items():
        out.append([(r.tokens, r.admitted_at_step, r.finished_at_step,
                     r.slot) for r in serve_loop(m, prompts, device=dev,
                                                 **kw)])
    assert tpa.launches == before
    assert out[0] == out[1]


# ------------------------------------------------ handoff and prefix blocks
def _handoff_pools(kind, n=9, bs=16, kv=8, d=128, layers=2):
    """A paged cache at llama3_8b's block shape on the CPU (bf16, f32 or
    int8 QTensor leaves), drawn from one seed."""
    g = torch.Generator().manual_seed(5)
    shape = (n + 1, bs, kv, d)

    def leaf():
        if kind == "int8":
            return quant.QTensor(
                q=torch.randint(-127, 128, shape, generator=g,
                                dtype=torch.int8),
                scale=torch.rand(shape[:3] + (1,), generator=g))
        return torch.randn(shape, generator=g).to(kind)

    return [(leaf(), leaf()) for _ in range(layers)]


def _on(cache, dev):
    one = lambda t: (quant.QTensor(t.q.to(dev), t.scale.to(dev))
                     if isinstance(t, quant.QTensor) else t.to(dev))
    return [(one(k), one(v)) for k, v in cache]


@pytest.mark.parametrize("kind", [torch.bfloat16, torch.float32, "int8"])
def test_prefix_and_handoff_block_ops_on_the_card_match_cpu(kind):
    """copy_block and scatter_blocks on the card leave the CPU's bits;
    export_blocks of a pool on the card gives the CPU's hashes, elisions
    and payload bytes; adopt_blocks on the card writes them back."""
    from tf_operator_tpu_torch.models import paging

    cpu = _handoff_pools(kind)
    card = _on(cpu, "cuda")
    paging.copy_block(cpu, 3, 7)
    paging.copy_block(card, 3, 7)
    rows = [paging._unflatten(cpu, [t[i].clone() for t in paging._leaves(cpu)])
            for i in (1, 2)]
    paging.scatter_blocks(cpu, [8, 5], rows)
    paging.scatter_blocks(card, [8, 5], rows)
    for a, b in zip(paging._leaves(cpu), paging._leaves(card)):
        assert torch.equal(a, b.cpu())
    ids, shared = [1, 2, 7, 4], [True, True, False, False]
    sent_cpu, sent_card = set(), set()
    for _ in range(2):
        e_cpu = paging.export_blocks(cpu, ids, shared, 16,
                                     sent_hashes=sent_cpu)
        e_card = paging.export_blocks(card, ids, shared, 16,
                                      sent_hashes=sent_card)
        assert e_card.hashes == e_cpu.hashes
        assert list(e_card.payload) == list(e_cpu.payload)
        assert e_card.nbytes() == e_cpu.nbytes()
        for h in e_cpu.payload:
            for a, b in zip(paging._leaves(e_cpu.payload[h]),
                            paging._leaves(e_card.payload[h])):
                assert b.device.type == "cpu" and torch.equal(a, b)
    assert e_card.payload_blocks() == 2
    dst = _on(_handoff_pools(kind), "cuda")
    pool = paging.BlockPool(9, 16)
    full = paging.export_blocks(card, ids, shared, 16)
    _, adopted, _, _, stats = paging.adopt_blocks(dst, pool, full)
    assert stats["fresh"] == 4
    for a, b in zip(paging._leaves(card), paging._leaves(dst)):
        assert torch.equal(a[ids], b[adopted])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefix_handoff_serve_loop_cuda_matches_cpu(kv_quant):
    """The tiny f32 model over an unaligned shared prefix: the prefill
    side's handoffs made on the card adopt on the card and on the CPU,
    and every run gives the CPU's unified tokens."""
    cfg = llama.tiny(dtype=torch.float32, max_len=128)
    params = bridge.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(6)
    pfx = rng.integers(0, 256, 10)
    sufs = [rng.integers(0, 256, n) for n in (5, 9, 3, 7)]
    full = [np.concatenate([pfx, x]) for x in sufs]
    kw = dict(slots=2, max_new_tokens=8, block_size=4, kv_quant=kv_quant)
    models = {dev: llama.Llama.from_params(
        cfg, {k: v.to(dev) for k, v in params.items()}, device=dev)
        for dev in ("cuda", "cpu")}
    want = [r.tokens for r in serve_loop(models["cpu"], sufs, device="cpu",
                                         shared_prefix=pfx, **kw)]
    hand = serve_loop(models["cuda"], sufs, device="cuda", shared_prefix=pfx,
                      prefill_only=True, **kw)
    assert [h.export.payload_blocks() < len(h.export) for h in hand] == \
        [False, True, True, True]
    for dev in ("cuda", "cpu"):
        for sched in ("slot", "continuous"):
            got = serve_loop(models[dev], full, device=dev, adopt=hand,
                             scheduler=sched, **kw)
            assert [r.tokens for r in got] == want, (dev, sched)


# ------------------------------------------------------ flash attention
# f32: 64-wide tiles summed in another order than whole-sequence einsums
# (and the forward folded by online softmax).  bf16: outputs, p and dS
# rounded to bf16 (2^-8 relative).
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _flash_case(seed, *, s, h, kv, d, dtype, b=2):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)).to(
        "cuda", dtype) for shape in ((b, s, h, d), (b, s, kv, d),
                                     (b, s, kv, d), (b, s, h, d)))
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,kv,d,causal,window", [
    (64, 4, 4, 32, True, None), (100, 4, 2, 64, True, None),
    (200, 4, 1, 128, False, None), (200, 8, 2, 128, True, 37),
    (130, 2, 2, 16, True, 1), (1000, 8, 2, 64, True, None),
    (1000, 8, 2, 64, True, 512), (1000, 4, 1, 64, False, None),
    (300, 6, 2, 128, True, 100), (77, 8, 1, 8, True, None),
    (127, 4, 2, 128, True, None), (129, 8, 1, 128, True, None),
    (192, 4, 2, 128, False, None), (256, 8, 1, 128, True, 64)])
def test_flash_kernels_match_plain(dtype, s, h, kv, d, causal, window):
    """Each kernel against its plain version on the same inputs (the
    backward kernels take the plain forward's lse and delta), with
    ragged S, GQA groups 1-8 (G = 3: a block's units span two q tiles),
    D = 8 to 128, windows and bit-identical repeats; S = 127, 129 and
    192 put the tail inside, just past and on the 32-row halves of the
    backward's 64-row tiles, and G = 8 at D = 128 deals eight heads'
    units to K2kv's two warpgroups.  Every bf16 launch counts on the
    tensor cores, no f32 one."""
    q, k, v, do = _flash_case(s + d, s=s, h=h, kv=kv, d=d, dtype=dtype)
    out_p, lse_p = tfa.flash_fwd_plain(q, k, v, causal, window)
    delta = (out_p.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse_p, delta, causal, window)
    want = (out_p, lse_p, tfa.flash_dq_plain(*bwd), *tfa.flash_dkv_plain(*bwd))
    before = dict(tfa.launches)
    runs = [(*tfa.flash_fwd(q, k, v, causal, window), tfa.flash_dq(*bwd),
             *tfa.flash_dkv(*bwd)) for _ in range(2)]
    torch.cuda.synchronize()
    mma = 2 if dtype == torch.bfloat16 else 0
    assert {n: tfa.launches[n] - before[n] for n in before} == \
        {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2,
         "flash_fwd_mma": mma, "flash_dq_mma": mma, "flash_dkv_mma": mma}
    tol = FLASH_TOL[dtype]
    for name, a, b, ref in zip(["out", "lse", "dq", "dk", "dv"], *runs, want):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a.float(), ref.float(), rtol=tol, atol=tol,
                                   msg=name)


def test_flash_function_on_card_matches_cpu():
    """The autograd Function on CUDA tensors (kernels) against the same
    Function on CPU tensors (plain versions), f32, with a strided v as
    the model hands it over."""
    q, kvp, _, do = _flash_case(5, s=96, h=4, kv=4, d=32,
                                dtype=torch.float32)
    kvp = torch.stack([kvp[:, :, :2], kvp[:, :, 2:]], dim=2)  # [B,S,2,KV,D]
    outs = []
    for dev in ("cuda", "cpu"):
        leaves = [x.detach().to(dev).requires_grad_()
                  for x in (q, kvp[:, :, 0], kvp[:, :, 1])]
        out = tfa.flash_attention(*leaves, True, window=40)
        out.backward(do.to(dev))
        outs.append([t.detach().cpu() for t in
                     (out, *(x.grad for x in leaves))])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_flash_kernels_refuse_what_they_do_not_take():
    q, k, v, _ = _flash_case(6, s=16, h=2, kv=1, d=8, dtype=torch.float32)
    with pytest.raises(TypeError, match="must match"):
        tfa.flash_fwd(q, k.bfloat16(), v, True)
    with pytest.raises(TypeError, match="float32 or"):
        tfa.flash_fwd(q.half(), k.half(), v.half(), True)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((1, 4, 1, 256), device="cuda")
        tfa.flash_fwd(big, big, big, True)
    with pytest.raises(ValueError, match="unit"):
        tfa.flash_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                      True)


# ------------------------------------------------------ ring flash steps
# f32: 64-wide tiles folded by online softmax against whole-shard einsums
# (~1e-6 on O(1) values).  bf16: p and dS rounded to bf16 (2^-8 relative)
# at a running instead of the final maximum.
RING_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _ring_step_case(seed, *, s, h, kv, d, dtype, carry):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    q, do = f(2, s, h, d).to("cuda", dtype), f(2, s, h, d).to("cuda", dtype)
    kvp = f(2, s, 2, kv, d).to("cuda", dtype)  # strided, as the model's
    m, l, acc = f(2, h, s), f(2, h, s).abs() + 1, f(2, s, h, d)
    if carry == "masked":
        m[:, :, :s // 3] = trf.NEG_INF
        l[:, :, :s // 3] = 0.0
        acc[:, :s // 3] = 0.0
    lse, delta = f(2, h, s) + 3, f(2, h, s)
    lse[:, 0, :5] = trf.POS_INF
    state = [t.cuda() for t in (m, l, acc, lse, delta)]
    return (q, kvp[:, :, 0], kvp[:, :, 1], do), state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,kv,d,layout,my,src,window,carry", [
    (128, 4, 2, 32, "contiguous", 2, 2, None, "masked"),
    (128, 4, 1, 64, "contiguous", 2, 1, None, "mid"),
    (128, 4, 4, 32, "contiguous", 1, 2, None, "mid"),
    (128, 8, 2, 128, "zigzag", 1, 2, None, "masked"),
    (200, 4, 2, 32, "contiguous", 3, 2, 37, "mid"),
    (90, 2, 2, 16, "zigzag", 0, 3, None, "mid")])
def test_ring_step_kernels_match_plain(dtype, s, h, kv, d, layout, my, src,
                                       window, carry):
    """K3f, K3q and K3kv against their plain versions on one (member,
    step) of a ring of 4: diagonal, past and future steps (a future one
    leaves every accumulator as it was), zigzag offsets with tiles
    straddling the halves (S_l = 90), a window, rows that saw no key,
    and lse = POS_INF rows; two launches give the same bits and each
    counts one launch, every bf16 K3f, K3q and K3kv launch on the tensor
    cores and no f32 one."""
    (q, k, v, do), (m, l, acc, lse, delta) = _ring_step_case(
        s + d, s=s, h=h, kv=kv, d=d, dtype=dtype, carry=carry)
    offs = (trf.offsets(my, 4, s, layout), trf.offsets(src, 4, s, layout),
            True, window)
    bwd = (q, k, v, do, lse, delta)
    want = (*trf.carry_fwd_plain(q, k, v, m, l, acc, *offs),
            trf.ring_dq_plain(*bwd, *offs), *trf.ring_dkv_plain(*bwd, *offs))
    before = dict(trf.launches)
    runs = []
    for _ in range(2):
        st = [t.clone() for t in (m, l, acc)]
        trf.ring_fwd(q, k, v, *st, *offs)
        dq = torch.zeros((2, s, h, d), device="cuda")
        dk = torch.zeros((2, s, kv, d), device="cuda")
        dv = torch.zeros((2, s, kv, d), device="cuda")
        trf.ring_dq(*bwd, dq, *offs)
        trf.ring_dkv(*bwd, dk, dv, *offs)
        runs.append((*st, dq, dk, dv))
    torch.cuda.synchronize()
    mma = 2 if dtype == torch.bfloat16 else 0
    assert {n: trf.launches[n] - before[n] for n in before} == \
        {"ring_fwd": 2, "ring_fwd_mma": mma, "ring_dq": 2,
         "ring_dq_mma": mma, "ring_dkv": 2, "ring_dkv_mma": mma}
    tol = RING_TOL[dtype]
    dead = layout == "contiguous" and src > my
    for name, a, b, ref, was in zip(["m", "l", "acc", "dq", "dk", "dv"],
                                    *runs, want, (m, l, acc, 0, 0, 0)):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a, ref, rtol=tol, atol=tol, msg=name)
        if dead:
            assert torch.equal(a, was if torch.is_tensor(was)
                               else torch.zeros_like(a)), name


def _forward_lse(lse, q, k, q_off, k_off, causal, window):
    """lse as the forward leaves it: the step's own logsumexp of the
    scaled visible scores added to `lse` (the ring's other steps; POS_INF
    rows stay), so p <= 1 as in every real backward step."""
    b, s, h, _ = q.shape
    sc = trf._scores(q, k, trf._mask(q_off, k_off, s, causal, window,
                                     q.device))
    step = torch.logsumexp(sc, dim=-1).reshape(b, h, s)
    return torch.logaddexp(lse, step)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,kv,d,layout,my,src,causal,window,carry", [
    (200, 8, 2, 128, "zigzag", 1, 3, True, None, "mid"),
    (512, 8, 2, 128, "contiguous", 3, 2, True, 512, "mid"),
    (512, 8, 2, 128, "contiguous", 2, 3, True, None, "mid"),
    (256, 4, 1, 64, "zigzag", 2, 1, True, 64, "masked"),
    (192, 6, 2, 20, "contiguous", 2, 2, True, None, "masked"),
    (128, 4, 2, 48, "contiguous", 3, 1, True, None, "mid"),
    (128, 4, 2, 32, "zigzag", 3, 3, True, 40, "mid"),
    (200, 4, 2, 64, "zigzag", 1, 3, False, None, "mid")])
def test_ring_backward_kernels_match_plain(dtype, s, h, kv, d, layout, my,
                                           src, causal, window, carry):
    """The ring step's kernels at the shapes the tensor-core K3q and K3kv
    must handle, with lse as the forward leaves it: k and v the strided
    halves of a fused projection, D = 128, 64 and 32, D = 20 and 48
    zero-padded (20: element copies), G = 1 to 4, S_l = 200 zigzag (a
    tile straddles the half), windows of 40, 64 and 512, no mask, a
    future (dead) step that leaves every accumulator as it was, lse = POS_INF
    rows; two launches give the same bits; every bf16 K3f, K3q and K3kv
    launch on the tensor cores and no f32 one.  K3f's carry is held as
    (m, l, acc / l), the output the finish forms: acc is an unnormalized
    sum whose bf16 rounding grows with l."""
    (q, k, v, do), (m, l, acc, lse, delta) = _ring_step_case(
        s + d + 1, s=s, h=h, kv=kv, d=d, dtype=dtype, carry=carry)
    offs = (trf.offsets(my, 4, s, layout), trf.offsets(src, 4, s, layout),
            causal, window)
    lse = _forward_lse(lse, q, k, *offs)
    bwd = (q, k, v, do, lse, delta)
    as_out = lambda m, l, acc: (m, l, acc / torch.where(
        l == 0.0, 1.0, l).transpose(1, 2)[..., None])
    want = (*as_out(*trf.carry_fwd_plain(q, k, v, m, l, acc, *offs)),
            trf.ring_dq_plain(*bwd, *offs), *trf.ring_dkv_plain(*bwd, *offs))
    before = dict(trf.launches)
    runs = []
    for _ in range(2):
        st = [t.clone() for t in (m, l, acc)]
        trf.ring_fwd(q, k, v, *st, *offs)
        dq = torch.zeros((2, s, h, d), device="cuda")
        dk = torch.zeros((2, s, kv, d), device="cuda")
        dv = torch.zeros((2, s, kv, d), device="cuda")
        trf.ring_dq(*bwd, dq, *offs)
        trf.ring_dkv(*bwd, dk, dv, *offs)
        runs.append((*as_out(*st), dq, dk, dv))
    torch.cuda.synchronize()
    mma = 2 if dtype == torch.bfloat16 else 0
    assert {n: trf.launches[n] - before[n] for n in before} == \
        {"ring_fwd": 2, "ring_fwd_mma": mma, "ring_dq": 2,
         "ring_dq_mma": mma, "ring_dkv": 2, "ring_dkv_mma": mma}
    tol = RING_TOL[dtype]
    dead = causal and layout == "contiguous" and src > my
    for name, a, b, ref in zip(["m", "l", "acc", "dq", "dk", "dv"], *runs,
                               want):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a, ref, rtol=tol, atol=tol, msg=name)
        if dead and name in ("dq", "dk", "dv"):
            assert not a.any(), name
    if dead:
        assert all(torch.equal(a, b) for a, b in zip(runs[0][:3],
                                                     as_out(m, l, acc)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,kv,d,layout,my,src,window,dead_tiles", [
    (512, 8, 2, 128, "contiguous", 3, 2, 64, [1, 2, 3, 4, 5, 6, 7]),
    (256, 4, 2, 64, "contiguous", 1, 0, 64, [1, 2, 3]),
    (200, 4, 2, 32, "zigzag", 2, 1, 30, [])])
def test_ring_fwd_rows_that_see_nothing_keep_their_bits(
        dtype, s, h, kv, d, layout, my, src, window, dead_tiles):
    """A live step whose window leaves rows with no visible key: q tiles
    with no live kv tile (their warpgroups read and write none of the
    carry) and, in live tiles, rows that every key is hidden from (corr =
    1 and p = 0; the zigzag tiles straddle the half and are all taken as
    live).  Those rows of m, l and acc keep their bits, those whose carry
    is the -1e30 seed too; the other rows agree with the plain version;
    every bf16 launch runs on the tensor cores."""
    (q, k, v, _), (m, l, acc, _, _) = _ring_step_case(
        s + d + 2, s=s, h=h, kv=kv, d=d, dtype=dtype, carry="masked")
    q_off, k_off = (trf.offsets(my, 4, s, layout),
                    trf.offsets(src, 4, s, layout))
    offs = (q_off, k_off, True, window)
    n_t = -(-s // 64)
    assert dead_tiles == [qt for qt in range(n_t) if not any(
        trf.span_live(64 * qt, 64 * qt + 63, 64 * kt, 64 * kt + 63, q_off,
                      k_off, s, True, window) for kt in range(n_t))]
    blind = ~trf._mask(q_off, k_off, s, True, window, "cuda").any(dim=1)
    assert blind.any() and not blind.all()
    assert (m[:, :, blind] == trf.NEG_INF).any()
    want = trf.carry_fwd_plain(q, k, v, m, l, acc, *offs)
    st = [t.clone() for t in (m, l, acc)]
    before = dict(trf.launches)
    trf.ring_fwd(q, k, v, *st, *offs)
    torch.cuda.synchronize()
    assert trf.launches["ring_fwd"] - before["ring_fwd"] == 1
    assert trf.launches["ring_fwd_mma"] - before["ring_fwd_mma"] == (
        1 if dtype == torch.bfloat16 else 0)
    l_safe = lambda x: torch.where(x == 0.0, 1.0, x).transpose(1, 2)[..., None]
    tol = RING_TOL[dtype]
    for name, got, was, ref in zip(("m", "l", "acc"), st, (m, l, acc), want):
        rows = (lambda t, r: t[:, r]) if name == "acc" else (
            lambda t, r: t[:, :, r])
        assert torch.equal(rows(got, blind), rows(was, blind)), name
        if name == "acc":  # held as acc / l, the output the finish forms
            got, ref = got / l_safe(st[1]), ref / l_safe(want[1])
        torch.testing.assert_close(rows(got, ~blind), rows(ref, ~blind),
                                   rtol=tol, atol=tol, msg=name)


@pytest.mark.parametrize("layout,window", [("contiguous", None),
                                           ("zigzag", 40)])
def test_ring_function_on_card_matches_cpu(layout, window):
    """The ring on LocalRing(4), CUDA tensors (kernels) against CPU
    tensors (plain versions), f32, with a strided v as the model hands
    it over; the launches equal the schedule's live pairs."""
    (q, k, v, do), _ = _ring_step_case(9, s=4 * 48, h=4, kv=2, d=32,
                                       dtype=torch.float32, carry="mid")
    fn = trf.make_ring_flash_attention_fn(LocalRing(4), layout=layout)
    outs = []
    trf.reset_launches()
    for dev in ("cuda", "cpu"):
        leaves = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, True, window=window)
        out.backward(do.to(dev))
        outs.append([t.detach().cpu() for t in
                     (out, *(x.grad for x in leaves))])
    live = sum(zigzag.pair_live(my, src, 4, 48, layout, window)
               for my in range(4) for src in range(4))
    assert live == 10 if layout == "contiguous" else live < 16
    assert trf.launches == {"ring_fwd": live, "ring_fwd_mma": 0,
                            "ring_dq": live, "ring_dq_mma": 0,
                            "ring_dkv": live, "ring_dkv_mma": 0}
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_ring_kernels_refuse_what_they_do_not_take():
    (q, k, v, do), (m, l, acc, lse, delta) = _ring_step_case(
        6, s=16, h=2, kv=1, d=8, dtype=torch.float32, carry="mid")
    offs = ((0, 8), (0, 8), True, None)
    with pytest.raises(TypeError, match="must match"):
        trf.ring_fwd(q, k.bfloat16(), v, m, l, acc, *offs)
    with pytest.raises(ValueError, match="contiguous float32"):
        trf.ring_fwd(q, k, v, m.double(), l, acc, *offs)
    with pytest.raises(ValueError, match="contiguous float32"):
        trf.ring_dq(q, k, v, do, lse, delta, acc.transpose(1, 2), *offs)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((1, 4, 1, 256), device="cuda")
        st = torch.zeros((1, 1, 4), device="cuda")
        trf.ring_fwd(big, big, big, st, st.clone(), big.clone(), *offs)

