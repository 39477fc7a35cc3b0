"""The port's flash attention (tf_operator_tpu_torch.ops.flash_attention)
against the JAX package's Pallas kernels (interpret mode on the CPU).

On the CPU the port's autograd Function runs the kernels' plain versions;
the JAX side is `flash_attention` under jax.vjp with the Pallas forward
and backward kernels run as tests/test_ops.py runs them.  Inputs are drawn
with numpy from a seed and handed to both.  f32: 2e-5 on the output and
2e-4 on the gradients (the same sums in another order: whole-sequence
einsums against tiles folded by online softmax).  bf16: 2e-2 (outputs, p
and dS rounded to bf16 at 2^-8 relative, at different maxima).

The CUDA kernels run only on a card: tests/test_torch_cuda_kernels.py
holds them against the same plain versions, and chip_smoke.py does so at
the llama3_8b training shapes.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models.transformer import dot_product_attention as jdpa
from tf_operator_tpu_torch.models import transformer as ttf
from tf_operator_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("tf_operator_tpu.ops.flash_attention")

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": (2e-5, 2e-4), "bf16": (2e-2, 2e-2)}


def _inputs(seed, s, kv, h=4, b=2, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    do = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, do


def _jax(q, k, v, do, causal, window, dt, **blk):
    jdt = _DT[dt][0]

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal, window=window,
                                   interpret=True, **blk)

    out, vjp = jax.vjp(f, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do, jdt))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _port(q, k, v, do, causal, window, dt):
    tdt = _DT[dt][1]
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal, window=window)
    out.backward(torch.from_numpy(do).to(tdt))
    assert out.dtype == tdt and all(x.grad.dtype == tdt for x in leaves)
    return [x.float().detach().numpy()
            for x in (out, *(t.grad for t in leaves))]


def _close(got, want, dt):
    fwd, grad = TOL[dt]
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        tol = fwd if i == 0 else grad
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg="out dq dk dv".split()[i])


# (S, KV heads, causal, window, blk_q, blk_k): H=4, so group 1, 2 and 4;
# blk_q != blk_k tiles the two axes unevenly
CASES = [(128, 4, False, None, 64, 128), (128, 2, True, None, 64, 32),
         (256, 1, True, None, 128, 256), (256, 2, True, 16, 64, 128),
         (256, 4, True, 64, 128, 64), (256, 2, False, None, 256, 128)]


@pytest.mark.parametrize("s,kv,causal,window,blk_q,blk_k", CASES)
def test_matches_pallas_f32(s, kv, causal, window, blk_q, blk_k):
    args = _inputs(s + kv, s, kv) + (causal, window)
    _close(_port(*args, "f32"),
           _jax(*args, "f32", blk_q=blk_q, blk_k=blk_k), "f32")


@pytest.mark.parametrize("s,kv,causal,window", [(128, 2, True, None),
                                                (128, 1, True, 16),
                                                (128, 4, False, None)])
def test_matches_pallas_bf16(s, kv, causal, window):
    args = _inputs(7 + kv, s, kv) + (causal, window)
    _close(_port(*args, "bf16"), _jax(*args, "bf16", blk_q=64, blk_k=64),
           "bf16")


@pytest.mark.parametrize("window", [None, 64])
def test_matches_pallas_bf16_llama_widths(window):
    """bf16 at the training path's head width and GQA group (D = 128,
    H = 8 over KV = 2, S = 256, causal): the plain versions the card's
    kernels are held to equal the Pallas kernels here, so the kernels'
    yardstick is the reference's arithmetic at the widths they run."""
    args = _inputs(11, 256, 2, h=8, b=1, d=128) + (True, window)
    _close(_port(*args, "bf16"), _jax(*args, "bf16", blk_q=128, blk_k=128),
           "bf16")


def test_cpu_tensors_count_no_launch():
    """The plain path on CPU tensors, forward and backward, in both dtypes,
    leaves every launch count at 0, the tensor-core counts too."""
    tfa.reset_launches()
    for dt in ("f32", "bf16"):
        _port(*_inputs(1, 64, 2), True, None, dt)
    assert tfa.launches == {"flash_fwd": 0, "flash_fwd_mma": 0,
                            "flash_dq": 0, "flash_dq_mma": 0,
                            "flash_dkv": 0, "flash_dkv_mma": 0}


def test_lse_matches_pallas_forward():
    """The saved logsumexp equals the Pallas forward's, [B, H, S] against
    its [B*H, S]."""
    q, k, v, _ = _inputs(3, 128, 2)
    _, lse = tfa.flash_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                 True)
    to_bh = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(
        -1, 128, 32)
    _, want = jfa._fwd_call(to_bh(q), to_bh(k), to_bh(v), True, 64, 32,
                            True, heads=4, group=2)
    np.testing.assert_allclose(lse.reshape(-1, 128).numpy(),
                               np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s", [100, 200])
def test_untiled_lengths_match_jax_einsum_fallback(s):
    """S with no 128-aligned tiling: the JAX wrapper falls back to its
    einsum path (probabilities rounded to q's dtype), which agrees with
    the kernel arithmetic only in f32; the port takes any S."""
    args = _inputs(s, s, 2) + (True, None)
    _close(_port(*args, "f32"), _jax(*args, "f32"), "f32")


def test_cpu_function_runs_the_plain_versions(monkeypatch):
    calls = []
    for name in ("flash_fwd_plain", "flash_dq_plain", "flash_dkv_plain"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(
            tfa, name,
            lambda *a, _fn=fn, _n=name, **kw: (calls.append(_n),
                                               _fn(*a, **kw))[1])
    before = dict(tfa.launches)
    _port(*_inputs(0, 64, 2), True, None, "f32")
    assert calls == ["flash_fwd_plain", "flash_dq_plain", "flash_dkv_plain"]
    assert tfa.launches == before  # no kernel was launched


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 8)])
def test_bwd_plain_equals_autograd_of_fwd_plain(causal, window):
    """In f32 the flash backward formula (p from lse, delta from the
    output) is the gradient of the forward."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, 64, 2))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = tfa.flash_fwd_plain(*leaves, causal, window)
    out.backward(do)
    delta = (out.detach() * do).sum(-1).transpose(1, 2).contiguous()
    got = tfa.flash_bwd_plain(q, k, v, do, lse.detach(), delta, causal,
                              window)
    for a, b in zip(got, leaves):
        torch.testing.assert_close(a, b.grad, rtol=2e-5, atol=2e-5)


def test_non_contiguous_output_gradient():
    """dO reaching the backward with a non-unit stride on D gives the
    same gradients as its contiguous copy."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(6, 64, 2))
    strided = do.transpose(2, 3).contiguous().transpose(2, 3)
    assert strided.stride(-1) != 1
    grads = []
    for g in (do, strided):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        tfa.flash_attention(*leaves, True).backward(g)
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_validation_matches_jax():
    q = torch.zeros((1, 64, 4, 8))
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention(q, torch.zeros((1, 64, 3, 8)),
                            torch.zeros((1, 64, 3, 8)), True)
    with pytest.raises(ValueError, match="shapes must match"):
        tfa.flash_attention(q, torch.zeros((1, 64, 2, 8)),
                            torch.zeros((1, 64, 4, 8)), True)
    kv = torch.zeros((1, 64, 2, 8))
    with pytest.raises(ValueError, match="requires causal"):
        tfa.flash_attention(q, kv, kv, False, window=4)
    with pytest.raises(ValueError, match=">= 1"):
        tfa.flash_attention(q, kv, kv, True, window=0)
    assert tfa.flash_attention.supports_gqa


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_dot_product_attention_matches_jax(dt, causal, window):
    """The einsum reference (the Llama default without an attention_fn):
    scores in the input dtype, dtype-min mask, f32 softmax."""
    jdt, tdt = _DT[dt]
    q, k, v, _ = _inputs(9, 32, 4)
    want = jdpa(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal,
                window=window)
    got = ttf.dot_product_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal,
        window=window)
    tol = 2e-6 if dt == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
