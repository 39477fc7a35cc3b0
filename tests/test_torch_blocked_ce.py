"""The port's blocked cross-entropy (tf_operator_tpu_torch.ops.blocked_ce)
against the JAX package's `blocked_cross_entropy` and `lm_blocked_loss`.

Inputs come from a numpy seed and go to both.  In f32 the chunked sums
run in the same order, the matmuls in another library, so 1e-5 relative
on the loss and 2e-5 on the gradients; the bf16 recipe test states its
own tolerance.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import llama as jl
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.ops import blocked_ce as tce

jce = importlib.import_module("tf_operator_tpu.ops.blocked_ce")


def _case(seed, n=24, d=16, v=300):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) / 4).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int32)
    labels[:3] = [0, v - 1, 127]  # both ends and a chunk edge
    return x, w, labels


@pytest.mark.parametrize("chunk", [None, 128, 96, 300, 1000])
def test_loss_and_grads_match_jax(chunk):
    """V=300 is no multiple of 128 or 96: the tail chunk is padded and
    masked on both sides."""
    x, w, labels = _case(0)
    loss_j, (dx_j, dw_j) = jax.value_and_grad(
        lambda x, w: jce.blocked_cross_entropy(x, w, jnp.asarray(labels),
                                               chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = tce.blocked_cross_entropy(xt, wt, torch.from_numpy(labels), chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j), rtol=2e-5,
                               atol=2e-5)


def test_equals_full_softmax_cross_entropy():
    x, w, labels = (torch.from_numpy(a) for a in _case(1))
    got = tce.blocked_cross_entropy(x, w, labels, chunk=64)
    want = torch.nn.functional.cross_entropy(x @ w, labels.long())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_validation():
    x, w, labels = (torch.from_numpy(a) for a in _case(2))
    with pytest.raises(ValueError, match="x\\[N,D\\]"):
        tce.blocked_cross_entropy(x[None], w, labels)
    with pytest.raises(ValueError, match="positive"):
        tce.blocked_cross_entropy(x, w, labels, chunk=0)


def test_lm_blocked_loss_matches_jax_on_tied_tiny_llama():
    """Loss and every parameter's gradient of the tied tiny llama, the
    port's f32 masters bridged from the flax init."""
    cfg_j = jl.tiny(tie_embeddings=True, dtype=jnp.float32)
    cfg_t = tl.tiny(tie_embeddings=True, dtype=torch.float32)
    tokens = np.random.default_rng(3).integers(0, 256, (2, 24)).astype(
        np.int32)
    model_j = jl.Llama(cfg_j)
    params = model_j.init(jax.random.PRNGKey(0), jnp.asarray(tokens),
                          train=False)["params"]
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jce.lm_blocked_loss(model_j, p, jnp.asarray(tokens),
                                      chunk=96)))(params)
    tree = jax.tree.map(np.asarray, params)
    model_t = tl.Llama.from_params(
        cfg_t, bridge.params_from_jax(cfg_t, tree, train=True),
        device="cpu", train=True)
    loss = tce.lm_blocked_loss(model_t, torch.from_numpy(tokens), chunk=96)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    want = bridge.params_from_jax(cfg_t, jax.tree.map(np.asarray, grads_j),
                                  train=True)
    got = {k: p.grad for k, p in model_t.named_parameters()}
    assert set(got) == set(want) and "lm_head" not in got
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=2e-4, atol=2e-5,
                                   msg=k)


def test_bf16_training_loss_and_grads_match_jax():
    """The train recipe in bf16 compute (f32 masters, flash attention,
    remat) with repeated tokens: the loss within 1e-3 relative and each
    gradient within 3e-2 of its norm.  XLA and torch round to bf16 at
    different points of each product and sum (measured: 1e-4 on the
    loss, 0.5-1.5 % on the gradients); the embedding gradient of a
    repeated token is also summed in bf16 by XLA's scatter and in f32 by
    torch's."""
    from tf_operator_tpu.ops.flash_attention import flash_attention as jflash
    from tf_operator_tpu_torch.ops.flash_attention import flash_attention

    cfg_j = jl.tiny(tie_embeddings=True, attention_fn=jflash, remat=True)
    cfg_t = tl.tiny(tie_embeddings=True, attention_fn=flash_attention,
                    remat=True)
    tokens = np.random.default_rng(3).integers(0, 256, (2, 32)).astype(
        np.int32)
    tokens[:, :8] = 7
    model_j = jl.Llama(cfg_j)
    params = model_j.init(jax.random.PRNGKey(0), jnp.asarray(tokens),
                          train=False)["params"]
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jce.lm_blocked_loss(model_j, p, jnp.asarray(tokens))))(params)
    model_t = tl.Llama.from_params(
        cfg_t, bridge.params_from_jax(cfg_t, jax.tree.map(np.asarray, params),
                                      train=True),
        device="cpu", train=True)
    loss = tce.lm_blocked_loss(model_t, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-3)
    want = bridge.params_from_jax(cfg_t, jax.tree.map(np.asarray, grads_j),
                                  train=True)
    for k, p in model_t.named_parameters():
        assert p.grad.dtype == torch.float32
        rel = float((p.grad - want[k]).norm() / want[k].norm())
        assert rel < 3e-2, (k, rel)


def test_lm_blocked_loss_refuses_untied():
    model = tl.Llama.from_params(
        tl.tiny(), bridge.init_params(tl.tiny(), 0, device="cpu"),
        device="cpu")
    with pytest.raises(ValueError, match="tie_embeddings"):
        tce.lm_blocked_loss(model, torch.zeros((1, 4), dtype=torch.long))
