"""Ulysses attention (ops/ulysses) against the JAX package's
(tests/test_ulysses.py's ten tests, their cases and tolerances).

In one process on the same meshes (tp 2 x dp 4, tp 4 x dp 2; JAX's
checks against the axis of n members) with inputs drawn with numpy:
make_ulysses_attention_fn's output against JAX's dot_product_attention
within 2e-5 and its gradients within 1e-4, causal and full, GQA with
compact kv (KV % n == 0) and broadcast (KV = 2 on tp 4), the sliding
window, the flash path (use_flash: ops/flash_attention's plain version
on the CPU, K2 on the card) within 2e-5 and its gradients within 5e-4,
the Transformer with Ulysses as its attention_fn against JAX's einsum
Transformer within 1e-4, and JAX's "not divisible" refusal word for
word.

One spawned job of eight JAX-free gloo ranks
(tests/torch_pipeline_util.ulysses_fn_case, tests/torch_sharded_util
.llama_case) runs ulysses_attention itself over 2 and 4 ranks on
sequence-sharded inputs (the two all-to-alls of parallel/comm.exchange
and their backward) against one process's attention over the whole
sequence within 1e-5, and train_llama's step of a tp-placed Llama with
the factory as its attention_fn (the rank's heads, no exchange: the
module docstring says why) on tp 2 x fsdp 2 x dp 2 and tp 4 x fsdp 2
(kv heads 2 do not divide tp 4) against one process's flash attention:
losses and gradient norms 1e-5, parameters rtol 1e-5 + atol 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_pipeline_util as pu
from tests import torch_sharded_util as u
from tf_operator_tpu.models import transformer as jt
from tf_operator_tpu.models.transformer import dot_product_attention
from tf_operator_tpu.ops.ulysses import (
    make_ulysses_attention_fn as jmake_ulysses)
from tf_operator_tpu.parallel.mesh import make_mesh as jmake_mesh
from tf_operator_tpu_torch.models import transformer as tt
from tf_operator_tpu_torch.models.transformer_bridge import (
    transformer_from_params, transformer_params_from_jax)
from tf_operator_tpu_torch.ops import make_ulysses_attention_fn
from tf_operator_tpu_torch.parallel.mesh import make_mesh

FN_CASE = "tests.torch_pipeline_util:ulysses_fn_case"
TRAIN = {
    "ulysses_tp2": ({"tp": 2, "fsdp": 2, "dp": 2}, dict(ulysses=True)),
    "ulysses_tp4_kv2": ({"tp": 4, "fsdp": 2},
                        dict(ulysses=True, d_ff=256)),
}


def _qkv(seed, b, s, h, d, kv=None):
    rng = np.random.default_rng(seed)
    f = lambda n: rng.standard_normal((b, s, n, d)).astype(  # noqa: E731
        np.float32)
    return f(h), f(kv or h), f(kv or h)


@functools.lru_cache(maxsize=None)
def _jax_attention(causal, window, grads):
    """JAX's dot_product_attention over kv broadcast to the query heads
    (jitted), and with `grads` the gradients of sum(out²)."""
    def ref(q, k, v):
        g = q.shape[2] // k.shape[2]
        return dot_product_attention(q, jnp.repeat(k, g, axis=2),
                                     jnp.repeat(v, g, axis=2), causal,
                                     window=window)

    if not grads:
        return jax.jit(ref)
    return jax.jit(jax.grad(lambda q, k, v: jnp.sum(ref(q, k, v) ** 2),
                            argnums=(0, 1, 2)))


def _port(fn, q, k, v, causal, window=None, grads=False):
    leaves = [torch.from_numpy(a).requires_grad_(grads) for a in (q, k, v)]
    kw = {} if window is None else {"window": window}
    out = fn(*leaves, causal, **kw)
    if not grads:
        return out.detach().numpy()
    (out ** 2).sum().backward()
    return [x.grad.numpy() for x in leaves]


def _fn(axes, **kw):
    return make_ulysses_attention_fn(make_mesh(axes, world=8), **kw)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The eight-rank job's readings (started first) and one process's."""
    jobs = {tag: (FN_CASE, axes, dict(s=s, h=h, kv=kv, causal=c, window=w,
                                      flash=f, seed=i))
            for i, (tag, (axes, s, h, kv, c, w, f)) in enumerate(
                pu.UL_CASES.items())}
    jobs.update({tag: ("llama", axes, kw)
                 for tag, (axes, kw) in TRAIN.items()})
    job = u.start(jobs, tmp_path_factory.mktemp("ulysses"))
    one = {tag: u.one_process(case, **kw)
           for tag, (case, axes, kw) in jobs.items() if tag in pu.UL_CASES}
    # one process: flash attention, the function the factory runs
    one.update({tag: u.one_process("llama", **{k: v for k, v in kw.items()
                                               if k != "ulysses"})
                for tag, (_, kw) in TRAIN.items()})
    return {"got": u.join(job), "one": one}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sp", [2, 4])
def test_ulysses_matches_full(causal, sp):
    q, k, v = _qkv(0, 8, 64, 4, 16)
    got = _port(_fn({"tp": sp, "dp": 8 // sp}), q, k, v, causal)
    want = _jax_attention(causal, None, False)(q, k, v)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_ulysses_grads_match_full():
    q, k, v = _qkv(1, 2, 32, 4, 8)
    got = _port(_fn({"tp": 4, "dp": 2}), q, k, v, True, grads=True)
    want = _jax_attention(True, None, True)(q, k, v)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=1e-4)


def test_ulysses_heads_not_divisible_raises():
    q, k, v = _qkv(2, 2, 32, 2, 8)  # 2 heads, tp=4
    axes = {"tp": 4, "dp": 2}
    with pytest.raises(ValueError, match="not divisible") as got:
        _port(_fn(axes), q, k, v, False)
    jfn = jmake_ulysses(jmake_mesh(axes))
    with pytest.raises(ValueError) as want:
        jax.jit(lambda q, k, v: jfn(q, k, v, False))(q, k, v)
    assert str(got.value) == str(want.value)
    # and the exchange itself, in one member's process
    from tf_operator_tpu_torch.ops.ulysses import ulysses_attention

    with pytest.raises(ValueError, match="q heads 3 not divisible"):
        ulysses_attention(*(torch.zeros(1, 4, n, 8) for n in (3, 2, 2)))


def test_transformer_with_ulysses_attention_matches_reference():
    """The model-level switch: TransformerConfig.attention_fn = ulysses
    reproduces JAX's einsum-attention transformer."""
    tokens = np.random.default_rng(3).integers(0, 256, (2, 32))
    jcfg = jt.tiny(causal=True, dtype=jnp.float32)
    model = jt.Transformer(jcfg)
    params = jax.jit(lambda r, t: model.init(r, t, train=False))(
        jax.random.PRNGKey(4), tokens)["params"]
    want = jax.jit(lambda p, t: model.apply({"params": p}, t,
                                            train=False))(params, tokens)
    cfg = tt.tiny(causal=True, dtype=torch.float32,
                  attention_fn=_fn({"tp": 4, "dp": 2}))
    port = transformer_from_params(cfg, transformer_params_from_jax(
        cfg, jax.tree.map(np.asarray, params)), device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(tokens).long(), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_ulysses_with_flash_kernel_matches_oracle():
    """use_flash routes the attention through the flash kernel's path
    (its plain version here): exact attention per head shard, so parity
    with the dense oracle holds forward and backward."""
    fn = _fn({"tp": 4, "dp": 2}, axis_name="tp", use_flash=True)
    q, k, v = _qkv(9, 2, 512, 4, 32)
    for causal in (False, True):
        got = _port(fn, q, k, v, causal)
        want = _jax_attention(causal, None, False)(q, k, v)
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5,
                                   rtol=2e-5)
        for a, b in zip(_port(fn, q, k, v, causal, grads=True),
                        _jax_attention(causal, None, True)(q, k, v)):
            np.testing.assert_allclose(a, np.asarray(b), atol=5e-4,
                                       rtol=5e-4)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("kv", [2, 4])
def test_ulysses_gqa_matches_reference(use_flash, kv):
    """Compact kv (KV % n == 0: kv=2 on tp=2) and MHA, the einsum and the
    flash local paths, against the broadcast oracle."""
    fn = _fn({"tp": 2, "dp": 4}, use_flash=use_flash)
    assert fn.supports_gqa
    q, k, v = _qkv(3, 4, 64, 4, 16, kv)
    got = _port(fn, q, k, v, True)
    want = _jax_attention(True, None, False)(q, k, v)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_ulysses_gqa_broadcast_fallback():
    """KV=2 on a tp=4 axis: kv heads don't split, so the broadcast path
    kicks in and still matches."""
    q, k, v = _qkv(4, 4, 64, 4, 16, 2)
    got = _port(_fn({"tp": 4, "dp": 2}), q, k, v, True)
    want = _jax_attention(True, None, False)(q, k, v)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_ulysses_gqa_grads_match_reference():
    q, k, v = _qkv(5, 4, 32, 4, 8, 2)
    got = _port(_fn({"tp": 2, "dp": 4}), q, k, v, True, grads=True)
    want = _jax_attention(True, None, True)(q, k, v)
    for a, b, name in zip(got, want, "qkv"):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-5,
                                   err_msg=name)


def test_ulysses_sliding_window_matches_reference():
    """The Mistral band drops through the local attention (positions are
    global over the whole sequence)."""
    q, k, v = _qkv(11, 2, 64, 4, 16)
    got = _port(_fn({"tp": 4, "dp": 2}, axis_name="tp"), q, k, v, True,
                window=10)
    want = _jax_attention(True, 10, False)(q, k, v)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_ulysses_flash_sliding_window_matches_reference():
    """window + the flash path + compact GQA kv together."""
    q, k, v = _qkv(12, 4, 256, 4, 16, 2)
    fn = _fn({"tp": 2, "dp": 4}, axis_name="tp", use_flash=True)
    got = _port(fn, q, k, v, True, window=50)
    want = _jax_attention(True, 50, False)(q, k, v)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


# ------------------------------------------------------ the spawned job
@pytest.mark.parametrize("tag", sorted(pu.UL_CASES))
def test_ulysses_over_processes_matches_one(run, tag):
    """ulysses_attention over the tp ranks on sequence blocks (each data
    member its rows) = one process's attention over the whole sequence:
    the output and the gradients of q, k and v."""
    got, one = run["got"][tag], run["one"][tag]
    torch.testing.assert_close(got["out"], one["out"], atol=1e-5, rtol=1e-5)
    for a, b, name in zip(got["grads"], one["grads"], "qkv"):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"{tag} d{name}: {m}")


@pytest.mark.parametrize("tag", sorted(TRAIN))
def test_ulysses_factory_trains_as_one_process(run, tag):
    u.check(run["got"][tag], run["one"][tag], adam=False, tag=tag)
