"""The port's weight-only int8 (tf_operator_tpu_torch.models.quant, the
bridge's QTensor leaves and the int8-weight Llama) against the JAX
package's models/quant.py on the CPU.

Quantization is bit for bit: the same f32 absmax, true division by the
scale and half-to-even rounding on both sides.  The forward of a model
built from quantized weights is held to JAX's dequantized forward in f32
with the tolerance of the float models (1e-5 on O(1) logits: the same
algorithm on two BLAS libraries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models import quant as jq
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import quant as tq


def _draw(seed, shape, zero_axis=None):
    """Weights of ragged magnitude; one slice along `zero_axis` all zero
    (its channel's absmax is 0, so its scale must be 1)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3.0, shape)).astype(
        np.float32)
    if zero_axis is not None:
        idx = [slice(None)] * len(shape)
        idx[zero_axis] = 0
        w[tuple(idx)] = 0.0
    return w


@pytest.mark.parametrize("shape,axes,zero_axis", [
    ((64, 4, 16), (0,), 2),      # wq [E, H, D]: per-(H, D) scales
    ((64, 2, 2, 16), (0,), 3),   # wkv [E, 2, KV, D]
    ((4, 16, 64), (0, 1), 2),    # attn out [H, D, E]
    ((64, 2, 128), (0,), 2),     # mlp wi [E, 2, F]
    ((256, 64), (1,), 0),        # embedding [V, E]: per-row scales
    ((3, 5, 2, 16), (3,), 1),    # KV [B, L, KV, D]: per-(position, head)
])
def test_quantize_tensor_bytes_equal_jax(shape, axes, zero_axis):
    w = _draw(sum(shape), shape, zero_axis)
    want = jq.quantize_tensor(w, axes)
    got = tq.quantize_tensor(torch.from_numpy(w), axes)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    zeros = got.scale.numpy() == 1.0
    assert zeros.any()  # the all-zero channel took scale 1
    for dt_t, dt_j in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            got.dequantize(dt_t).float().numpy(),
            np.asarray(want.dequantize(dt_j).astype(jnp.float32)))


def test_quantize_tensor_rounds_half_to_even():
    """absmax 127 gives scale 1, so each value's rounding is visible:
    2.5 -> 2, 3.5 -> 4, -2.5 -> -2 (jnp.round and torch.round)."""
    w = np.array([[127.0, 2.5, 3.5, -2.5, 0.5, -127.0]], np.float32).T
    got = tq.quantize_tensor(torch.from_numpy(w), (0,))
    assert got.q[:, 0].tolist() == [127, 2, 4, -2, 0, -127]
    np.testing.assert_array_equal(got.q.numpy(),
                                  np.asarray(jq.quantize_tensor(w, (0,)).q))


def _jax_params(seed, **kw):
    jcfg = jl.tiny(dtype=jnp.float32, **kw)
    jmodel = jl.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8),
                                                             jnp.int32),
                         train=False)["params"]
    return jcfg, jmodel, params


def _sd_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], tq.QTensor):
            assert isinstance(b[k], tq.QTensor), k
            assert torch.equal(a[k].q, b[k].q), k
            assert torch.equal(a[k].scale, b[k].scale), k
        else:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("tied", [False, True])
def test_quantize_params_matches_the_bridged_jax_tree(tied):
    """Port-side quantize_params of the bridged f32 tree equals the JAX
    quantize_params tree bridged (payload and scales byte for byte):
    the contraction axes follow the JAX tags (attn out over (H, D), the
    embedding per row, the dense MLP's wi/wo over their first axis)."""
    jcfg, _, params = _jax_params(3, tie_embeddings=tied)
    tcfg = tl.tiny(dtype=torch.float32, tie_embeddings=tied)
    from_jax = bridge.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jq.quantize_params(params)))
    ours = tq.quantize_params(bridge.params_from_jax(
        tcfg, jax.tree.map(np.asarray, params), train=True))
    _sd_equal(ours, from_jax)
    n_mat = 2 + 5 * tcfg.n_layers - (1 if tied else 0)
    assert sum(isinstance(v, tq.QTensor) for v in ours.values()) == n_mat
    assert tuple(ours["blocks.0.attn.out"].scale.shape) == (1, 1, 64)
    assert tuple(ours["embed"].scale.shape) == (256, 1)
    assert tuple(ours["blocks.0.mlp.wi"].scale.shape) == (1, 2, 128)
    assert tuple(ours["blocks.0.mlp.wo"].scale.shape) == (1, 64)
    assert not isinstance(ours["ln_f.scale"], tq.QTensor)
    assert tq.quantized_bytes(ours) == jq.quantized_bytes(
        jq.quantize_params(params))


def test_dequantize_params_and_the_dequantizer():
    _, _, params = _jax_params(4)
    tcfg = tl.tiny(dtype=torch.float32)
    sd = tq.quantize_params(bridge.params_from_jax(
        tcfg, jax.tree.map(np.asarray, params), train=True))
    want = jq.dequantize_params(jq.quantize_params(params), jnp.bfloat16)
    got = tq.dequantize_params(sd, torch.bfloat16)
    np.testing.assert_array_equal(
        got["blocks.1.attn.wkv"].float().numpy(),
        np.asarray(want["block1"]["attn"]["wkv"]["kernel"].astype(
            jnp.float32)))
    assert got["blocks.0.ln1.scale"] is sd["blocks.0.ln1.scale"]
    assert tq.make_dequantizer(torch.bfloat16) is tq.make_dequantizer(
        torch.bfloat16)
    assert tq.make_dequantizer(torch.float32) is not tq.make_dequantizer(
        torch.bfloat16)


@pytest.mark.parametrize("tied", [False, True])
def test_int8_model_forward_matches_jax_dequantized(tied):
    """A model built from the quantized state dict keeps int8 payloads
    and dequantizes each weight at its use; its full-sequence logits
    equal JAX's apply over make_dequantizer(f32)(quantized tree)."""
    jcfg, jmodel, params = _jax_params(5, tie_embeddings=tied, max_len=64)
    qp = jq.quantize_params(params)
    tcfg = tl.tiny(dtype=torch.float32, tie_embeddings=tied, max_len=64)
    model = tl.Llama.from_params(
        tcfg, bridge.params_from_jax(tcfg, jax.tree.map(np.asarray, qp)),
        device="cpu")
    assert model.blocks[0].attn.wq.dtype == torch.int8
    assert model.embed.dtype == torch.int8
    assert model.blocks[0].mlp.wi_scale.dtype == torch.float32
    tokens = np.random.default_rng(6).integers(0, 256, (2, 12)).astype(
        np.int32)
    want = np.asarray(jmodel.apply({"params": jq.make_dequantizer(
        jnp.float32)(qp)}, jnp.asarray(tokens)))
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_int8_embedding_gather_equals_dequantizing_the_table_first():
    """Gathering int8 rows and their scales, then dequantizing, gives the
    bits of dequantizing the whole table to cfg.dtype and gathering."""
    tcfg = tl.tiny(dtype=torch.bfloat16)
    sd = tq.quantize_params(bridge.init_params(tcfg, seed=1, device="cpu",
                                               train=True))
    model = tl.Llama.from_params(tcfg, sd, device="cpu")
    tokens = torch.tensor([[3, 255, 0, 17, 3]])
    want = sd["embed"].dequantize(torch.bfloat16)[tokens]
    assert torch.equal(model._embed(tokens), want)


def test_from_params_refuses_int8_training_and_misfits():
    tcfg = tl.tiny(dtype=torch.float32)
    sd = tq.quantize_params(bridge.init_params(tcfg, seed=2, device="cpu",
                                               train=True))
    with pytest.raises(ValueError, match="serve only"):
        tl.Llama.from_params(tcfg, sd, device="cpu", train=True)
    bad = dict(sd)
    bad["blocks.0.attn.wq"] = tq.QTensor(sd["blocks.0.attn.wq"].q[:8],
                                         sd["blocks.0.attn.wq"].scale)
    with pytest.raises(ValueError, match="does not fit"):
        tl.Llama.from_params(tcfg, bad, device="cpu")
