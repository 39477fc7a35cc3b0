"""The port's ring attention (tf_operator_tpu_torch.ops.ring_flash and
ops.ring_attention over parallel.ring.LocalRing) against the JAX
package's, on the CPU.

  - The whole ring, forward and grads, on LocalRing(4) against the JAX
    rings under shard_map on tests/conftest.py's 8 host devices (mesh
    tp=4, dp=2): 2e-5 forward and 5e-4 grads in f32, 3e-2 in bf16, as
    tests/test_ring_flash.py holds the JAX ring.  The port's kernel ring
    sums each kv head's group in one accumulator where JAX folds per-head
    sums, so dk/dv are summed in another order.
  - The tiny Llama's loss and gradients through the ring, contiguous and
    zigzag, against JAX's: 2e-4 and 5e-4.
  - The training entry point with --ring.

tests/test_torch_ring_step.py holds the step kernels' plain versions
against the Pallas step kernels.  Inputs come from numpy seeds and go to
both sides.  The CUDA kernels run
only on a card: tests/test_torch_cuda_kernels.py holds them against the
plain versions, and chip_smoke.py does so at the llama3_8b ring shapes.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.ops.blocked_ce import blocked_cross_entropy as jbce
from tf_operator_tpu.parallel.compat import shard_map
from tf_operator_tpu.parallel.mesh import make_mesh
from tf_operator_tpu_torch import train_llama as ttl
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.ops import blocked_ce as tce
from tf_operator_tpu_torch.ops import ring_attention as tra
from tf_operator_tpu_torch.ops import ring_flash as trf
from tf_operator_tpu_torch.ops import zigzag as tzz
from tf_operator_tpu_torch.ops.flash_attention import flash_attention
from tf_operator_tpu_torch.parallel.ring import LocalRing

# the package re-exports functions under the modules' names
jra = importlib.import_module("tf_operator_tpu.ops.ring_attention")
jrf = importlib.import_module("tf_operator_tpu.ops.ring_flash")

N = 4
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------ the ring
RB, RS, RH, RD = 2, 256, 4, 32
RING_TOL = {"f32": (2e-5, 5e-4), "bf16": (3e-2, 3e-2)}
SPEC = P(("dcn", "dp", "fsdp"), "tp", None, None)


def _ring_inputs(seed, s, kv, h=RH, d=RD):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return f(RB, s, h, d), f(RB, s, kv, d), f(RB, s, kv, d), f(RB, s, h, d)


def _jax_ring(fn, x, causal, window, dt):
    jdt = _DT[dt][0]
    q, k, v, do = (jnp.asarray(a, jdt) for a in x)

    def f(q, k, v):
        return fn(q, k, v, causal, window=window)

    out, vjp = jax.vjp(jax.jit(f), q, k, v)
    return [_np(a) for a in (out, *vjp(do))]


def _port_ring(fn, x, causal, window, dt):
    tdt = _DT[dt][1]
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in x[:3]]
    out = fn(*leaves, causal, window=window)
    out.backward(torch.from_numpy(x[3]).to(tdt))
    assert out.dtype == tdt and all(a.grad.dtype == tdt for a in leaves)
    return [a.detach().float().numpy()
            for a in (out, *(t.grad for t in leaves))]


def _close(got, want, dt):
    fwd, grad = RING_TOL[dt]
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        tol = fwd if i == 0 else grad
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg="out dq dk dv".split()[i])


# (kv heads, causal, layout, window, dtype): H=4, so groups 1, 2 and 4
RING_CASES = [(4, True, "contiguous", None, "f32"),
              (2, False, "contiguous", None, "f32"),
              (1, True, "contiguous", None, "f32"),
              (2, True, "zigzag", None, "f32"),
              (1, False, "zigzag", None, "f32"),
              (2, True, "contiguous", 8, "f32"),
              (1, True, "zigzag", 64, "f32"),
              (2, True, "contiguous", None, "bf16")]


@pytest.mark.parametrize("kv,causal,layout,window,dt", RING_CASES)
def test_ring_flash_matches_jax(kv, causal, layout, window, dt):
    mesh = make_mesh({"tp": N, "dp": 2})
    x = _ring_inputs(kv + 10 * causal + (window or 0), RS, kv)
    want = _jax_ring(jrf.make_ring_flash_attention_fn(
        mesh, "tp", interpret=True, layout=layout), x, causal, window, dt)
    fn = trf.make_ring_flash_attention_fn(LocalRing(N), layout=layout)
    assert fn.supports_gqa
    trf.reset_launches()
    _close(_port_ring(fn, x, causal, window, dt), want, dt)
    assert trf.launches == {"ring_fwd": 0, "ring_fwd_mma": 0, "ring_dq": 0,
                            "ring_dq_mma": 0, "ring_dkv": 0, "ring_dkv_mma": 0}


@pytest.mark.parametrize("kv,causal,layout,window,dt",
                         [c for c in RING_CASES if c[4] == "f32"][:5]
                         + [RING_CASES[-1]])
def test_einsum_ring_matches_jax(kv, causal, layout, window, dt):
    mesh = make_mesh({"tp": N, "dp": 2})
    x = _ring_inputs(kv + 20 * causal + (window or 0), RS, kv)
    want = _jax_ring(jra.make_ring_attention_fn(mesh, "tp", layout=layout),
                     x, causal, window, dt)
    fn = tra.make_ring_attention_fn(LocalRing(N), layout=layout)
    assert fn.supports_gqa
    _close(_port_ring(fn, x, causal, window, dt), want, dt)


def test_unaligned_shard_against_jax_einsum_fallback():
    """S_local = 200 has no 128-aligned tile: the JAX ring falls back to
    its einsum ring (f32 there, so the rounding points agree); the port's
    kernel ring takes it as is."""
    mesh = make_mesh({"tp": N, "dp": 2})
    x = _ring_inputs(3, 200 * N, 2, h=4, d=16)
    inner = functools.partial(jrf.ring_flash_attention, causal=True,
                              axis_name="tp", blk_q=128, blk_k=128,
                              interpret=True)
    fn = lambda q, k, v, causal, window: shard_map(
        inner, mesh=mesh, in_specs=(SPEC, SPEC, SPEC), out_specs=SPEC,
        check_rep=False)(q, k, v)
    want = _jax_ring(fn, x, True, None, "f32")
    got = _port_ring(trf.make_ring_flash_attention_fn(LocalRing(N)), x,
                     True, None, "f32")
    _close(got, want, "f32")


def test_ring_equals_the_one_device_flash_attention():
    """The ring on LocalRing(4), zigzag, against the port's own
    flash_attention (K2's plain versions) on the logical sequence."""
    x = _ring_inputs(5, RS, 2)
    ring = trf.make_ring_flash_attention_fn(LocalRing(N), layout="zigzag")
    stored = [tzz.to_storage(torch.from_numpy(a), N).numpy() for a in x]
    got = [tzz.from_storage(torch.from_numpy(a), N).numpy()
           for a in _port_ring(ring, stored, True, 48, "f32")]
    want = _port_ring(lambda q, k, v, c, window: flash_attention(
        q, k, v, c, window=window), x, True, 48, "f32")
    _close(got, want, "f32")


def test_odd_shards_and_refusals():
    """Odd S_local runs on the contiguous ring (the half-chunk ids fold
    back into offset + row); zigzag refuses it, as JAX does, and a window
    needs causal."""
    x = _ring_inputs(6, 3 * 37, 1, h=2, d=8)
    fn = trf.make_ring_flash_attention_fn(LocalRing(3))
    got = _port_ring(fn, x, True, None, "f32")
    want = _port_ring(lambda q, k, v, c, window: flash_attention(q, k, v, c),
                      x, True, None, "f32")
    _close(got, want, "f32")
    q = torch.zeros((1, 3 * 37, 2, 8))
    with pytest.raises(ValueError, match="even"):
        trf.make_ring_flash_attention_fn(LocalRing(3), "zigzag")(q, q, q,
                                                                 True)
    with pytest.raises(ValueError, match="causal"):
        fn(q, q, q, False, window=4)
    with pytest.raises(ValueError, match="split"):
        fn(q[:, :100], q[:, :100], q[:, :100], True)


# ----------------------------------------------------- the training step
SEQ = 64


def _tiny_pair(layout):
    mesh = make_mesh({"tp": N, "dp": 2})
    cfg_j = jl.tiny(tie_embeddings=True, dtype=jnp.float32, remat=True,
                    attention_fn=jrf.make_ring_flash_attention_fn(
                        mesh, "tp", interpret=True, layout=layout))
    cfg_t = tl.tiny(tie_embeddings=True, dtype=torch.float32, remat=True,
                    attention_fn=trf.make_ring_flash_attention_fn(
                        LocalRing(N), layout=layout))
    model_j = jl.Llama(cfg_j)
    # attention holds no parameters: init through the einsum default
    params = jl.Llama(jl.tiny(tie_embeddings=True, dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), jnp.zeros((2, SEQ), jnp.int32),
        train=False)["params"]
    model_t = tl.Llama.from_params(
        cfg_t, bridge.params_from_jax(cfg_t, jax.tree.map(np.asarray, params),
                                      train=True),
        device="cpu", train=True)
    return model_j, params, model_t


def _jax_loss(model, params, tokens, perm):
    """The blocked LM loss in logical order; with perm, the model runs on
    the tokens in storage order with positions=perm."""
    cfg = model.cfg
    toks = tokens if perm is None else tokens[:, perm]
    kw = {} if perm is None else {"positions": jnp.asarray(perm)}
    hidden = model.apply({"params": params}, toks, train=True,
                         return_hidden=True, **kw)
    if perm is not None:
        hidden = hidden[:, np.argsort(perm)]
    x = hidden[:, :-1].reshape(-1, cfg.d_model)
    embed = params["embed"]["embedding"]
    return jbce(x.astype(jnp.float32), embed.astype(jnp.float32).T,
                tokens[:, 1:].reshape(-1))


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_training_step_matches_jax(layout):
    """The tiny f32 Llama through the ring (LocalRing(4) against JAX's
    ring over the tp=4 mesh): loss and every gradient.  Zigzag permutes
    tokens and positions once and takes the loss in logical order.  The
    ring step also equals the port's one-device flash step."""
    model_j, params, model_t = _tiny_pair(layout)
    tokens = np.random.default_rng(12).integers(0, 256, (2, SEQ)).astype(
        np.int32)
    perm = tzz.storage_perm(N, SEQ) if layout == "zigzag" else None
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(model_j, p, jnp.asarray(tokens), perm)))(params)
    want = bridge.params_from_jax(model_t.cfg,
                                  jax.tree.map(np.asarray, grads_j),
                                  train=True)
    loss_t = tce.lm_blocked_loss(model_t, torch.from_numpy(tokens),
                                 perm=None if perm is None
                                 else torch.from_numpy(perm))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=2e-4,
                               atol=2e-4)
    for k, p in model_t.named_parameters():
        torch.testing.assert_close(p.grad, want[k], rtol=5e-4, atol=5e-4,
                                   msg=k)

    flash = tl.Llama.from_params(
        tl.tiny(tie_embeddings=True, dtype=torch.float32, remat=True,
                attention_fn=flash_attention),
        {k: v.detach().clone() for k, v in model_t.state_dict().items()},
        device="cpu", train=True)
    loss_f = tce.lm_blocked_loss(flash, torch.from_numpy(tokens))
    loss_f.backward()
    torch.testing.assert_close(loss_t, loss_f, rtol=2e-5, atol=2e-5)
    grads_f = dict(flash.named_parameters())
    for k, p in model_t.named_parameters():
        torch.testing.assert_close(p.grad, grads_f[k].grad, rtol=1e-4,
                                   atol=1e-4, msg=k)


# --------------------------------------------------------- entry point
def test_train_llama_ring_smoke_on_cpu(capsys):
    assert ttl.main(["--smoke", "--ring", "--device", "cpu", "--steps", "2",
                     "--per-host-batch", "2", "--seq-len", "16"]) == 0
    out = capsys.readouterr().out
    assert "ring attention over LocalRing(1)" in out
    assert "complete: steps=2" in out


@pytest.mark.parametrize("argv,env", [(["--tp", "2"], {}),
                                      ([], {"WORLD_SIZE": "2"})])
def test_train_llama_ring_refuses_tp_and_processes(argv, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match="item 11"):
        ttl.main(["--smoke", "--ring", "--device", "cpu"] + argv)
