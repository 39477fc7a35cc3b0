"""The port's BERT/T5 transformer family (models/transformer.py,
models/transformer_bridge.py, the Transformer form of
ops/blocked_ce.lm_blocked_loss, train_bert's MLM step and train_t5's LM
step) against the JAX package, on the CPU at tiny f32 widths.

The same numpy tokens and params (in the flax tree's structure, drawn
with numpy) go to both sides, through transformer_params_from_jax.  Cases: bidirectional (BERT-style),
causal, MoE every 2nd block, remat, untied head, explicit positions,
return_hidden, JAX's flash_attention (interpret mode) at S=128
non-causal against the port's, the blocked CE, and three optimizer steps
of train_bert's and train_t5's steps.  Tolerances (f32): loss 1e-5
relative; logits 1e-5 + 1e-5·|ref|; gradients 2e-4 by each parameter's
relative error norm; the bf16 forward 2e-2 + 2e-2·|ref|.  JAX's
reference runs are jitted and shared through module fixtures.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models import transformer as jt
from tf_operator_tpu.ops.blocked_ce import lm_blocked_loss as j_blocked
from tf_operator_tpu.ops.flash_attention import flash_attention as jflash
from tf_operator_tpu.runtime.train import TrainState as JTrainState
from tf_operator_tpu_torch import train_bert, train_t5
from tf_operator_tpu_torch.models import transformer as tt
from tf_operator_tpu_torch.models import transformer_bridge as tb
from tf_operator_tpu_torch.ops.blocked_ce import lm_blocked_loss
from tf_operator_tpu_torch.ops.flash_attention import flash_attention
from tf_operator_tpu_torch.runtime import optim
from tf_operator_tpu_torch.runtime.train import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 32

# bidirectional with a dense and a sparse block; causal, remat and
# sparse; causal and untied
CASES = {"moe": dict(n_experts=4, moe_every=2),
         "remat": dict(causal=True, remat=True, n_experts=2),
         "untied": dict(causal=True, tie_embeddings=False)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: one torch thread (the count is put back after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(path: str, name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tokens(seed: int, b: int = 2, s: int = SEQ) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _init(model_j, seq: int):
    """Params in the flax tree's structure (jax.eval_shape of init, no
    compile) drawn with numpy as flax's initializers draw them: LayerNorm
    scales 1, the position table normal(0.02), the token embedding
    normal(1/sqrt(d_model)), every kernel truncated-normal lecun over its
    fan-in (the product of its input axes)."""
    shapes = jax.eval_shape(lambda: model_j.init(
        jax.random.PRNGKey(0), jnp.zeros((2, seq), jnp.int32),
        train=False)["params"])
    rng = np.random.default_rng(0)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return np.ones_like(x)
        if name.endswith("['pos_embed']"):
            return 0.02 * x
        if name.endswith("['embedding']"):
            return x / np.sqrt(s.shape[1])
        fan_in = (s.shape[0] * s.shape[1] if len(s.shape) == 3
                  else s.shape[0])
        return np.clip(x, -2, 2) / np.sqrt(fan_in) / 0.87962566103423978

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(seq: int = SEQ, j_attn=None, t_attn=None, dtype=None, **kw):
    """(JAX model, its params, the port's model on the same params)."""
    cfg_j = jt.tiny(dtype=dtype or jnp.float32, attention_fn=j_attn, **kw)
    cfg_t = tt.tiny(dtype=torch.bfloat16 if dtype else torch.float32,
                    attention_fn=t_attn, **kw)
    model_j = jt.Transformer(cfg_j)
    params = _init(model_j, seq)
    model_t = tb.transformer_from_params(
        cfg_t, tb.transformer_params_from_jax(
            cfg_t, jax.tree.map(np.asarray, params)), device="cpu")
    return model_j, params, model_t


def _grads_to_torch(model_t, grads_j):
    return tb.transformer_params_from_jax(
        model_t.cfg, jax.tree.map(np.asarray, grads_j))


def _assert_grads(model_t, want, tol=2e-4):
    for name, p in model_t.named_parameters():
        ref = want[name].double()
        err = float((p.grad.double() - ref).norm() / ref.norm().clamp_min(
            1e-30))
        assert err <= tol, (name, err)
        p.grad = None


def _assert_logits(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def reference():
    """Per case: the JAX logits, aux, lm_train_loss and its gradients
    on one batch (one jitted call each)."""
    tokens = _tokens(1)
    out = {}
    for case, kw in CASES.items():
        model_j, params, model_t = _pair(**kw)

        def loss_j(p):
            # lm_train_loss, with the logits and aux it is made of
            logits, aux = jt.apply_with_aux(model_j, p, jnp.asarray(tokens))
            loss = jt.lm_loss(logits, jnp.asarray(tokens))
            return loss + jt.MOE_AUX_WEIGHT * aux, (logits, aux)

        (loss, (logits, aux)), grads = jax.jit(jax.value_and_grad(
            loss_j, has_aux=True))(params)
        out[case] = dict(model_t=model_t, logits=logits, aux=float(aux),
                         loss=float(loss),
                         grads=_grads_to_torch(model_t, grads))
    return tokens, out


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(reference, case):
    tokens, ref = reference
    r = ref[case]
    with torch.no_grad():
        logits, aux = tt.apply_with_aux(r["model_t"],
                                        torch.from_numpy(tokens))
    _assert_logits(logits, r["logits"])
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(float(aux), r["aux"], rtol=1e-5, atol=1e-7)
    assert (r["aux"] > 0) == (CASES[case].get("n_experts", 0) > 0)


@pytest.mark.parametrize("case", list(CASES))
def test_lm_train_loss_and_grads_match_jax(reference, case):
    tokens, ref = reference
    r = ref[case]
    model_t = r["model_t"]
    loss = tt.lm_train_loss(model_t, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss.detach()), r["loss"], rtol=1e-5)
    loss.backward()
    _assert_grads(model_t, r["grads"])


def test_positions_and_return_hidden_match_jax():
    """Explicit position ids ([S], a permutation; [B, S] with negative
    and out-of-range ids, which JAX's gather under jit wraps and clamps)
    and the pre-projection hidden states."""
    model_j, params, model_t = _pair(causal=True)
    tokens = _tokens(2)
    perm = np.random.default_rng(3).permutation(SEQ).astype(np.int32)
    rows = np.stack([perm, np.arange(SEQ) * 3 - 8]).astype(np.int32)
    apply = jax.jit(model_j.apply, static_argnames=("return_hidden",))
    for pos in (perm, rows):
        want = apply({"params": params}, jnp.asarray(tokens),
                     positions=jnp.asarray(pos))
        with torch.no_grad():
            got = model_t(torch.from_numpy(tokens),
                          positions=torch.from_numpy(pos))
        _assert_logits(got, want)
    want = apply({"params": params}, jnp.asarray(tokens), return_hidden=True)
    with torch.no_grad():
        got = model_t(torch.from_numpy(tokens), return_hidden=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_noncausal_matches_jax():
    """BERT-style blocks through flash attention at S=128 (one 128-row
    tile, so JAX runs its Pallas kernels in interpret mode): logits,
    loss and gradients against the port's flash path (plain versions on
    the CPU)."""
    seq = 128
    model_j, params, model_t = _pair(seq, j_attn=jflash,
                                     t_attn=flash_attention, max_len=seq)
    tokens = _tokens(4, s=seq)
    labels = np.where(np.random.default_rng(5).random(tokens.shape) < 0.15,
                      tokens, -100).astype(np.int32)

    def loss_j(p):
        logits = model_j.apply({"params": p}, jnp.asarray(tokens))
        valid = labels >= 0
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.maximum(jnp.asarray(labels), 0))
        return (ce * valid).sum() / max(int(valid.sum()), 1), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_j, has_aux=True))(params)
    got_logits = model_t(torch.from_numpy(tokens))
    _assert_logits(got_logits, logits)
    got = train_bert.mlm_loss(got_logits, torch.from_numpy(labels))
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    got.backward()
    _assert_grads(model_t, _grads_to_torch(model_t, grads))


def test_blocked_ce_matches_jax():
    """lm_blocked_loss over a causal Transformer with a dense and a
    sparse block: the f32 table, the MoE aux; loss and gradients."""
    model_j, params, model_t = _pair(causal=True, n_experts=4)
    tokens = _tokens(6)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: j_blocked(model_j, p, jnp.asarray(tokens), chunk=96)))(
            params)
    got = lm_blocked_loss(model_t, torch.from_numpy(tokens), chunk=96)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    got.backward()
    _assert_grads(model_t, _grads_to_torch(model_t, grads))


def test_mlm_step_matches_jax_train_bert():
    """Three adamw steps of examples/bert's make_mlm_step against
    train_bert.make_mlm_step: every loss, and the gradients of step 1."""
    jb = _script("examples/bert/train_bert.py", "_jax_train_bert")
    model_j, params, model_t = _pair()
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        tokens = rng.integers(0, 256, (2, SEQ)).astype(np.int32)
        mask = rng.random(tokens.shape) < 0.15
        batches.append((np.where(mask, 103, tokens).astype(np.int32),
                        np.where(mask, tokens, -100).astype(np.int32)))
    tx = optax.adamw(1e-4, weight_decay=0.01)
    state_j = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params), batch_stats={}, tx=tx)
    step_j = jb.make_mlm_step(model_j)
    state_t = TrainState.create(model_t, optim.AdamW(1e-4,
                                                     weight_decay=0.01))
    step_t = train_bert.make_mlm_step(model_t)
    for tokens, labels in batches:
        state_j, m_j = step_j(state_j, jnp.asarray(tokens),
                              jnp.asarray(labels))
        state_t, m_t = step_t(state_t, torch.from_numpy(tokens),
                              torch.from_numpy(labels))
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5)
    assert state_t.step == 3 == int(state_j.step)
    want = tb.transformer_params_from_jax(
        model_t.cfg, jax.tree.map(np.asarray, state_j.params))
    for name, p in model_t.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_lm_step_matches_jax_train_t5():
    """Three adafactor steps of examples/t5's make_lm_step with the
    blocked CE against train_t5.make_lm_step, over a causal model with a
    sparse block: every loss (lm_train_loss's loss and gradients are
    held by the reference cases above)."""
    blocked = True
    jt5 = _script("examples/t5/train_t5.py", "_jax_train_t5")
    model_j, params, model_t = _pair(causal=True, n_experts=4)
    tx = optax.adafactor(1e-3)
    state_j = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params), batch_stats={}, tx=tx)
    step_j = jt5.make_lm_step(model_j, blocked_ce=blocked)
    state_t = TrainState.create(model_t, optim.Adafactor(1e-3))
    step_t = train_t5.make_lm_step(model_t, blocked_ce=blocked)
    for i in range(3):
        tokens = _tokens(20 + i)
        state_j, m_j = step_j(state_j, jnp.asarray(tokens))
        state_t, m_t = step_t(state_t, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5)
    assert state_t.step == 3 == int(state_j.step)


def test_bf16_forward_matches_jax():
    """The bf16 compute path (f32 masters, bf16 products, the tied head
    a bf16 product) within 2e-2 + 2e-2·|ref|."""
    model_j, params, model_t = _pair(dtype=jnp.bfloat16, causal=True)
    tokens = _tokens(8)
    # every bf16 op rounded, as eager JAX runs it: XLA's default keeps
    # some fused intermediates unrounded
    want = jax.jit(model_j.apply, compiler_options={
        "xla_allow_excess_precision": False})(
            {"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        got = model_t(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


def test_init_transformer_params_draws_flax_scales():
    """Every leaf of the state dict, f32 on the device, seeded (same seed,
    same bits; another seed, other bits), at flax's scales."""
    cfg = tt.tiny(n_experts=2, d_model=128, d_ff=256, vocab_size=512,
                  tie_embeddings=False)
    a = tb.init_transformer_params(cfg, 0, "cpu")
    b = tb.init_transformer_params(cfg, 0, "cpu")
    c = tb.init_transformer_params(cfg, 1, "cpu")
    with torch.device("meta"):
        want = tt.Transformer(cfg).state_dict()
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    stds = {"embed": 128 ** -0.5, "pos_embed": 0.02,
            "blocks.0.attn.qkv": 128 ** -0.5,
            "blocks.0.attn.out": 128 ** -0.5,
            "blocks.0.mlp.wo": 256 ** -0.5,
            "blocks.1.moe.wi": 256 ** -0.5, "blocks.1.moe.wo": 512 ** -0.5,
            "lm_head": 128 ** -0.5}
    for name, std in stds.items():
        assert abs(float(a[name].std()) / std - 1) < 0.1, name
    assert torch.equal(a["ln_f.scale"], torch.ones(128))


def test_mlm_batches_mask_and_refusals():
    """train_bert's batches: 15 % masked ([MASK] in, the token as label),
    the rest labelled -100; a config naming an expert-parallel dispatch
    is taken, and its MoE blocks call it (tests/test_torch_ep.py holds
    make_switch_moe's against JAX's)."""
    tokens, labels = next(train_bert.mlm_batches(8, 64, 1000, 0,
                                                 device="cpu"))
    masked = labels >= 0
    assert 0.08 < float(masked.float().mean()) < 0.22
    assert bool((tokens[masked] == train_bert.MASK_ID).all())
    assert bool((labels[~masked] == -100).all())
    again, _ = next(train_bert.mlm_batches(8, 64, 1000, 0, device="cpu"))
    assert torch.equal(tokens, again)
    seen = []

    def dispatch(x, logits, wi, wo, tp=None):
        seen.append(tuple(logits.shape))
        return x * 0, torch.zeros(())

    cfg = tt.tiny(n_experts=2, moe_every=1, n_layers=1, dtype=torch.float32,
                  moe_dispatch_fn=dispatch)
    tt.Transformer(cfg)(tokens[:2, :8] % cfg.vocab_size, train=False)
    assert seen == [(2, 8, 2)]
