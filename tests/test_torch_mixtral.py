"""A tiny Mixtral (4 SwiGLU experts in every block, top-2) end to end on
the CPU, the port against the JAX package over one set of f32 weights:
full-forward logits; paged serving under the slot and the continuous
scheduler (tokens and schedule), with int8 weights, and
speculatively; dense generate; three adafactor steps of the training
step (loss and gradients); and train_llama --smoke --model mixtral.

serve_loop, the speculative rounds, paging and generate need no MoE
code: only the block's FFN differs, and the JAX package serves it the
same way (its gather path at single-token steps, its dense dispatch
elsewhere; the port's grouped forward everywhere)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_serving_util import prompts, schedule
from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models import quant as jq
from tf_operator_tpu.models.serving import serve_loop as jax_serve
from tf_operator_tpu.ops.blocked_ce import lm_blocked_loss as jax_blocked
from tf_operator_tpu.runtime.train import TrainState as JTrainState
from tf_operator_tpu_torch import train_llama as ttl
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import quant as tq
from tf_operator_tpu_torch.models.serving import serve_loop
from tf_operator_tpu_torch.ops.blocked_ce import lm_blocked_loss
from tf_operator_tpu_torch.runtime import optim
from tf_operator_tpu_torch.runtime.train import TrainState

MOE = dict(n_experts=4, moe_every=1, moe_top_k=2)
PROMPTS = prompts([7, 7, 7], seed=4)
SERVE = dict(slots=2, max_new_tokens=[6, 9, 5], block_size=4,
             steps_per_sync=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: one torch thread (the count is put back after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init(cfg, seed=0):
    model = jl.Llama(cfg)
    return model, jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 8), jnp.int32), train=False)["params"])(
            jax.random.PRNGKey(seed))


def _port(params, train=False, **kw):
    cfg = tl.tiny(**{"dtype": torch.float32, "max_len": 128, **MOE, **kw})
    return tl.Llama.from_params(
        cfg, bridge.params_from_jax(cfg, jax.tree.map(np.asarray, params),
                                    train=train),
        device="cpu", train=train)


@pytest.fixture(scope="module")
def models():
    jmodel, params = _init(jl.tiny(dtype=jnp.float32, max_len=128, **MOE))
    return jmodel, params, _port(params)


def _serve_both(models, jax_kw=None, port_kw=None, **kw):
    jmodel, params, tmodel = models
    want, jstats = jax_serve(jmodel, params, [jnp.asarray(p) for p in PROMPTS],
                             paged=True, paged_kernel="gather",
                             return_stats=True, **(jax_kw or {}), **kw)
    got, stats = serve_loop(tmodel, PROMPTS, device="cpu", return_stats=True,
                            **(port_kw or {}), **kw)
    assert schedule(got) == schedule(want)
    assert stats.fused_prefill_tokens == jstats.fused_prefill_tokens
    return got


def test_logits_match_jax(models):
    jmodel, params, tmodel = models
    tokens = np.random.default_rng(3).integers(0, 256, (2, 16))
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert [hasattr(b, "moe") for b in tmodel.blocks] == [True, True]


@pytest.mark.parametrize("scheduler", ["slot", "continuous"])
def test_paged_serving_matches_jax(models, scheduler):
    """Tokens and schedule; the continuous run streams 4-token segments
    into the decode dispatches."""
    extra = {"prefill_chunk": 4} if scheduler == "continuous" else {}
    got = _serve_both(models, scheduler=scheduler, **SERVE, **extra)
    assert [len(r.tokens) for r in got] == SERVE["max_new_tokens"]


def test_int8_weights_serving_matches_jax(models):
    """quantize_params' tree (experts per expert and output, router in
    f32) under the continuous scheduler, the port dequantizing the
    routed experts only at each step, against JAX serving the tree its
    dequantizer makes (make_dequantizer applies dequantize_params inside
    the step; taken outside, the same f32 products reuse the compiled
    steps of the f32 runs)."""
    jmodel, params, _ = models
    qp = jq.quantize_params(params)
    _serve_both((jmodel, jq.dequantize_params(qp, jnp.float32), _port(qp)),
                scheduler="continuous", prefill_chunk=4, **SERVE)


def test_speculative_serving_matches_jax(models):
    """A 1-layer draft (the target's first block): tokens, schedule and
    the accepted/proposed drafts of each request."""
    jmodel, params, tmodel = models
    jdraft = jl.Llama(jl.tiny(dtype=jnp.float32, max_len=128, n_layers=1,
                              **MOE))
    dparams = {k: v for k, v in params.items() if k != "block1"}
    got = _serve_both(models, jax_kw=dict(draft=jdraft, draft_params=dparams),
                      port_kw=dict(draft=_port(dparams, n_layers=1)),
                      spec_k=3, **SERVE)
    assert sum(r.proposed_drafts for r in got) > 0


def test_generate_matches_jax(models):
    jmodel, params, tmodel = models
    prompt = np.stack([PROMPTS[2], PROMPTS[0]])
    want = jl.generate(jmodel, params, jnp.asarray(prompt), 7)
    got = tl.generate(tmodel, prompt, 7, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()


def test_train_step_matches_jax():
    """The tied, remat f32 model's blocked-CE step: the step-1 gradients
    of every parameter (router and experts included) within 2e-4, the
    loss of each of three adafactor steps within 1e-5."""
    seq = 32
    batches = [np.random.default_rng(20 + i).integers(0, 256, (2, seq))
               .astype(np.int32) for i in range(3)]
    jmodel, params = _init(jl.tiny(dtype=jnp.float32, tie_embeddings=True,
                                   remat=True, **MOE), seed=1)
    model_t = _port(params, train=True, tie_embeddings=True, remat=True,
                    max_len=64)

    tx = optax.adafactor(1e-3)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step_j(state, tokens):
        loss, grads = jax.value_and_grad(
            lambda p: jax_blocked(jmodel, p, tokens))(state.params)
        return state.apply_gradients(grads), loss, grads

    state_j = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params), batch_stats={}, tx=tx)
    state_t = TrainState.create(model_t, optim.Adafactor(1e-3))
    step_t = ttl.make_lm_step(model_t)
    for i, tokens in enumerate(batches):
        state_j, loss_j, grads_j = step_j(state_j, jnp.asarray(tokens))
        if i == 0:
            # the step-1 gradients, read before the optimizer consumes them
            want = bridge.params_from_jax(
                model_t.cfg, jax.tree.map(np.asarray, grads_j), train=True)
            lm_blocked_loss(model_t, torch.from_numpy(tokens)).backward()
            for k, p in model_t.named_parameters():
                torch.testing.assert_close(p.grad, want[k], rtol=2e-4,
                                           atol=2e-4, msg=k)
                p.grad = None
        state_t, m_t = step_t(state_t, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(m_t["loss"]), float(loss_j),
                                   rtol=1e-5)
    # the last forward's aux losses stay on the blocks, finite
    assert all(torch.isfinite(b.moe.aux_loss) for b in model_t.blocks)


def test_train_llama_smoke_mixtral(capsys):
    assert ttl.main(["--smoke", "--device", "cpu", "--model", "mixtral",
                     "--steps", "3", "--per-host-batch", "2",
                     "--seq-len", "16"]) == 0
    out = capsys.readouterr().out
    assert "model mixtral (smoke)" in out and "complete: steps=3" in out


def test_int8_serving_model_keeps_the_router_in_f32(models):
    _, params, _ = models
    model = _port(jq.quantize_params(params))
    moe = model.blocks[0].moe
    assert moe.router.dtype == torch.float32
    assert moe.wi.dtype == torch.int8 and moe.wi_scale.shape == (4, 1, 256)
    assert tq.quantized_bytes(tq.quantize_params(
        bridge.init_params(model.cfg, 0, device="cpu", train=True))) > 0
