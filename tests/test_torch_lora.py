"""The port's LoRA (tf_operator_tpu_torch.models.lora) against the JAX
package's models/lora.py, on the CPU at tiny f32 sizes: the seven cases
of tests/test_lora.py with JAX's adapters carried across
(lora.adapters_from_jax) onto the same weights (bridge.params_from_jax),
the finetune's adapters after 30 Adam steps against optax's, the
training form (adapters attached as parametrizations) against the
functional one, with and without remat, an optimizer state that holds
the adapters alone, and LoRA under two gloo ranks against one process
on the whole batch (tests/torch_dp_util.py; the tp x fsdp half of the
JAX case is ROADMAP Queue 1 item 11b).

Tolerances (f32): logits and gradients 1e-5 relative against JAX (the
same math in another library's order); the zero-init identity and the
frozen base bit for bit; adapters after the finetune within 1e-5 of
optax's; merge vs attached logits 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

from tests import torch_dp_util as u
from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models import lora as jlora
from tf_operator_tpu.models import transformer as jt
from tf_operator_tpu.models.transformer import lm_loss as jlm_loss
from tf_operator_tpu_torch import train_llama
from tf_operator_tpu_torch.models import bridge, lora
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import transformer as tt
from tf_operator_tpu_torch.models.transformer import lm_loss
from tf_operator_tpu_torch.models.transformer_bridge import (
    transformer_from_params, transformer_params_from_jax)
from tf_operator_tpu_torch.runtime.optim import Adam
from tf_operator_tpu_torch.runtime.train import TrainState


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _pair(**kw):
    """The tiny f32 Llama of both frameworks over JAX's init, and tokens."""
    jcfg = jl.tiny(dtype=jnp.float32, **kw)
    model_j = jl.Llama(jcfg)
    toks = jax.random.randint(jax.random.PRNGKey(0), (2, jcfg.max_len), 0,
                              jcfg.vocab_size)
    params = model_j.init(jax.random.PRNGKey(0), toks, train=False)["params"]
    tcfg = tl.tiny(dtype=torch.float32, **kw)
    sd = bridge.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                train=True)
    return dict(model_j=model_j, params=params, toks=toks, tcfg=tcfg, sd=sd,
                t_toks=torch.from_numpy(np.array(toks)).long())


def _llama(cfg, sd):
    return tl.Llama.from_params(cfg, {k: v.clone() for k, v in sd.items()},
                                device="cpu", train=True)


def test_zero_init_is_identity():
    """B = 0: the adapted model equals the base exactly, functional and
    attached, and JAX's adapted model within 1e-5."""
    p = _pair()
    ad_j = jlora.init(jax.random.PRNGKey(1), p["params"], rank=4)
    want = jax.jit(lambda q, a, t: p["model_j"].apply(
        {"params": jlora.apply_to(q, a)}, t))(p["params"], ad_j, p["toks"])
    adapters = lora.adapters_from_jax(ad_j)
    base = _llama(p["tcfg"], p["sd"])
    with torch.no_grad():
        base_logits = base(p["t_toks"])
        eff = _llama(p["tcfg"], lora.apply_to(p["sd"], adapters))(p["t_toks"])
        lora.attach(base, adapters)
        attached = base(p["t_toks"])
    assert torch.equal(eff, base_logits) and torch.equal(attached,
                                                         base_logits)
    assert rel(eff, want) <= 1e-5


def test_targets_and_param_count():
    """The port's init targets the kernels JAX's does, at its shapes."""
    p = _pair()
    ad_j = lora.adapters_from_jax(
        jlora.init(jax.random.PRNGKey(1), p["params"], rank=2))
    gen = torch.Generator().manual_seed(1)
    adapters = lora.init(gen, p["sd"], rank=2)
    assert len(adapters) == 5 * p["tcfg"].n_layers
    assert set(adapters) == set(ad_j)
    for k, ad in adapters.items():
        assert {n: t.shape for n, t in ad.items()} == \
            {n: t.shape for n, t in ad_j[k].items()}, k
        assert not ad["b"].any() and ad["a"].dtype == torch.float32
    assert all("embed" not in k and "ln" not in k for k in adapters)
    assert lora.n_params(adapters) == jlora.n_params(
        jlora.init(jax.random.PRNGKey(1), p["params"], rank=2))
    total = sum(v.numel() for v in p["sd"].values())
    assert lora.n_params(adapters) < total * 0.2
    with pytest.raises(ValueError, match="no kernels matched"):
        lora.init(gen, p["sd"], rank=2, targets=("nonexistent",))
    with pytest.raises(ValueError, match="rank"):
        lora.init(gen, p["sd"], rank=0)


def test_adapter_finetune_moves_only_adapters():
    """30 steps of Adam(5e-3) over attached adapters (train_llama's step
    on the untied model's lm_loss) against optax.adam over JAX's
    make_lora_loss: the adapters after the steps within 1e-5, the loss
    falls, the base stays bit for bit, merge reproduces the attached
    model."""
    p = _pair()
    cfg = p["tcfg"]
    toks_j = jnp.tile(jnp.arange(cfg.max_len)[None] % 5, (4, 1))
    ad_j = jlora.init(jax.random.PRNGKey(2), p["params"], rank=4)
    loss_fn = jlora.make_lora_loss(
        lambda q, t: jlm_loss(p["model_j"].apply({"params": q}, t), t),
        p["params"])
    tx = optax.adam(5e-3)
    opt = tx.init(ad_j)

    @jax.jit
    def step_j(adapters, opt, t):
        loss, g = jax.value_and_grad(loss_fn)(adapters, t)
        up, opt = tx.update(g, opt, adapters)
        return optax.apply_updates(adapters, up), opt, loss

    model = _llama(cfg, p["sd"])
    state = TrainState.create(
        model, Adam(5e-3),
        params=lora.attach(model, lora.adapters_from_jax(ad_j)))
    step = train_llama.make_lm_step(model)
    toks = torch.from_numpy(np.array(toks_j)).long()
    losses_j, losses = [], []
    for _ in range(30):
        ad_j, opt, loss_j = step_j(ad_j, opt, toks_j)
        state, m = step(state, toks)
        losses_j.append(float(loss_j))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    assert losses[-1] < losses[0] * 0.7
    want = lora.adapters_from_jax(jax.tree.map(np.asarray, ad_j))
    got = lora.adapters_of(model)
    for k, ad in got.items():
        for n in ("a", "b"):
            torch.testing.assert_close(ad[n], want[k][n], rtol=0, atol=1e-5,
                                       msg=f"{k}.{n}")
    base = lora.base_params(model)
    assert set(base) == set(p["sd"])
    assert all(torch.equal(base[k], v) for k, v in p["sd"].items())
    with torch.no_grad():
        attached = model(toks)
        merged = _llama(cfg, lora.merge(p["sd"], got))(toks)
        base_loss = float(lm_loss(_llama(cfg, p["sd"])(toks), toks))
    torch.testing.assert_close(merged, attached, rtol=0, atol=1e-6)
    assert base_loss > losses[-1]
    # merged in place: the same weights as merge's, the adapters gone
    lora.merge_into(model)
    assert lora.adapter_params(model) == {}
    assert set(model.state_dict()) == set(p["sd"])
    merged_sd = lora.merge(p["sd"], got)
    assert all(torch.equal(v, merged_sd[k])
               for k, v in model.state_dict().items())


def test_optimizer_holds_only_the_adapters():
    """TrainState over lora.attach's parameters: Adam's moments hold
    exactly 2 x n_params(adapters) elements, the base takes no gradient,
    and a step moves the adapters alone."""
    p = _pair()
    model = _llama(p["tcfg"], p["sd"])
    adapters = lora.init(torch.Generator().manual_seed(0), p["sd"], rank=4)
    state = TrainState.create(model, Adam(1e-3),
                              params=lora.attach(model, adapters))
    moments = sum(t.numel() for m in ("mu", "nu")
                  for t in state.opt_state[m].values())
    assert moments == 2 * lora.n_params(adapters)
    assert set(state.params) == {f"{k}.{n}" for k in adapters
                                 for n in ("a", "b")}
    state, _ = train_llama.make_lm_step(model)(state, p["t_toks"])
    assert all(v.grad is None and not v.requires_grad
               for v in lora.base_params(model).values())
    assert any(b.any() for b in (ad["b"] for ad in
                                 lora.adapters_of(model).values()))


def test_attached_gradients_equal_functional_with_and_without_remat():
    """The adapters' gradients of the attached model (remat recomputes
    each block: the effective weight is rebuilt in the recompute) equal
    those of lora.make_lora_loss over the functional effective params."""
    p = _pair()
    gen = torch.Generator().manual_seed(3)
    adapters = lora.init(gen, p["sd"], rank=2)
    for ad in adapters.values():
        ad["b"].normal_(0.0, 0.1, generator=gen)
    plain = _llama(p["tcfg"], p["sd"])
    loss_of = lora.make_lora_loss(
        lambda q, t: lm_loss(functional_call(plain, q, (t,)), t), p["sd"])
    leaves = {k: {n: t.clone().requires_grad_() for n, t in ad.items()}
              for k, ad in adapters.items()}
    loss_of(leaves, p["t_toks"]).backward()
    for remat in (False, True):
        cfg = tl.tiny(dtype=torch.float32, remat=remat)
        model = _llama(cfg, p["sd"])
        params = lora.attach(model, adapters)
        lm_loss(model(p["t_toks"]), p["t_toks"]).backward()
        for k, ad in leaves.items():
            for n in ("a", "b"):
                torch.testing.assert_close(params[f"{k}.{n}"].grad,
                                           ad[n].grad, rtol=1e-5,
                                           atol=1e-7, msg=(remat, k, n))


def test_transformer_family_qkv_target():
    jcfg = jt.tiny(causal=True)
    model_j = jt.Transformer(jcfg)
    toks = jax.random.randint(jax.random.PRNGKey(0), (2, jcfg.max_len), 0,
                              jcfg.vocab_size)
    params = model_j.init(jax.random.PRNGKey(0), toks, train=False)["params"]
    ad_j = jlora.init(jax.random.PRNGKey(1), params, rank=2)
    adapters = lora.adapters_from_jax(ad_j)
    assert any(k.endswith("attn.qkv") for k in adapters)
    tcfg = tt.tiny(causal=True)
    sd = transformer_params_from_jax(tcfg, jax.tree.map(np.asarray, params))
    assert set(lora.init(torch.Generator(), sd, rank=2)) == set(adapters)
    t_toks = torch.from_numpy(np.array(toks)).long()
    with torch.no_grad():
        base = transformer_from_params(tcfg, sd, device="cpu")(t_toks)
        eff = transformer_from_params(
            tcfg, lora.apply_to(sd, adapters), device="cpu")(t_toks)
    assert torch.equal(base, eff)


def test_lora_under_data_parallel_ranks(tmp_path):
    """A LoRA finetune's two steps on two gloo ranks, each on its rows:
    the adapters (bit-equal on both ranks) and losses equal one process
    on the whole batch within 1e-5."""
    r0, r1 = (r["lora"] for r in u.spawn(["lora"], tmp_path))
    ref = u.one_process("lora")
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=1e-5)
    assert set(r0["params"]) == set(ref["params"])
    assert all(k.endswith((".a", ".b")) for k in ref["params"])
    for k, v in ref["params"].items():
        assert torch.equal(r0["params"][k], r1["params"][k]), k
        assert not torch.equal(v, ref["start"][k]), k
        torch.testing.assert_close(r0["params"][k], v, rtol=1e-5, atol=1e-5,
                                   msg=k)


def test_out_kernel_true_fanin():
    """The attention out kernel [H, D, E] contracts (H, D): A [H*D, r],
    B [r, E], as JAX's init shapes it."""
    p = _pair()
    adapters = lora.init(torch.Generator(), p["sd"], rank=2)
    ad = adapters["blocks.0.attn.out"]
    h, d, e = p["sd"]["blocks.0.attn.out"].shape
    assert ad["a"].shape == (h * d, 2) and ad["b"].shape == (2, e)
    ad_j = jlora.init(jax.random.PRNGKey(1), p["params"], rank=2)
    assert ad_j["block0/attn/out/kernel"]["a"].shape == (h * d, 2)
    # A ~ N(0, 1) / sqrt(H*D), not / sqrt(H)
    assert 0.5 < float(ad["a"].std() * (h * d) ** 0.5) < 1.5


def test_moe_expert_banks_are_adapted():
    """Expert banks get one adapter per expert; the zero-init identity
    holds; the adapters' gradients are finite, reach the experts and
    equal JAX's within 1e-5."""
    p = _pair(n_experts=4, moe_every=1)
    ad_j = jlora.init(jax.random.PRNGKey(1), p["params"], rank=2)
    adapters = lora.adapters_from_jax(ad_j)
    wi = adapters["blocks.0.moe.wi"]
    x, d_in, two_f = p["sd"]["blocks.0.moe.wi"].shape
    assert wi["a"].shape == (x, d_in, 2) and wi["b"].shape == (x, 2, two_f)
    ours = lora.init(torch.Generator(), p["sd"], rank=2)
    assert {k: v["a"].shape for k, v in ours.items()} == \
        {k: v["a"].shape for k, v in adapters.items()}
    base = _llama(p["tcfg"], p["sd"])
    with torch.no_grad():
        assert torch.equal(
            base(p["t_toks"]),
            _llama(p["tcfg"], lora.apply_to(p["sd"], adapters))(p["t_toks"]))
    g_j = jax.jit(jax.grad(jlora.make_lora_loss(
        lambda q, t: jlm_loss(p["model_j"].apply({"params": q}, t), t),
        p["params"])))(ad_j, p["toks"])
    g_j = lora.adapters_from_jax(jax.tree.map(np.asarray, g_j))
    params = lora.attach(base, adapters)
    lm_loss(base(p["t_toks"]), p["t_toks"]).backward()
    assert all(bool(torch.isfinite(v.grad).all()) for v in params.values())
    assert float(sum(v.grad.norm() for k, v in params.items()
                     if ".moe." in k)) > 0
    for k, ad in g_j.items():
        assert rel(params[f"{k}.b"].grad, ad["b"]) <= 1e-5, k


def test_stale_adapters_fail_loudly():
    p = _pair()
    adapters = lora.init(torch.Generator(), p["sd"], rank=2)
    adapters["blocks.99.attn.wq"] = adapters.pop("blocks.0.attn.wq")
    with pytest.raises(ValueError, match="absent from the param tree"):
        lora.apply_to(p["sd"], adapters)
    with pytest.raises(ValueError, match="absent from the param tree"):
        lora.attach(_llama(p["tcfg"], p["sd"]), adapters)
