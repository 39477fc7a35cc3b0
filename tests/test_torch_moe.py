"""The port's sparse experts (tf_operator_tpu_torch.parallel.ep and
models/llama.MoeSwiGlu) against the JAX package on the CPU at tiny f32
widths: the routing and the dense dispatches of parallel/ep.py, the
sparse grouped forward against the dense dispatch, MoeSwiGlu at L=1 (the
JAX gather path) and L>1, exact ties, flax's fan-ins, the quantized MoE
tree byte for byte, the per-leaf int8 draw, the config's checks and the
mixtral_8x7b preset."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models import quant as jq
from tf_operator_tpu.parallel import ep as jep
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import quant as tq
from tf_operator_tpu_torch.parallel import ep as tep

T, E, D, FF = 24, 4, 16, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: one torch thread (the count is put back after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------- parallel/ep
@pytest.mark.parametrize("k,capacity,masked", [
    (1, 3, False), (2, 4, True), (2, 12, False), (3, 5, True)])
def test_topk_route_matches_jax(k, capacity, masked):
    """Capacity drops (first choices placed before second ones), the
    valid mask of padding rows, the gates and the aux loss."""
    logits = _draw(1, T, E, scale=2.0)
    valid = np.random.default_rng(2).random(T) > 0.3 if masked else None
    want = jax.jit(jep.topk_route, static_argnums=(1, 2))(
        jnp.asarray(logits), capacity, k,
        None if valid is None else jnp.asarray(valid))
    got = tep.topk_route(_t(logits), capacity, k,
                         None if valid is None else _t(valid))
    for g, w in zip(got, want):
        _close(g, w)
    # capacity really bites somewhere in these cases
    if capacity < T * k // E:
        assert float(got[0].sum()) < (valid.sum() if masked else T) * k


def test_switch_route_matches_jax():
    logits = _draw(3, T, E, scale=2.0)
    want = jax.jit(jep.switch_route, static_argnums=(1,))(
        jnp.asarray(logits), 5)
    for g, w in zip(tep.switch_route(_t(logits), 5), want):
        _close(g, w)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_expert_ffn_matches_jax(act):
    h = _draw(4, 3, 5, 2 * FF)
    _close(tep._expert_ffn(_t(h), act), jep._expert_ffn(jnp.asarray(h), act))


def _moe_inputs(seed, act, b=2, s=6):
    f_in = 2 * FF if act == "swiglu" else FF
    return (_draw(seed, b, s, D), _draw(seed + 1, b, s, E, scale=2.0),
            _draw(seed + 2, E, D, f_in, scale=0.3),
            _draw(seed + 3, E, FF, D, scale=0.3))


@pytest.mark.parametrize("act,k", [("gelu", 1), ("swiglu", 2)])
def test_dense_dispatches_match_jax(act, k):
    """dense_switch_dispatch and dense_reference_moe (at a capacity that
    drops and one that does not), outputs and aux."""
    x, lg, wi, wo = _moe_inputs(5, act)
    want = jax.jit(functools.partial(
        jep.dense_switch_dispatch, activation=act, top_k=k))(
            *map(jnp.asarray, (x, lg, wi, wo)))
    got = tep.dense_switch_dispatch(*map(_t, (x, lg, wi, wo)),
                                    activation=act, top_k=k)
    for g, w in zip(got, want):
        _close(g, w)
    for cap in (2, 12 * k):
        want = jax.jit(functools.partial(
            jep.dense_reference_moe, capacity=cap, activation=act,
            top_k=k))(*map(jnp.asarray, (x, lg, wi, wo)))
        got = tep.dense_reference_moe(*map(_t, (x, lg, wi, wo)), cap,
                                      activation=act, top_k=k)
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("act,k", [("gelu", 1), ("swiglu", 2),
                                   ("swiglu", 3)])
def test_grouped_moe_equals_the_dense_dispatch(act, k):
    """The sparse forward is dense_switch_dispatch's function: output and
    aux, the port's and JAX's; int8 experts give the dense dispatch over
    the dequantized weights; with_aux=False leaves the aux out."""
    x, lg, wi, wo = _moe_inputs(11, act)
    dense = tep.dense_switch_dispatch(*map(_t, (x, lg, wi, wo)),
                                      activation=act, top_k=k)
    got = tep.grouped_moe(*map(_t, (x, lg, wi, wo)), top_k=k, activation=act)
    jwant = jax.jit(functools.partial(
        jep.dense_switch_dispatch, activation=act, top_k=k))(
            *map(jnp.asarray, (x, lg, wi, wo)))
    for g, w, j in zip(got, dense, jwant):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        _close(g, j)
    qi, qo = tq.quantize_tensor(_t(wi), (1,)), tq.quantize_tensor(_t(wo), (1,))
    y, aux = tep.grouped_moe(_t(x), _t(lg), qi, qo, top_k=k, activation=act,
                             with_aux=False)
    want, _ = tep.dense_switch_dispatch(
        _t(x), _t(lg), qi.dequantize(torch.float32),
        qo.dequantize(torch.float32), activation=act, top_k=k)
    assert aux is None
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


def test_ties_take_the_lower_index():
    """Exactly tied probabilities: jax.lax.top_k's order (the lower
    index first), which a stable sort keeps."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                          [0.4, 0.1, 0.4, 0.1]])
    for k in (1, 2, 3):
        want = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
        got = tep._topk(probs, k)
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
        _close(got[0], want[0])


# --------------------------------------------------------------- MoeSwiGlu
def _moe_pair(top_k, zero_router=False):
    cfg_j = jl.tiny(dtype=jnp.float32, n_experts=E, moe_every=1,
                    moe_top_k=top_k)
    cfg_t = tl.tiny(dtype=torch.float32, n_experts=E, moe_every=1,
                    moe_top_k=top_k)
    mod = jl.MoeSwiGlu(cfg_j)
    params = jax.jit(mod.init)(jax.random.PRNGKey(top_k),
                               jnp.zeros((1, 3, cfg_j.d_model)))["params"]
    if zero_router:
        params = dict(params, router={"kernel": jnp.zeros_like(
            params["router"]["kernel"])})
    ours = tl.MoeSwiGlu(cfg_t, torch.float32)
    ours.load_state_dict({"router": _t(params["router"]["kernel"]),
                          "wi": _t(params["wi"]), "wo": _t(params["wo"])})
    return mod, params, ours


@pytest.mark.parametrize("top_k,length,zero_router", [
    (1, 1, False), (2, 5, False), (2, 1, True), (1, 5, True)])
def test_moe_swiglu_matches_jax(top_k, length, zero_router):
    """decode=True at L=1 is JAX's gather path (aux 0), at L=5 its dense
    dispatch; decode=False the training forward.  A zero router ties
    every expert exactly."""
    mod, params, ours = _moe_pair(top_k, zero_router=zero_router)
    x = _draw(20 + length, 3, length, 64)
    for decode in (True, False):
        apply = jax.jit(functools.partial(mod.apply, decode=decode,
                                          mutable=["intermediates"]))
        want, inter = apply({"params": params}, jnp.asarray(x))
        got = ours(_t(x), decode=decode)
        _close(got, want)
        _close(ours.aux_loss,
               inter["intermediates"]["moe_aux_loss"][0])
        if decode and length == 1:
            assert float(ours.aux_loss) == 0.0


# ------------------------------------------------------ weights and quant
def _jax_tiny_params(**kw):
    model = jl.Llama(jl.tiny(dtype=jnp.float32, **kw))
    init = jax.jit(lambda key: model.init(key, jnp.zeros((1, 8), jnp.int32),
                                          train=False)["params"])
    return init(jax.random.PRNGKey(0))


def test_init_params_follow_flax_fans():
    """Experts draw with flax's lecun_normal over a raw [X, D, 2F] / [X,
    F, D] parameter: fan-in X·D / X·F (not D / F); the router's fan-in
    is D.  Measured against 1/sqrt(fan_in) and against a flax init."""
    kw = dict(n_experts=4, moe_every=1, moe_top_k=2, d_model=128, d_ff=256)
    sd = bridge.init_params(tl.tiny(**kw), 0, device="cpu", train=True)
    mod = jl.MoeSwiGlu(jl.tiny(**kw))
    jp = jax.tree.map(np.asarray, jax.jit(mod.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 128)))["params"])
    for name, fan, jw in (("wi", 4 * 128, jp["wi"]), ("wo", 4 * 256, jp["wo"]),
                          ("router", 128, jp["router"]["kernel"])):
        std = float(sd[f"blocks.0.moe.{name}"].std())
        assert abs(std - fan ** -0.5) < 0.03 * fan ** -0.5, (name, std)
        assert abs(std - float(jw.std())) < 0.05 * fan ** -0.5, name


@pytest.mark.parametrize("every,k", [(2, 1)])
def test_quantized_moe_tree_is_jax_byte_for_byte(every, k):
    """quantize_params of the bridged f32 weights of a model with a
    dense block and a sparse one: the sparse block's `moe` leaves equal
    the JAX package's quantize_params of that subtree byte for byte
    (experts per expert and output, the router left in f32; the dense
    layouts are held the same way by test_torch_quant.py), and the dense
    leaves keep the dense layout."""
    params = _jax_tiny_params(n_experts=E, moe_every=every, moe_top_k=k)
    cfg = tl.tiny(dtype=torch.float32, n_experts=E, moe_every=every,
                  moe_top_k=k)
    ours = tq.quantize_params(bridge.params_from_jax(
        cfg, jax.tree.map(np.asarray, params), train=True))
    i = every - 1
    sparse = jax.tree.map(np.asarray, jq.quantize_params(
        {"moe": params[f"block{i}"]["moe"]}))
    p = f"blocks.{i}."
    assert not isinstance(ours[p + "moe.router"], tq.QTensor)
    assert np.array_equal(ours[p + "moe.router"].numpy(),
                          sparse["moe"]["router"]["kernel"])
    assert tuple(ours[p + "moe.wi"].scale.shape) == (E, 1, 256)
    assert tuple(ours[p + "moe.wo"].scale.shape) == (E, 1, 64)
    leaves = {"moe.wi": sparse["moe"]["wi"], "moe.wo": sparse["moe"]["wo"]}
    for name, w in leaves.items():
        g = ours[p + name]
        assert np.array_equal(g.q.numpy(), w.q), name
        assert np.array_equal(g.scale.numpy(), w.scale), name
    assert tuple(ours["blocks.0.mlp.wi"].scale.shape) == (1, 2, 128)
    assert tuple(ours[p + "attn.out"].scale.shape) == (1, 1, 64)
    assert tuple(ours["embed"].scale.shape) == (256, 1)


@pytest.mark.parametrize("kw", [dict(n_experts=4, moe_every=1, moe_top_k=2),
                                dict()])
def test_per_leaf_int8_draw_equals_quantized_init(kw):
    """bridge.init_int8_params draws and quantizes one leaf at a time and
    gives quant.quantize_params(init_params(train=True)) bit for bit."""
    cfg = tl.tiny(tie_embeddings=True, **kw)
    got = bridge.init_int8_params(cfg, 3, device="cpu")
    want = tq.quantize_params(bridge.init_params(cfg, 3, device="cpu",
                                                 train=True))
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, tq.QTensor):
            assert torch.equal(g.q, w.q) and torch.equal(g.scale, w.scale), name
        else:
            assert torch.equal(g, w), name


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("kw", [dict(n_experts=4, moe_every=0),
                                dict(n_experts=4, moe_top_k=5),
                                dict(n_experts=4, moe_top_k=0)])
def test_config_checks_carry_jax_messages(kw):
    with pytest.raises(ValueError) as jerr:
        jl.tiny(**kw)
    with pytest.raises(ValueError) as terr:
        tl.tiny(**kw)
    assert str(terr.value) == str(jerr.value)


def test_moe_dispatch_fn_is_refused():
    """A dispatch function is taken now (parallel/ep.make_switch_moe,
    tests/test_torch_ep.py): the config refuses only one whose routing
    arity differs from moe_top_k, in JAX's words, and MoeSwiGlu calls it
    wherever JAX's does, every forward but a one-token decode step."""
    calls = []

    def fn(x, logits, wi, wo, tp=None):
        calls.append(tuple(x.shape))
        return torch.zeros_like(x), torch.ones((), dtype=torch.float32)

    fn.top_k = 2
    with pytest.raises(ValueError) as jerr:
        jl.tiny(n_experts=4, moe_top_k=1, moe_dispatch_fn=fn)
    with pytest.raises(ValueError) as terr:
        tl.tiny(n_experts=4, moe_top_k=1, moe_dispatch_fn=fn)
    assert str(terr.value) == str(jerr.value)
    cfg = tl.tiny(dtype=torch.float32, n_experts=4, moe_every=1,
                  moe_top_k=2, moe_dispatch_fn=fn)
    moe = tl.Llama.from_params(cfg, bridge.init_params(cfg, 0, device="cpu"),
                               device="cpu").blocks[0].moe
    x = torch.ones((2, 3, cfg.d_model))
    assert torch.equal(moe(x), torch.zeros_like(x))
    assert float(moe.aux_loss) == 1.0
    moe(x, decode=True)
    assert calls == [(2, 3, cfg.d_model)] * 2
    out = moe(x[:, :1], decode=True)          # the gather path
    assert calls == [(2, 3, cfg.d_model)] * 2 and float(out.abs().sum()) > 0
    assert float(moe.aux_loss) == 0.0


def test_mixtral_preset_and_active_flops_match_jax():
    got = dataclasses.asdict(tl.mixtral_8x7b())
    want = dataclasses.asdict(jl.mixtral_8x7b())
    assert set(got) == set(want)
    for key, val in got.items():
        if key == "dtype":
            assert val == torch.bfloat16 and want[key] == jnp.bfloat16
        else:
            assert val == want[key], key
    for cfg_kw in (dict(), dict(n_layers=4), dict(moe_every=2, moe_top_k=1)):
        assert tl.params_flops_per_token(tl.mixtral_8x7b(**cfg_kw)) == \
            jl.params_flops_per_token(jl.mixtral_8x7b(**cfg_kw))
    assert tl.params_flops_per_token(tl.llama3_8b()) == \
        jl.params_flops_per_token(jl.llama3_8b())
    model = tl.Llama(tl.tiny(n_experts=4, moe_every=2), train=True)
    assert [hasattr(b, "moe") for b in model.blocks] == [False, True]
