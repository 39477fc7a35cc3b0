"""The pipelined transformer LM and Llama (models/pipeline,
models/pipeline_llama) against the JAX package's
(tests/test_pipeline_lm.py's and tests/test_pipeline_llama.py's cases
and tolerances).

In one process (every stage held) on the same meshes, from JAX's
weights (params_from_jax) and tokens: the pipelined logits against JAX's
sequential_apply — the witness JAX's tests hold its pipeline to — within
1e-4 (MoE 2e-4), the gradients within atol 2e-4 / rtol 2e-3 (tp and
fsdp meshes), the MoE aux against JAX's grouping-faithful reference (the
blocks each data member routes, __graft_entry__.py's witness) within
1e-5 and against the global batch's within JAX's 0.2, the router's
gradients non-zero and the gradient norm within 2e-2 of JAX's
sequential one, the sliding window and norm_eps, training that
descends, and every refusal word for word.

One spawned job of eight JAX-free gloo ranks (tests/torch_pipeline_util
.pipeline_case) trains __graft_entry__.py's three pipeline meshes (pp x
tp, pp x fsdp, pp x ep with MoE inside the stages and the aux) and the
pipelined Llama with a window on pp x tp, one stage a rank, two adam
steps, against the port's one process (losses and gradient norms 1e-5,
each leaf's update 1e-3 relative error norm); the one process is held
against the sequential witness as __graft_entry__ holds JAX's (loss
1e-4, gradient norm 1e-3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_pipeline_util as pu
from tests import torch_sharded_util as u
from tf_operator_tpu.models import pipeline as jpl
from tf_operator_tpu.models import pipeline_llama as jpll
from tf_operator_tpu.models.llama import LlamaConfig as JLlamaConfig
from tf_operator_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig, lm_loss as jlm_loss)
from tf_operator_tpu.parallel.mesh import make_mesh as jmake_mesh
from tf_operator_tpu_torch.models import pipeline as pl
from tf_operator_tpu_torch.models import pipeline_llama as pll
from tf_operator_tpu_torch.models.llama import LlamaConfig
from tf_operator_tpu_torch.models.transformer import (TransformerConfig,
                                                      lm_loss)
from tf_operator_tpu_torch.parallel import pp
from tf_operator_tpu_torch.parallel.mesh import make_mesh

CASE = "tests.torch_pipeline_util:pipeline_case"
JOBS = {   # tag: (mesh axes, keyword arguments of pipeline_case)
    "pp_tp": (pu.PIPE_MESHES["pp_tp"], dict(kind="lm")),
    "pp_fsdp": (pu.PIPE_MESHES["pp_fsdp"], dict(kind="lm")),
    "pp_ep": (pu.PIPE_MESHES["pp_ep"],
              dict(kind="lm", cfg_kw=dict(n_experts=4), factor=4.0)),
    "llama_window": (pu.PIPE_MESHES["pp_tp"],
                     dict(kind="llama", cfg_kw=dict(sliding_window=5))),
}
LM = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
          max_len=16, causal=True, tie_embeddings=True)
LLAMA = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
             n_layers=4, d_ff=64, max_len=16, tie_embeddings=True)


def _cfgs(kind: str, **kw):
    """(JAX's config, the port's) of test_pipeline_lm's / _llama's _cfg."""
    base = dict(LM if kind == "lm" else LLAMA, **kw)
    if kind == "lm":
        return (JTransformerConfig(dtype=jnp.float32, **base),
                TransformerConfig(dtype=torch.float32, **base))
    return (JLlamaConfig(dtype=jnp.float32, **base),
            LlamaConfig(dtype=torch.float32, **base))


def _mods(kind: str):
    return (jpl, pl) if kind == "lm" else (jpll, pll)


def _data(cfg, batch=8, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, cfg.max_len)).astype(np.int32)


def _case(kind, key, n_stages, batch=8, seed=1, **kw):
    """A case's weights (the port's init_params from a seeded generator)
    and tokens (numpy), as JAX's arrays and the port's tensors."""
    jcfg, cfg = _cfgs(kind, **kw)
    _, mod = _mods(kind)
    tparams = mod.init_params(torch.Generator().manual_seed(key), cfg,
                              n_stages)
    params = pp.tree_map(lambda t: jnp.asarray(t.numpy()), tparams)
    toks = _data(cfg, batch, seed)
    return (jcfg, cfg, params, jnp.asarray(toks), tparams,
            torch.from_numpy(toks).long())


@functools.lru_cache(maxsize=None)
def _jseq(jmod, jcfg, factor=None):
    """JAX's sequential_apply, jitted once a config (one compile beats
    op-by-op dispatch at these sizes)."""
    kw = {} if factor is None else {"capacity_factor": factor}
    return jax.jit(lambda p, t: jmod.sequential_apply(jcfg, p, t, **kw))


@functools.lru_cache(maxsize=None)
def _jgrad(jmod, jcfg):
    return jax.jit(jax.value_and_grad(lambda p, t: jlm_loss(
        jmod.sequential_apply(jcfg, p, t), t)))


def _seq_grads(jmod, jcfg, params, toks):
    """JAX's sequential loss and its gradients."""
    return _jgrad(jmod, jcfg)(params, toks)


def _port_grads(apply, params, toks):
    tree = pp.tree_map(lambda t: t.clone().requires_grad_(), params)
    loss = lm_loss(apply(tree, toks), toks)
    loss.backward()
    return float(loss.detach()), {k: t.grad for k, t
                                  in pp.named_leaves(tree).items()}


def _assert_grads(got, want):
    flat = {".".join(str(k.key) for k in path): np.asarray(g) for path, g
            in jax.tree_util.tree_leaves_with_path(want)}
    assert sorted(got) == sorted(flat)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), flat[k], atol=2e-4, rtol=2e-3,
                                   err_msg=k)


def _messages(port, jax_fn) -> str:
    with pytest.raises(ValueError) as got:
        port()
    with pytest.raises(ValueError) as want:
        jax_fn()
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors on one torch thread: the driver's six workers share
    the cores (ROADMAP, the test-time budget)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The eight-rank job's readings (started first), one process's and
    the sequential witness's."""
    started = u.start({tag: (CASE, axes, kw) for tag, (axes, kw)
                       in JOBS.items()}, tmp_path_factory.mktemp("pipe"))
    one = {tag: u.one_process(CASE, axes=axes, **kw)
           for tag, (axes, kw) in JOBS.items()}
    seq = {tag: u.one_process(CASE, axes=axes, form="sequential", **kw)
           for tag, (axes, kw) in JOBS.items()}
    return {"got": u.join(started), "one": one, "seq": seq}


@pytest.fixture(scope="module")
def lm_seq():
    """JAX's sequential logits of the (key 0, tokens seed 1) weights at 2
    and 4 stages."""
    out = {}
    for n in (2, 4):
        jcfg, _, params, toks, _, _ = _case("lm", 0, n)
        out[n] = np.asarray(_jseq(jpl, jcfg)(params, toks))
    return out


# --------------------------------------------------------------- the LM
@pytest.mark.parametrize(
    "axes,n_stages,n_micro",
    [
        ({"pp": 2, "tp": 2, "dp": 2}, 2, 4),
        ({"pp": 4, "dp": 2}, 4, 2),
        ({"pp": 2, "fsdp": 2, "tp": 2}, 2, 2),
    ],
)
def test_pipelined_logits_match_sequential(lm_seq, axes, n_stages, n_micro):
    _, cfg, _, _, params, toks = _case("lm", 0, n_stages)
    apply = pl.make_pipelined_apply(cfg, make_mesh(axes, world=8), n_micro)
    got = apply(params, toks)
    np.testing.assert_allclose(got.numpy(), lm_seq[n_stages], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), pl.sequential_apply(cfg, params, toks).numpy(),
        atol=1e-4, rtol=1e-4)


def test_pipelined_grads_match_sequential():
    jcfg, cfg, params, toks, tparams, ttoks = _case("lm", 2, 2, seed=3)
    mesh = make_mesh({"pp": 2, "tp": 2, "dp": 2}, world=8)
    loss, got = _port_grads(pl.make_pipelined_apply(cfg, mesh, n_micro=4),
                            tparams, ttoks)
    jloss, want = _seq_grads(jpl, jcfg, params, toks)
    assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    _assert_grads(got, want)


def test_pipelined_train_step_descends():
    """A few adam steps through the pipelined loss reduce it; the first
    loss is JAX's."""
    from tf_operator_tpu_torch.runtime.optim import Adam

    jcfg, cfg, params, toks, tparams, ttoks = _case("lm", 4, 2, seed=5,
                                                    n_layers=2)
    apply = pl.make_pipelined_apply(cfg, make_mesh({"pp": 2, "dp": 4},
                                                   world=8), n_micro=2)
    tree = pp.tree_map(lambda t: t.clone().requires_grad_(), tparams)
    flat = pp.named_leaves(tree)
    tx = Adam(1e-2)
    state = tx.init(flat)
    losses = []
    for _ in range(5):
        loss = pl.pipeline_lm_loss(apply, tree, ttoks)
        loss.backward()
        losses.append(float(loss.detach()))
        state = tx.update_(flat, state)
    assert losses[-1] < losses[0], losses
    want = float(jlm_loss(_jseq(jpl, jcfg)(params, toks), toks))
    assert abs(losses[0] - want) <= 1e-4 * want


def test_init_validates_divisibility():
    jcfg, cfg = _cfgs("lm", n_layers=3)
    msg = _messages(
        lambda: pl.init_params(torch.Generator(), cfg, n_stages=2),
        lambda: jpl.init_params(jax.random.PRNGKey(0), jcfg, n_stages=2))
    assert "not divisible" in msg


def test_apply_validates_batch():
    jcfg, cfg, params, _, tparams, _ = _case("lm", 0, 2, n_layers=2)
    axes = {"pp": 2, "dp": 4}
    msg = _messages(
        lambda: pl.make_pipelined_apply(cfg, make_mesh(axes, world=8), 3)(
            tparams, torch.from_numpy(_data(jcfg, 8)).long()),
        lambda: jpl.make_pipelined_apply(jcfg, jmake_mesh(axes), 3)(
            params, jnp.asarray(_data(jcfg, 8))))
    assert "not divisible" in msg


def test_apply_validates_stage_count():
    jcfg, cfg, params, toks, tparams, ttoks = _case("lm", 0, 4)
    axes = {"pp": 2, "dp": 4}
    msg = _messages(
        lambda: pl.make_pipelined_apply(cfg, make_mesh(axes, world=8), 2)(
            tparams, ttoks),
        lambda: jpl.make_pipelined_apply(jcfg, jmake_mesh(axes), 2)(
            params, toks))
    assert "must match" in msg


def test_init_rejects_unsupported_config():
    for kw, match in ((dict(n_experts=4), "moe_every=1"),
                      (dict(remat=True), "does not support")):
        jcfg, cfg = _cfgs("lm", **kw)
        msg = _messages(
            lambda: pl.init_params(torch.Generator(), cfg, n_stages=2),
            lambda: jpl.init_params(jax.random.PRNGKey(0), jcfg,
                                    n_stages=2))
        assert match in msg


def test_pipelined_fsdp_grads_match_sequential():
    jcfg, cfg, params, toks, tparams, ttoks = _case("lm", 7, 2, seed=8)
    mesh = make_mesh({"pp": 2, "fsdp": 2, "dp": 2}, world=8)
    loss, got = _port_grads(pl.make_pipelined_apply(cfg, mesh, n_micro=2),
                            tparams, ttoks)
    jloss, want = _seq_grads(jpl, jcfg, params, toks)
    assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    _assert_grads(got, want)


# ------------------------------------------------------ MoE in the stages
@functools.lru_cache(maxsize=None)
def _jax_grouped_aux(jcfg, n_micro, n_shards, factor):
    """JAX's sequential aux of each microbatch's data-member blocks,
    averaged: the pipelined aux's grouping (__graft_entry__.py)."""
    def grouped(p, t):
        blocks = t.reshape((n_micro * n_shards, -1) + t.shape[1:])
        return jnp.mean(jax.vmap(lambda sub: jpl.sequential_apply(
            jcfg, p, sub, capacity_factor=factor)[1])(blocks))

    return jax.jit(grouped)


@pytest.mark.parametrize(
    "axes,n_stages,n_micro",
    [
        ({"pp": 2, "ep": 2, "dp": 2}, 2, 2),
        ({"pp": 2, "ep": 2, "fsdp": 2}, 2, 2),
        ({"pp": 2, "ep": 2, "tp": 2}, 2, 2),
    ],
)
def test_pipelined_moe_matches_sequential(axes, n_stages, n_micro):
    """Logits + aux against JAX with no-drop capacity (factor =
    n_experts): the dispatch is a pure re-layout of the same expert
    math."""
    jcfg, cfg, params, toks, tparams, ttoks = _case(
        "lm", 0, n_stages, n_experts=2, moe_every=1)
    factor = float(cfg.n_experts)
    mesh = make_mesh(axes, world=8)
    got, aux = pl.make_pipelined_apply(cfg, mesh, n_micro,
                                       capacity_factor=factor)(tparams, ttoks)
    want, aux_seq = _jseq(jpl, jcfg, factor)(params, toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
    n_shards = mesh.axis_size(("dp", "fsdp", "ep"))
    grouped = float(_jax_grouped_aux(jcfg, n_micro, n_shards, factor)(
        params, toks))
    assert abs(float(aux) - grouped) <= 1e-5 * grouped
    # per-(shard, microbatch) statistics against the global batch's: a
    # deliberate approximation, JAX's loose bound
    assert abs(float(aux) - float(aux_seq)) / max(1e-9, float(aux_seq)) < 0.2
    assert np.isfinite(float(aux))


def test_pipelined_moe_grads_flow_to_router():
    """The aux term backprops through the pipeline's accumulator: router
    grads are non-zero and total-loss grads stay close to sequential."""
    jcfg, cfg, params, toks, tparams, ttoks = _case(
        "lm", 2, 2, seed=3, n_experts=2, moe_every=1)
    factor, w = float(cfg.n_experts), 1e-2
    apply = pl.make_pipelined_apply(
        cfg, make_mesh({"pp": 2, "ep": 2, "dp": 2}, world=8), n_micro=2,
        capacity_factor=factor)
    tree = pp.tree_map(lambda t: t.clone().requires_grad_(), tparams)
    pl.pipeline_lm_loss_with_aux(apply, tree, ttoks, w)[0].backward()
    assert float(tree["stages"]["router"].grad.norm()) > 0
    gn = float(torch.sqrt(sum(t.grad.double().pow(2).sum()
                              for t in pp.named_leaves(tree).values())))

    def seq_loss(p):
        logits, aux = jpl.sequential_apply(jcfg, p, toks,
                                           capacity_factor=factor)
        return jlm_loss(logits, toks) + w * aux

    gn_seq = float(optax.global_norm(jax.jit(jax.grad(seq_loss))(params)))
    assert abs(gn - gn_seq) / gn_seq < 2e-2, (gn, gn_seq)


def test_pipelined_moe_requires_moe_every_1():
    jcfg, cfg = _cfgs("lm", n_experts=2, moe_every=2)
    axes = {"pp": 2, "dp": 4}
    msg = _messages(
        lambda: pl.make_pipelined_apply(cfg, make_mesh(axes, world=8), 2),
        lambda: jpl.make_pipelined_apply(jcfg, jmake_mesh(axes), 2))
    assert "moe_every=1" in msg
    # MoE needs the capacity factor, on both sides of the witness
    jcfg, cfg, params, toks, tparams, ttoks = _case(
        "lm", 0, 2, n_experts=2, moe_every=1)
    _messages(lambda: pl.make_pipelined_apply(cfg, make_mesh(axes, world=8),
                                              2),
              lambda: jpl.make_pipelined_apply(jcfg, jmake_mesh(axes), 2))
    _messages(lambda: pl.sequential_apply(cfg, tparams, ttoks),
              lambda: jpl.sequential_apply(jcfg, params, toks))


# ------------------------------------------------------------ the Llama
@pytest.mark.parametrize(
    "axes,n_stages,n_micro",
    [
        ({"pp": 2, "tp": 2, "dp": 2}, 2, 4),
        ({"pp": 4, "dp": 2}, 4, 2),
        ({"pp": 2, "fsdp": 2, "dp": 2}, 2, 2),
    ],
)
def test_pipelined_llama_logits_match_sequential(axes, n_stages, n_micro):
    jcfg, cfg, params, toks, tparams, ttoks = _case("llama", 0, n_stages)
    got = pll.make_pipelined_apply(cfg, make_mesh(axes, world=8), n_micro)(
        tparams, ttoks)
    want = _jseq(jpll, jcfg)(params, toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_pipelined_llama_grads_match_sequential():
    jcfg, cfg, params, toks, tparams, ttoks = _case("llama", 2, 2, seed=3)
    mesh = make_mesh({"pp": 2, "tp": 2, "dp": 2}, world=8)
    loss, got = _port_grads(pll.make_pipelined_apply(cfg, mesh, n_micro=4),
                            tparams, ttoks)
    jloss, want = _seq_grads(jpll, jcfg, params, toks)
    assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    _assert_grads(got, want)


def test_pipelined_llama_sliding_window_matches_sequential():
    """The banded mask threads through the pipeline identically."""
    jcfg, cfg, params, toks, tparams, ttoks = _case(
        "llama", 4, 2, seed=5, sliding_window=5)
    got = pll.make_pipelined_apply(
        cfg, make_mesh({"pp": 2, "tp": 2, "dp": 2}, world=8), n_micro=2)(
            tparams, ttoks)
    want = _jseq(jpll, jcfg)(params, toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # and the window actually bites vs the full-causal model
    full = pll.sequential_apply(_cfgs("llama")[1], tparams, ttoks)
    assert not np.allclose(np.asarray(want)[:, -1], full.numpy()[:, -1],
                           atol=1e-3)


def test_pipelined_llama_validations():
    for kw, n, match in ((dict(tie_embeddings=False), 2, "tied"),
                         (dict(n_layers=3), 2, "divisible"),
                         (dict(n_experts=4), 2, "n_experts")):
        jcfg, cfg = _cfgs("llama", **kw)
        msg = _messages(
            lambda: pll.init_params(torch.Generator(), cfg, n),
            lambda: jpll.init_params(jax.random.PRNGKey(0), jcfg, n))
        assert match in msg
    jcfg, cfg = _cfgs("llama")
    axes = {"pp": 2, "tp": 4}
    msg = _messages(   # tp=4 > kv=2
        lambda: pll.make_pipelined_apply(cfg, make_mesh(axes, world=8), 2),
        lambda: jpll.make_pipelined_apply(jcfg, jmake_mesh(axes), 2))
    assert "n_kv_heads" in msg


def test_pipelined_llama_train_step_descends():
    from tf_operator_tpu_torch.runtime.optim import Adam

    jcfg, cfg, params, _, tparams, _ = _case("llama", 6, 2)
    toks = jnp.tile(jnp.arange(jcfg.max_len)[None] % 7, (8, 1))
    ttoks = torch.from_numpy(np.array(toks)).long()
    apply = pll.make_pipelined_apply(
        cfg, make_mesh({"pp": 2, "tp": 2, "dp": 2}, world=8), n_micro=2)
    tree = pp.tree_map(lambda t: t.clone().requires_grad_(), tparams)
    flat = pp.named_leaves(tree)
    tx = Adam(5e-3)
    state = tx.init(flat)
    losses = []
    for _ in range(10):
        loss = pll.pipeline_lm_loss(apply, tree, ttoks)
        loss.backward()
        losses.append(float(loss.detach()))
        state = tx.update_(flat, state)
    assert losses[-1] < losses[0], losses
    want = float(jlm_loss(_jseq(jpll, jcfg)(params, toks), toks))
    assert abs(losses[0] - want) <= 1e-4 * want


def test_pipelined_llama_respects_norm_eps():
    """cfg.norm_eps reaches the RMS norms: a different eps changes the
    output, and the port's equals JAX's at that eps."""
    jcfg, cfg, params, toks, tparams, ttoks = _case("llama", 0, 2)
    jcfg_b, cfg_b = _cfgs("llama", norm_eps=0.5)
    a = pll.sequential_apply(cfg, tparams, ttoks)
    b = pll.sequential_apply(cfg_b, tparams, ttoks)
    assert not np.allclose(a.numpy(), b.numpy(), atol=1e-3)
    np.testing.assert_allclose(
        b.numpy(), np.asarray(_jseq(jpll, jcfg_b)(params, toks)),
        atol=1e-4, rtol=1e-4)


# ------------------------------------------------------ the spawned job
@pytest.mark.parametrize("tag", sorted(JOBS))
def test_pipeline_job_equals_one_process(job, tag):
    """One stage a rank (ProcessRing hops, tp / fsdp / ep collectives in
    the stages, the data members' gradients reduced) = every stage in one
    process; one process = the sequential witness."""
    got, one, seq = job["got"][tag], job["one"][tag], job["seq"][tag]
    u.check(got, one, adam=True, tag=tag)
    if one["aux"][0] is not None:
        for a, b in zip(got["aux"], one["aux"]):
            assert abs(a - b) <= 1e-5 * abs(b), (tag, a, b)
    for a, b in zip(one["losses"], seq["losses"]):
        assert abs(a - b) <= 1e-4 * abs(b), (tag, a, b)
    for a, b in zip(one["gnorms"], seq["gnorms"]):
        assert abs(a - b) <= 1e-3 * abs(b), (tag, a, b)
