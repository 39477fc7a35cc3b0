"""Expert parallelism (parallel/ep.make_switch_moe, the ep axis of
parallel/placement, LlamaConfig / TransformerConfig.moe_dispatch_fn,
train_llama --ep) held against the JAX package.

In one process, on the forced host devices for JAX (tests/test_ep.py's
cases): the one-process oracle of JAX's ep semantics
(tests/torch_sharded_util.ep_oracle, the reference of the training
cases) against JAX's make_switch_moe, output, aux loss and the gradients
of x, the logits and the experts, with and without drops, ragged token
counts, top-1 gelu and top-2 swiglu; the refusals and the config check's
messages; the train_llama --ep SystemExit messages word for word; every
leaf's spec (the parameters, adafactor's and adam's states, an int8
tree's payloads and scales) and every rank's block of an ep mesh against
JAX's state_sharding and jax.device_put.

One spawned job of eight JAX-free gloo ranks (tests/torch_sharded_util.py)
runs the distributed cases on JAX's own meshes: the dispatch over ep 2
(x tp 4) and ep 4 (x dp 2), each data member holding its own rows inside
a step or every rank the global batch, against JAX's make_switch_moe on
the same global arrays, within 1e-5, with the drops each case makes at
capacity factor 1.25 and 1.0; the aux loss of a ragged batch, which
excludes its padding; the refusal of a batch split over other ranks
than the data axes; a mixtral smoke train_llama step on tp 2 x ep 2 x
dp 2 and ep 2 x fsdp 2 x dp 2 against ep_oracle (factors 1.0 and 1.25,
which drop); llama.generate with the dispatch function (test_ep.py:192)
on ep 4 x dp 2 giving JAX's tokens at factor 4.0 and at 1.25, where
drops bind: over whole weights, over a model placed on ep 4 x tp 2, and
over one placed on ep 4 x dp 2 whose cache splits a 4-row batch over dp;
the MoE Transformer's forward (test_ep.py:101) against JAX's at both
factors; and train_llama --smoke --model mixtral --tp 2 --ep 2 as the
eight ranks of a job.  A second job, four ranks on pp 2 x dp 2, trains
a placed llama as one process does (a pp axis replicates every leaf).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_sharded_util as u
from tests.test_torch_mesh import (_at, _jax_shapes, _pad, _spec,
                                   check_state_sharding)
from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models import quant as jq
from tf_operator_tpu.models import transformer as jt
from tf_operator_tpu.parallel import ep as jep
from tf_operator_tpu.parallel import mesh as jm
from tf_operator_tpu.parallel import tp as jtp
from tf_operator_tpu_torch import train_llama
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import quant as tq
from tf_operator_tpu_torch.models import transformer as tt
from tf_operator_tpu_torch.models.transformer_bridge import (
    transformer_params_from_jax)
from tf_operator_tpu_torch.parallel import ep as pep
from tf_operator_tpu_torch.parallel import mesh as pm
from tf_operator_tpu_torch.parallel import tp as ptp

TRAIN = {
    "mixtral_tp2_ep2_dp2": ({"tp": 2, "ep": 2, "dp": 2},
                            dict(moe=True, ep=(2, 1.0))),
    "mixtral_ep2_fsdp2_dp2": ({"ep": 2, "fsdp": 2, "dp": 2},
                              dict(moe=True, ep=(2, 1.25))),
}
JAX_MESH = {"ep": 4, "dp": 2}        # test_ep.py's mesh
PP_MESH = {"pp": 2, "dp": 2}
GEN_KW = dict(n_experts=4, moe_every=1, max_len=32)
GEN = {  # capacity factor, prompt rows
    "top1": (4.0, 3),
    "top1_drops": (1.25, 3),
    "top1_drops_4rows": (1.25, 4),
}
GEN_JOBS = {  # job suffix: (mesh axes, placed)
    "": (JAX_MESH, False),
    "_placed": ({"ep": 4, "tp": 2}, True),
    "_placed_dp": (JAX_MESH, True),
}
TFM = dict(n_experts=4, moe_every=1)
TFM_FACTORS = {"ample": 4.0, "drops": 1.25}
CLI = ["--smoke", "--model", "mixtral", "--tp", "2", "--ep", "2",
       "--steps", "2", "--per-host-batch", "2", "--seq-len", "16"]


def _jax_moe(n_ep, b, s, n_e, factor, top_k, act, seed):
    """JAX's make_switch_moe on the 8 devices: y, aux and the gradients
    of sum(y·R) + 0.01·aux."""
    jmesh = jm.make_mesh({"ep": n_ep, "dp": 8 // n_ep})
    fn = jep.make_switch_moe(jmesh, n_e, factor, activation=act,
                             top_k=top_k)
    x, lg, wi, wo, r = u.ep_inputs(seed, b, s, n_e, act)

    def loss(x, lg, wi, wo):
        y, aux = fn(x, lg, wi, wo)
        return jnp.sum(y * r) + 0.01 * aux, (y, aux)

    (_, (y, aux)), g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(x, lg, wi, wo)
    return dict(y=np.asarray(y), aux=float(aux),
                grads=[np.asarray(a) for a in g])


def _jax_generate(factor, rows):
    """test_ep.py:192's model and prompt (`rows` rows): the port's copy
    of the weights, the prompt, and a thunk giving JAX's tokens,
    generated under the ep mesh through make_switch_moe, and the hidden
    states of the prompt's forward through it (what the prefill
    computes)."""
    mesh = jm.make_mesh(JAX_MESH)
    fn = jep.make_switch_moe(mesh, 4, capacity_factor=factor,
                             activation="swiglu", top_k=1)
    prompt = jax.random.randint(jax.random.PRNGKey(0), (rows, 5), 0, 256)
    base = dict(dtype=jnp.float32, **GEN_KW)
    model = jl.Llama(jl.tiny(**base))
    params = jax.jit(lambda r, p: model.init(r, p, train=False))(
        jax.random.PRNGKey(1), prompt)["params"]

    def tokens():
        ep_model = jl.Llama(jl.tiny(**base, moe_dispatch_fn=fn))
        with mesh:
            return (np.asarray(jl.generate(ep_model, params, prompt,
                                           max_new_tokens=6)),
                    np.asarray(jax.jit(lambda p, t: ep_model.apply(
                        {"params": p}, t, train=False, return_hidden=True))(
                            params, prompt)))

    full = bridge.params_from_jax(tl.tiny(dtype=torch.float32, **GEN_KW),
                                  jax.tree.map(np.asarray, params))
    return full, np.asarray(prompt).astype(np.int64), tokens


def _jax_transformer(factor):
    """test_ep.py:101's all-to-all MoE Transformer: the port's copy of
    the weights, the tokens, and a thunk giving JAX's logits."""
    mesh = jm.make_mesh(JAX_MESH)
    base = dict(dtype=jnp.float32, **TFM)
    cfg = jt.tiny(**base, moe_dispatch_fn=jep.make_switch_moe(
        mesh, n_experts=4, capacity_factor=factor))
    tokens = jax.random.randint(jax.random.PRNGKey(6), (4, 16), 0, 256)
    params = jax.jit(lambda r, t: jt.Transformer(jt.tiny(**base)).init(
        r, t, train=False))(jax.random.PRNGKey(7), tokens)["params"]
    full = transformer_params_from_jax(
        tt.tiny(dtype=torch.float32, **TFM), jax.tree.map(np.asarray,
                                                          params))
    return full, np.asarray(tokens).astype(np.int64), lambda: np.asarray(
        jax.jit(lambda p, t: jt.Transformer(cfg).apply(
            {"params": p}, t, train=False))(params, tokens))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The eight-rank job's readings; while it runs, JAX's (the
    dispatch cases, the generated tokens, the Transformer's logits) and
    the one-process oracle's training runs."""
    tmp = tmp_path_factory.mktemp("ep")
    jobs = {tag: ("ep_fn", axes, dict(b=b, s=s, n_e=n_e, factor=f,
                                      top_k=k, act=act, replicated=rep,
                                      seed=i))
            for i, (tag, (axes, b, s, n_e, f, k, act, rep)) in enumerate(
                u.EP_CASES.items())}
    jobs.update({tag: ("llama", axes, kw)
                 for tag, (axes, kw) in TRAIN.items()})
    jobs["aux"] = ("ep_aux", JAX_MESH, dict(seed=3))
    jobs["refusal"] = ("ep_refusal", JAX_MESH, {})
    gen = {tag: _jax_generate(*spec) for tag, spec in GEN.items()}
    for tag, (factor, _) in GEN.items():
        full, prompt, _ = gen[tag]
        for suffix, (axes, placed) in GEN_JOBS.items():
            path = tmp / f"gen_{tag}{suffix}.pt"
            torch.save(dict(full=full, prompt=prompt, cfg_kw=GEN_KW,
                            factor=factor, placed=placed), path)
            jobs[f"generate_{tag}{suffix}"] = ("generate", axes, str(path))
    tfm = {tag: _jax_transformer(f) for tag, f in TFM_FACTORS.items()}
    for tag, f in TFM_FACTORS.items():
        full, toks, _ = tfm[tag]
        torch.save(dict(full=full, toks=toks, cfg_kw=TFM, factor=f),
                   tmp / f"tfm_{tag}.pt")
        jobs[f"transformer_{tag}"] = ("transformer_ep", JAX_MESH,
                                      str(tmp / f"tfm_{tag}.pt"))
    jobs["cli"] = ("cli_parallel", None, dict(argv=CLI))
    job = u.start(jobs, tmp)
    (tmp / "pp").mkdir()
    pp_job = u.start({"pp_llama": ("llama", PP_MESH, {})}, tmp / "pp", n=4)
    want = {tag: _jax_moe(axes["ep"], b, s, n_e, f, k, act, i)
            for i, (tag, (axes, b, s, n_e, f, k, act, _)) in enumerate(
                u.EP_CASES.items())}
    want["generate"] = {tag: tokens() for tag, (_, _, tokens) in gen.items()}
    want["transformer"] = {tag: logits() for tag, (_, _, logits)
                           in tfm.items()}
    jfn = jax.jit(jep.make_switch_moe(jm.make_mesh(JAX_MESH), 8, 8.0))
    x, lg, wi, wo, _ = u.ep_inputs(3, 4, 16, 8, "gelu")
    want["aux"] = float(jfn(x.reshape(1, 64, -1)[:, :63],
                            lg.reshape(1, 64, -1)[:, :63], wi, wo)[1])
    one = {tag: u.one_process("llama", **kw)
           for tag, (_, kw) in TRAIN.items()}
    return {"got": u.join(job), "jax": want, "one": one,
            "pp": u.join(pp_job)}


# ------------------------------------------------------ one process
ORACLE = {  # (b, s, experts, factor, top_k, activation, ep)
    "ample": (4, 16, 8, 8.0, 1, "gelu", 4),
    "drops": (4, 16, 8, 1.0, 1, "gelu", 4),
    "ragged_top2_swiglu_drops": (3, 7, 8, 1.25, 2, "swiglu", 4),
    "ragged_ep2": (3, 7, 8, 8.0, 2, "swiglu", 2),
}


@pytest.mark.parametrize("tag", sorted(ORACLE))
def test_ep_oracle_matches_jax(tag):
    """The one-process reference of the training cases (and of
    chip_smoke's mixtral_ep parity) is JAX's make_switch_moe: output,
    aux and the four gradients within 1e-5, and drops where the
    capacity binds."""
    b, s, n_e, f, k, act, n_ep = ORACLE[tag]
    want = _jax_moe(n_ep, b, s, n_e, f, k, act, 10)
    x, lg, wi, wo, r = (torch.from_numpy(a).requires_grad_()
                        for a in u.ep_inputs(10, b, s, n_e, act))
    fn = u.ep_oracle(n_ep, n_e, f, top_k=k, activation=act)
    y, aux = fn(x, lg, wi, wo)
    ((y * r.detach()).sum() + 0.01 * aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), want["y"], rtol=1e-5,
                               atol=1e-5)
    assert abs(aux.item() - want["aux"]) <= 1e-5 * abs(want["aux"])
    for got, w in zip((x.grad, lg.grad, wi.grad, wo.grad), want["grads"]):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5)
    assert fn.stats["pairs"] == b * s * k
    assert (fn.stats["dropped"] > 0) == ("drops" in tag)


def test_ragged_aux_excludes_padding(run):
    """test_ep.py:167: the same tokens minus one (63 padded to 64) move
    the aux loss only by that token's share, as JAX's does (the job's
    ep 4 x dp 2, every rank the global batch)."""
    got = run["got"]["aux"]
    assert abs(got["ragged"] - got["even"]) < 0.1
    assert abs(got["ragged"] - run["jax"]["aux"]) <= \
        1e-5 * run["jax"]["aux"]


def test_split_batch_over_other_ranks_is_refused(run):
    msg = run["got"]["refusal"]
    assert msg is not None and msg.startswith(
        "make_switch_moe: the batch is split over ranks [0, 1, 2, 3, 4, 5, "
        "6, 7], where the mesh's data axes ('dcn', 'dp', 'fsdp') hold ")


def test_refusals_carry_jax_messages():
    jmesh = jm.make_mesh({"ep": 4, "dp": 2})
    mesh = pm.make_mesh({"ep": 4, "dp": 2}, world=8)
    for kw in (dict(n_experts=6), dict(n_experts=4, top_k=5)):
        with pytest.raises(ValueError) as jerr:
            jep.make_switch_moe(jmesh, **kw)
        with pytest.raises(ValueError) as perr:
            pep.make_switch_moe(mesh, **kw)
        assert str(perr.value) == str(jerr.value)
    # an ep axis over a mesh without process groups has no ranks to
    # dispatch to; an axis of one needs none
    with pytest.raises(ValueError, match="needs the mesh of a job"):
        pep.make_switch_moe(mesh, 4)
    one = pm.make_mesh(world=1)
    fn1 = jep.make_switch_moe(jmesh, 4, top_k=1)
    with pytest.raises(ValueError) as jerr:
        jl.tiny(n_experts=4, moe_every=1, moe_top_k=2, moe_dispatch_fn=fn1)
    with pytest.raises(ValueError) as perr:
        tl.tiny(n_experts=4, moe_every=1, moe_top_k=2,
                moe_dispatch_fn=pep.make_switch_moe(one, 4, top_k=1))
    assert str(perr.value) == str(jerr.value)
    tl.tiny(n_experts=4, moe_every=1, moe_top_k=2,
            moe_dispatch_fn=pep.make_switch_moe(one, 4, top_k=2))


@pytest.mark.parametrize("argv,msg", [
    (["--ep", "2"], "--ep only applies to --model=mixtral (a dense llama3 "
                    "has nothing to shard over an expert axis)"),
    (["--ep", "2", "--model", "mistral"],
     "--ep only applies to --model=mixtral (a dense mistral has nothing to "
     "shard over an expert axis)"),
    (["--ep", "2", "--model", "mixtral"], "--ep 2 must divide dp 1")])
def test_train_llama_ep_exits_with_jax_messages(argv, msg):
    """examples/llama/train_llama.py:103-111's two SystemExits, word for
    word (one process: dp 1)."""
    with pytest.raises(SystemExit) as err:
        train_llama.main(["--smoke", "--device", "cpu"] + argv)
    assert str(err.value) == msg


def test_placement_refuses_only_pp(run):
    """A pp axis places as JAX's GSPMD path does (no rule maps a model
    dim to pp: every leaf replicates over it, the batch splits over the
    data axes alone): a {"pp": 2, "dp": 2} placed llama's train_llama
    step equals one process's."""
    with torch.device("meta"):
        model = tl.Llama(tl.tiny(), train=True)
    mesh = pm.make_mesh(PP_MESH, world=4)
    specs = ptp.transformer_param_sharding(
        {k: tuple(v.shape) for k, v in model.state_dict().items()}, mesh,
        min_fsdp_size=0)
    assert not any("pp" in pm.spec_mesh_axes(s) for s in specs.values())
    u.check(run["pp"]["pp_llama"], u.one_process("llama"), adam=False,
            tag="pp_llama")


EP_MESHES = [{"tp": 2, "ep": 2, "dp": 2}, {"ep": 4, "fsdp": 2}]
EP_MODELS = {
    "mixtral": lambda: (jl.Llama(jl.tiny(tie_embeddings=True,
                                         **train_llama.SMOKE_MOE)),
                        jl.tiny(), lambda: tl.Llama(tl.tiny(
                            tie_embeddings=True, **train_llama.SMOKE_MOE),
                            train=True)),
    "transformer": lambda: (jt.Transformer(jt.tiny(causal=True, **TFM)),
                            jt.tiny(), lambda: tt.Transformer(tt.tiny(
                                causal=True, **TFM))),
}


@pytest.mark.parametrize("axes", EP_MESHES, ids=["tp2ep2dp2", "ep4fsdp2"])
@pytest.mark.parametrize("kind", sorted(EP_MODELS))
def test_ep_mesh_blocks_match_jax_state_sharding(kind, axes):
    """Every leaf's spec under JAX's state_sharding on an ep mesh (the
    expert banks' dim 0 over ep), and every rank's block bit for bit
    against the shard jax.device_put puts on its device."""
    model_j, cfg_j, make = EP_MODELS[kind]()
    shapes = _jax_shapes(model_j, cfg_j)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), shapes)
    jmesh = jm.make_mesh(axes, devices=jax.devices()[:8])
    mesh = pm.make_mesh(axes, world=8)
    sh_j = jtp.transformer_param_sharding(tree, jmesh, min_fsdp_size=0)
    placed = jax.device_put(tree, sh_j)
    with torch.device("meta"):
        names = list(make().state_dict())
    specs = ptp.transformer_param_sharding(
        {k: _at(tree, ptp.jax_path(k)).shape for k in names}, mesh,
        min_fsdp_size=0)
    banks = 0
    for name in names:
        path = ptp.jax_path(name)
        whole = _at(tree, path)
        assert _pad(specs[name], whole.ndim) == _spec(_at(sh_j, path),
                                                      whole.ndim), name
        banks += specs[name][0] == "ep"
        for shard in _at(placed, path).addressable_shards:
            got = pm.shard_of(whole, specs[name], mesh, rank=shard.device.id)
            assert np.array_equal(got, np.asarray(shard.data)), \
                (name, shard.device.id)
    assert banks == 2 * 2  # wi and wo of both blocks


@pytest.mark.parametrize("opt", ["adafactor", "adam"])
@pytest.mark.parametrize("axes", EP_MESHES, ids=["tp2ep2dp2", "ep4fsdp2"])
@pytest.mark.parametrize("kind", sorted(EP_MODELS))
def test_ep_mesh_state_sharding_matches_jax(kind, axes, opt):
    """The whole train state's specs on an ep mesh: the parameters and
    the optimizer state of the expert banks (adafactor's v_row / v_col /
    v, adam's mu / nu) over ep as JAX's state_sharding puts them; the
    checkpoint's layout and each rank's optimizer blocks follow them."""
    check_state_sharding(*EP_MODELS[kind](), axes, 0, opt)


@pytest.mark.parametrize("axes", EP_MESHES, ids=["tp2ep2dp2", "ep4fsdp2"])
def test_ep_mesh_int8_blocks_match_jax(axes):
    """The mixtral smoke model quantized (models/quant.quantize_params):
    every leaf's spec, payload and scale alike, against JAX's
    transformer_param_sharding of the quantized tree, and every rank's
    int8 block and scale block bit for bit against the shards
    jax.device_put puts on its device (the decode step gathers these
    over ep, MoeSwiGlu._experts)."""
    model_j, cfg_j, make = EP_MODELS["mixtral"]()
    shapes = _jax_shapes(model_j, cfg_j)
    rng = np.random.default_rng(1)
    tree = jq.quantize_params(jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes))
    jmesh = jm.make_mesh(axes, devices=jax.devices()[:8])
    mesh = pm.make_mesh(axes, world=8)
    sh_j = jtp.transformer_param_sharding(tree, jmesh, min_fsdp_size=0)
    placed = jax.device_put(tree, sh_j)
    with torch.device("meta"):
        names = list(make().state_dict())
    whole = {}
    for name in names:
        leaf = _at(tree, ptp.jax_path(name))
        whole[name] = (tq.QTensor(q=torch.from_numpy(np.array(leaf.q)),
                                  scale=torch.from_numpy(np.array(
                                      leaf.scale)))
                       if isinstance(leaf, jq.QTensor)
                       else torch.from_numpy(np.array(leaf)))
    specs = ptp.transformer_param_sharding(whole, mesh, min_fsdp_size=0)
    banks = 0
    for name, x in whole.items():
        path = ptp.jax_path(name)
        parts = (("q", "scale") if isinstance(x, tq.QTensor) else (None,))
        for part in parts:
            spec = specs[name] if part is None else getattr(specs[name], part)
            arr = x if part is None else getattr(x, part)
            want = _at(sh_j, path) if part is None else getattr(
                _at(sh_j, path), part)
            assert _pad(spec, arr.dim()) == _spec(want, arr.dim()), \
                (name, part)
            banks += spec[0] == "ep"
            jarr = _at(placed, path) if part is None else getattr(
                _at(placed, path), part)
            for shard in jarr.addressable_shards:
                got = pm.shard_of(arr.numpy(), spec, mesh,
                                  rank=shard.device.id)
                assert np.array_equal(got, np.asarray(shard.data)), \
                    (name, part, shard.device.id)
    assert banks == 2 * 2 * 2  # wi and wo of both blocks, q and scale


# ------------------------------------------------------------ the job
@pytest.mark.parametrize("tag", sorted(u.EP_CASES))
def test_distributed_dispatch_matches_jax(run, tag):
    axes, b, s, n_e, factor, top_k, _, replicated = u.EP_CASES[tag]
    ranks, want = run["got"][tag], run["jax"][tag]
    n_ep = axes["ep"]
    per_e = n_e // n_ep
    n_data = ranks[0]["n_data"]
    assert n_data == (1 if replicated else 8 // n_ep // axes.get("tp", 1))
    rows = b // n_data
    dwi = [0.0] * n_ep
    dwo = [0.0] * n_ep
    blocks = {}
    for rec in ranks:
        m, e = rec["member"], rec["ep"]
        sl = slice(m * rows, (m + 1) * rows)
        np.testing.assert_allclose(rec["y"].numpy(), want["y"][sl],
                                   rtol=1e-5, atol=1e-5, err_msg=tag)
        assert abs(rec["aux"] - want["aux"]) <= 1e-5 * abs(want["aux"])
        for got, w in ((rec["dx"], want["grads"][0]),
                       (rec["dlogits"], want["grads"][1])):
            np.testing.assert_allclose(got.numpy(), w[sl], rtol=1e-5,
                                       atol=1e-5, err_msg=tag)
        if replicated:
            # every rank the whole gradient of its ep block
            blk = slice(e * per_e, (e + 1) * per_e)
            np.testing.assert_allclose(rec["dwi"].numpy(),
                                       want["grads"][2][blk], rtol=1e-5,
                                       atol=1e-5, err_msg=tag)
            np.testing.assert_allclose(rec["dwo"].numpy(),
                                       want["grads"][3][blk], rtol=1e-5,
                                       atol=1e-5, err_msg=tag)
        blocks[(m, e)] = (rec["dwi"], rec["dwo"])
    # each data member's gradient of its ep block (its tp ranks hold
    # copies), averaged over the members
    assert len(blocks) == n_data * n_ep
    for (m, e), (gi, go) in blocks.items():
        dwi[e] = dwi[e] + gi / n_data
        dwo[e] = dwo[e] + go / n_data
    for e in range(n_ep):
        blk = slice(e * per_e, (e + 1) * per_e)
        np.testing.assert_allclose(dwi[e].numpy(), want["grads"][2][blk],
                                   rtol=1e-5, atol=1e-5, err_msg=tag)
        np.testing.assert_allclose(dwo[e].numpy(), want["grads"][3][blk],
                                   rtol=1e-5, atol=1e-5, err_msg=tag)
    # each ep block routed its share of the real tokens once (the ranks
    # of one ep coordinate route the same block); the drops where the
    # capacity binds
    one_each = {r["ep"]: r["stats"] for r in ranks}
    assert sum(st["pairs"] for st in one_each.values()) == b * s * top_k
    dropped = sum(st["dropped"] for st in one_each.values())
    assert (dropped > 0) == ("drops" in tag), (tag, dropped)


@pytest.mark.parametrize("tag", sorted(TRAIN))
def test_ep_training_step_equals_the_oracle(run, tag):
    got, want = run["got"][tag], run["one"][tag]
    assert len(got["losses"]) == u.STEPS
    assert all(g > 0 for g in got["gnorms"])
    u.check(got, want, adam=False, tag=tag)
    # the capacity binds: tokens were dropped, as many as the oracle's
    assert got["ep_stats"]["dropped"] > 0


def _gen(run, tag, suffix):
    got = run["got"][f"generate_{tag}{suffix}"]
    tokens, hidden = run["jax"]["generate"][tag]
    assert np.array_equal(got["tokens"].numpy(), tokens)
    np.testing.assert_allclose(got["prefill_hidden"].numpy(), hidden,
                               rtol=1e-5, atol=1e-5)
    # the prefill went through the dispatch; at factor 1.25 it dropped
    assert got["stats"]["calls"] > 0
    assert (got["stats"]["dropped"] > 0) == ("drops" in tag), got["stats"]


@pytest.mark.parametrize("tag", sorted(GEN))
def test_generate_under_ep_gives_jax_tokens(run, tag):
    """Whole weights on ep 4 x dp 2, every rank the global batch."""
    _gen(run, tag, "")


@pytest.mark.parametrize("tag", sorted(GEN))
def test_generate_of_an_ep_placed_model_gives_jax_tokens(run, tag):
    """The model placed on ep 4 x tp 2 (one expert a rank, its F
    columns over tp): the prefill dispatches to the experts' ranks, each
    decode step gathers the bank over ep, the cache holds the rank's kv
    heads."""
    _gen(run, tag, "_placed")


@pytest.mark.parametrize("tag", sorted(GEN))
def test_generate_over_a_data_split_cache_gives_jax_tokens(run, tag):
    """The model placed on ep 4 x dp 2: a 4-row batch's cache splits
    over dp and each data member prefills its rows (the dispatch
    gathers the global token list); 3 rows do not divide dp, the cache
    replicates and every rank prefills the whole batch."""
    _gen(run, tag, "_placed_dp")


@pytest.mark.parametrize("tag", sorted(TFM_FACTORS))
def test_transformer_dispatch_matches_jax(run, tag):
    got = run["got"][f"transformer_{tag}"]
    np.testing.assert_allclose(got["logits"].numpy(),
                               run["jax"]["transformer"][tag], rtol=1e-5,
                               atol=1e-5)
    assert (got["stats"]["dropped"] > 0) == (tag == "drops"), got["stats"]


def test_train_llama_mixtral_tp_ep_cli(run):
    rc, out = run["got"]["cli"]
    assert rc == 0, out
    assert ("mesh {'dcn': 1, 'pp': 1, 'dp': 2, 'fsdp': 1, 'ep': 2, "
            "'tp': 2}") in out
    assert "complete: steps=2 resumed_from=None" in out
