"""The port's mesh and its sharding specs (parallel/mesh, parallel/tp,
runtime/train.fsdp_param_sharding) held exactly against the JAX
package's on the 8 forced host devices (tests/conftest.py), with no
process group: the rank grid against make_mesh's device order (inference
and errors included), bootstrap's default_mesh and multislice_mesh,
MeshRules, pick_fsdp_dim and fsdp_param_sharding,
every leaf's spec of transformer_param_sharding and state_sharding
(Llama tiny with d_ff 256, the mixtral smoke model, the Transformer
tiny, a quantized Llama tree; adafactor's and adam's states; min_fsdp
0 and the default) over tp 2 x fsdp 2 x dp 2 and tp 4 x fsdp 2, and
for every leaf and every rank the block the port slices out of a whole
tree against the shard jax.device_put puts on that device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models import quant as jq
from tf_operator_tpu.models import transformer as jt
from tf_operator_tpu.parallel import mesh as jm
from tf_operator_tpu.parallel import tp as jtp
from tf_operator_tpu.runtime import bootstrap as jboot
from tf_operator_tpu.runtime import train as jtr
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import quant as tq
from tf_operator_tpu_torch.models import transformer as tt
from tf_operator_tpu_torch.parallel import mesh as pm
from tf_operator_tpu_torch.parallel import tp as ptp
from tf_operator_tpu_torch.runtime import bootstrap as pboot
from tf_operator_tpu_torch.runtime import optim
from tf_operator_tpu_torch.runtime import train as ptr

MESHES = [{"tp": 2, "fsdp": 2, "dp": 2}, {"tp": 4, "fsdp": 2}]
MIN_SIZES = [0, 2**14]
SMOKE_MOE = dict(n_experts=4, moe_every=1, moe_top_k=2)


def _spec(sharding, ndim: int):
    """A JAX NamedSharding's spec as the port writes it: one entry a dim."""
    spec = tuple(sharding.spec)
    return spec + (None,) * (ndim - len(spec))


def _pad(spec, ndim: int):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("axes", [
    {"tp": 2, "fsdp": 2, "dp": 2}, {"tp": 4, "fsdp": 2}, {"dp": -1},
    {"tp": 2, "dp": -1}, {"dcn": 2, "fsdp": 2, "tp": 2},
    {"pp": 2, "ep": 2, "tp": 2}, {"fsdp": 8}, {"dp": 2, "fsdp": 2, "ep": 2}])
def test_rank_grid_is_make_mesh_device_order(axes):
    devices = jax.devices()[:8]
    jmesh = jm.make_mesh(axes, devices=devices)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    assert np.array_equal(pm.rank_grid(axes, 8), ids)
    mesh = pm.make_mesh(axes, world=8)
    assert mesh.shape == dict(jmesh.shape)
    assert np.array_equal(mesh.grid, ids)
    for r in range(8):
        idx = np.argwhere(ids == r)[0]
        assert mesh.coords(r) == dict(zip(pm.AXIS_ORDER, idx.tolist()))


@pytest.mark.parametrize("axes,match", [
    ({"tp": 3}, "require"), ({"tp": -1, "dp": -1}, "at most one"),
    ({"tp": 3, "dp": -1}, "not divisible")])
def test_mesh_errors_are_make_mesh_errors(axes, match):
    with pytest.raises(ValueError, match=match) as jerr:
        jm.make_mesh(axes, devices=jax.devices()[:8])
    with pytest.raises(ValueError, match=match) as perr:
        pm.mesh_shape(axes, 8)
    assert str(perr.value) == str(jerr.value)


def test_default_and_multislice_mesh_match_jax():
    """default_mesh puts every rank on dp; multislice_mesh puts one dcn
    row a slice (ranks slice-major) and refuses a dcn that conflicts
    with numSlices (tests/test_runtime.py's case)."""
    devices = jax.devices()[:8]
    want = jm.make_mesh({"dp": -1}, devices=devices)
    got = pboot.default_mesh(world=8)
    assert got.shape == dict(want.shape)
    env = {"COORDINATOR_ADDRESS": "j-worker-0.ns.svc:8476",
           "NUM_PROCESSES": "2", "PROCESS_ID": "0",
           "MEGASCALE_COORDINATOR_ADDRESS": "j-worker-0.ns.svc:8476",
           "MEGASCALE_NUM_SLICES": "2", "TPU_NUM_SLICES": "2",
           "TPU_SLICE_ID": "0", "TPU_HOSTS_PER_SLICE": "2",
           "TPU_TOTAL_HOSTS": "4"}
    for axes in ({"fsdp": 2, "dp": -1}, {"tp": 2, "dp": -1}, None):
        jmesh = jboot.multislice_mesh(jboot.slice_info_from_env(env), axes,
                                      devices=devices)
        mesh = pboot.multislice_mesh(pboot.slice_info_from_env(env), axes,
                                     world=8)
        assert mesh.shape == dict(jmesh.shape)
        ids = np.vectorize(lambda d: d.id)(jmesh.devices)
        assert np.array_equal(mesh.grid, ids)
    for mod, kw in ((jboot, dict(devices=devices)), (pboot, dict(world=8))):
        with pytest.raises(ValueError, match="numSlices"):
            mod.multislice_mesh(mod.slice_info_from_env(env),
                                {"dcn": 4, "dp": -1}, **kw)


def test_rules_pick_fsdp_dim_and_local_axes():
    for logical in [("batch", None), ("embed", "mlp"), ("heads", "kv"),
                    ("vocab", "seq_sp", "expert", "stage", "params_fsdp"),
                    (None, "nonexistent")]:
        jspec = jm.DEFAULT_RULES.spec(logical)
        assert pm.DEFAULT_RULES.spec(logical) == _pad(jspec, len(logical))
    rules = jm.DEFAULT_RULES.with_rule("embed", "fsdp")
    assert pm.DEFAULT_RULES.with_rule("embed", "fsdp").rules == rules.rules
    for shape in [(1024, 64), (10,), (17, 3, 5), (64, 2, 128), (6, 4),
                  (4096, 8), (), (2, 256, 256)]:
        for fsdp in (1, 2, 4, 8):
            for min_size in (0, 256, 2**14):
                for taken in ((), (0,), (1,)):
                    assert pm.pick_fsdp_dim(shape, fsdp, min_size, taken) == \
                        jm.pick_fsdp_dim(shape, fsdp, min_size, taken)
    for n in (1, 2, 6, 8):
        for tp in (1, 2, 3, 4):
            assert pm.local_mesh_axes(n, tp) == jm.local_mesh_axes(n, tp)
    jmesh = jm.make_mesh(MESHES[0], devices=jax.devices()[:8])
    mesh = pm.make_mesh(MESHES[0], world=8)
    assert pm.batch_sharding(mesh) == tuple(jm.batch_sharding(jmesh).spec)
    assert pm.replicated(mesh) == tuple(jm.replicated(jmesh).spec)
    assert pm.named_sharding(mesh, ("batch", "embed")) == \
        tuple(jm.named_sharding(jmesh, ("batch", "embed")).spec)


def test_fsdp_param_sharding_matches_jax():
    shapes = {"big": (1024, 64), "small": (10,), "odd": (17, 3, 5),
              "cube": (8, 16, 32)}
    for fsdp in (8, 4, 2):
        jmesh = jm.make_mesh({"fsdp": fsdp, "dp": -1},
                             devices=jax.devices()[:8])
        mesh = pm.make_mesh({"fsdp": fsdp, "dp": -1}, world=8)
        params = {k: jnp.zeros(s) for k, s in shapes.items()}
        for min_size in (0, 256):
            jsh = jtr.fsdp_param_sharding(params, jmesh, min_size=min_size)
            got = ptr.fsdp_param_sharding(shapes, mesh, min_size=min_size)
            for k, s in shapes.items():
                assert _pad(got[k], len(s)) == _spec(jsh[k], len(s)), k


# ------------------------------------------------------------ spec trees
def _llama_pair(**kw):
    jcfg = jl.tiny(**kw)
    tcfg = tl.tiny(**kw)
    return jl.Llama(jcfg), jcfg, lambda: tl.Llama(tcfg, train=True)


def _tfm_pair(**kw):
    jcfg = jt.tiny(causal=True, **kw)
    tcfg = tt.tiny(causal=True, **kw)
    return jt.Transformer(jcfg), jcfg, lambda: tt.Transformer(tcfg)


MODELS = {
    "llama": lambda: _llama_pair(d_ff=256),
    "mixtral": lambda: _llama_pair(tie_embeddings=True, **SMOKE_MOE),
    "transformer": _tfm_pair,
}


def _jax_shapes(model, cfg):
    toks = jnp.zeros((2, cfg.max_len), jnp.int32)
    return jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), toks, train=False))[
            "params"]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _opt_node(opt_state, field):
    """The optax state node that carries `field` (FactoredState.v_row,
    ScaleByAdamState.mu)."""
    return next(s for s in opt_state if hasattr(s, field))


@pytest.mark.parametrize("opt", ["adafactor", "adam"])
@pytest.mark.parametrize("min_size", MIN_SIZES)
@pytest.mark.parametrize("axes", MESHES, ids=["tp2fsdp2dp2", "tp4fsdp2"])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_state_sharding_matches_jax_leaf_by_leaf(kind, axes, min_size, opt):
    check_state_sharding(*MODELS[kind](), axes, min_size, opt)


def check_state_sharding(model_j, cfg_j, make, axes, min_size, opt):
    """Every leaf's spec of the port's state_sharding (the parameters
    and the optimizer state, adafactor or adam) against JAX's on the
    mesh of `axes`."""
    shapes = _jax_shapes(model_j, cfg_j)
    tx_j = optax.adafactor(1e-3) if opt == "adafactor" else optax.adam(1e-3)
    state_j = jtr.TrainState(
        step=jnp.zeros((), jnp.int32), params=shapes,
        opt_state=jax.eval_shape(tx_j.init, shapes), batch_stats={},
        tx=tx_j)
    jmesh = jm.make_mesh(axes, devices=jax.devices()[:8])
    param_fn = lambda p, m: jtp.transformer_param_sharding(  # noqa: E731
        p, m, min_fsdp_size=min_size)
    sh_j = jtp.state_sharding(state_j, jmesh, param_fn=param_fn)

    with torch.device("meta"):
        model = make()
    tx = optim.Adafactor(1e-3) if opt == "adafactor" else optim.Adam(1e-3)
    state = ptr.TrainState.create(model, tx)
    mesh = pm.make_mesh(axes, world=8)
    sh = ptp.state_sharding(state, mesh, param_fn=lambda p, m:
                            ptp.transformer_param_sharding(
                                p, m, min_fsdp_size=min_size))
    assert sh.step == () and sh.batch_stats == {}
    assert len(sh.params) == len(jax.tree.leaves(shapes))
    for name, p in state.params.items():
        path = ptp.jax_path(name)
        assert tuple(_at(shapes, path).shape) == tuple(p.shape), name
        assert _pad(sh.params[name], p.dim()) == \
            _spec(_at(sh_j.params, path), p.dim()), name
    fields = ("v_row", "v_col", "v") if opt == "adafactor" else ("mu", "nu")
    node = _opt_node(sh_j.opt_state, fields[0])
    n = 0
    for f in fields:
        for name, t in state.opt_state[f].items():
            path = ptp.jax_path(name)
            jleaf = _at(getattr(_opt_node(state_j.opt_state, fields[0]), f),
                        path)
            assert tuple(jleaf.shape) == tuple(t.shape), (f, name)
            assert _pad(sh.opt_state[f][name], t.dim()) == \
                _spec(_at(getattr(node, f), path), t.dim()), (f, name)
            n += 1
    assert n >= len(state.params)
    assert sh.opt_state["count"] == () == tuple(node.count.spec)


@pytest.mark.parametrize("axes", MESHES, ids=["tp2fsdp2dp2", "tp4fsdp2"])
def test_quantized_tree_placement_matches_jax(axes):
    model_j, cfg_j, _ = MODELS["llama"]()
    shapes = _jax_shapes(model_j, cfg_j)
    qshapes = jax.eval_shape(jq.quantize_params, shapes)
    jmesh = jm.make_mesh(axes, devices=jax.devices()[:8])
    sh_j = jtp.transformer_param_sharding(qshapes, jmesh, min_fsdp_size=0)
    mesh = pm.make_mesh(axes, world=8)
    with torch.device("meta"):
        names = list(tl.Llama(tl.tiny(d_ff=256)).state_dict())
    tree = {}
    for name in names:
        leaf = _at(qshapes, ptp.jax_path(name))
        if isinstance(leaf, jq.QTensor):
            tree[name] = tq.QTensor(
                q=torch.empty(leaf.q.shape, dtype=torch.int8, device="meta"),
                scale=torch.empty(leaf.scale.shape, device="meta"))
        else:
            tree[name] = torch.empty(leaf.shape, device="meta")
    sh = ptp.transformer_param_sharding(tree, mesh, min_fsdp_size=0)
    n_q = 0
    for name, x in tree.items():
        want = _at(sh_j, ptp.jax_path(name))
        if isinstance(x, tq.QTensor):
            n_q += 1
            assert _pad(sh[name].q, x.q.dim()) == _spec(want.q, x.q.dim())
            assert _pad(sh[name].scale, x.q.dim()) == \
                _spec(want.scale, x.q.dim()), name
        else:
            assert _pad(sh[name], x.dim()) == _spec(want, x.dim()), name
    assert n_q == 2 + 5 * 2  # embed, lm_head, five kernels a block


@pytest.mark.parametrize("axes", MESHES, ids=["tp2fsdp2dp2", "tp4fsdp2"])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_each_rank_holds_the_shard_device_put_gives(kind, axes):
    """Every leaf of a whole tree, every rank: the port's block (the one
    parallel/placement.place keeps) is the array jax.device_put puts on
    device r."""
    model_j, cfg_j, make = MODELS[kind]()
    shapes = _jax_shapes(model_j, cfg_j)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), shapes)
    jmesh = jm.make_mesh(axes, devices=jax.devices()[:8])
    mesh = pm.make_mesh(axes, world=8)
    for min_size in MIN_SIZES:
        sh_j = jtp.transformer_param_sharding(tree, jmesh,
                                              min_fsdp_size=min_size)
        placed = jax.device_put(tree, sh_j)
        with torch.device("meta"):
            names = list(make().state_dict())
        specs = ptp.transformer_param_sharding(
            {k: _at(tree, ptp.jax_path(k)).shape for k in names}, mesh,
            min_fsdp_size=min_size)
        for name in names:
            path = ptp.jax_path(name)
            whole = _at(tree, path)
            for shard in _at(placed, path).addressable_shards:
                got = pm.shard_of(whole, specs[name], mesh,
                                  rank=shard.device.id)
                assert np.array_equal(got, np.asarray(shard.data)), \
                    (name, shard.device.id)


def test_pinned_state_shardings_require_a_mesh():
    """tests/test_runtime.py:311: make_train_step(state_shardings=)
    without a mesh is refused, as the JAX step refuses it."""
    model = tl.Llama(tl.tiny(dtype=torch.float32))
    with pytest.raises(ValueError, match="mesh"):
        ptr.make_train_step(model, state_shardings=object())
