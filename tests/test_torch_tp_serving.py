"""Tensor-parallel serving (parallel/tp.kv_cache_sharding, the int8
tree's placement, and generate / speculative_generate / serve_loop with
cache_sharding) against the JAX package and against the port's one
process.

The pure part runs no process: kv_cache_sharding's spec and serve_loop's
row and pool projections against JAX's over the 8 forced host devices
(tests/conftest.py), the refusal of anything but a KvCacheSharding, every
rank's int8 payload and scale block against jax.device_put's shard of
the quantized tree, and the one-process tied generate against JAX's.

The spawned part runs one job of eight JAX-free gloo ranks
(tests/torch_tp_serving_util.py) through every case in turn, each rank
holding its blocks of the weights and of the KV cache: the port's
counterparts of tests/test_tp_serving.py:44-189 (greedy, tied, sampled,
int8 weights, a window ring, chunked prefill, speculation, dense serving
with speculation on dp 2 x fsdp 2 x tp 2, slots split over the data
axes), tests/test_zpagedkernel.py:207-222 (paged at {tp: 2} and {dp: 2,
tp: 2}, one decode block over a placed pool) and test_kv_quant.py:144,
and the port's own: both schedulers, a dense shared prefix, int8
weights with int8 KV, paged speculation, a windowed paged loop through
the wrap with a shared prefix, the Mixtral smoke model, tiny at tp 4
(kv heads replicated in JAX's spec: each rank's cache holds the kv head
its query head reads), and the handoff in both directions.  Every rank's
tokens, schedules, counts and exports equal every other rank's and one
process's exactly (f32 greedy, and sampling from one seed); each rank's
cache is its block of one process's cache (the sums run in another
order: 1e-5, and int8 KV within one quantization step), so no case
passes by silent replication.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_tp_serving_util as u
from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models import quant as jq
from tf_operator_tpu.parallel import mesh as jm
from tf_operator_tpu.parallel import tp as jtp
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import serving
from tf_operator_tpu_torch.models.quant import QTensor
from tf_operator_tpu_torch.parallel import mesh as pm
from tf_operator_tpu_torch.parallel import tp as ptp
from tf_operator_tpu_torch.parallel.placement import place

SPEC_CASES = [({"tp": 2, "dp": 4}, 4), ({"tp": 8}, 4), ({"dp": 8}, 3),
              ({"dp": 8}, 8), ({"dp": 2, "fsdp": 2, "tp": 2}, 4)]


def _norm(spec):
    """A spec with each entry as a tuple of axis names (JAX writes one
    axis as a name or a 1-tuple)."""
    return tuple(pm.spec_axes(e) for e in spec)


@pytest.mark.parametrize("axes,batch", SPEC_CASES,
                         ids=["tp2dp4", "tp8", "dp8b3", "dp8b8",
                              "dp2fsdp2tp2"])
def test_kv_cache_sharding_and_projections_match_jax(axes, batch):
    jsh = jtp.kv_cache_sharding(jl.tiny(dtype=jnp.float32),
                                jm.make_mesh(axes), batch)
    want = tuple(jsh.spec) + (None,) * (4 - len(jsh.spec))
    sh = ptp.kv_cache_sharding(u.cfg_of(), pm.Mesh(pm.mesh_shape(axes, 8)),
                               batch)
    assert _norm(sh.spec) == _norm(want)
    # serve_loop's projections (JAX's _row_sharding and _pool_sharding)
    assert _norm(serving._row_sharding(sh).spec) == _norm(
        (None,) + want[1:])
    assert _norm(serving._pool_sharding(sh).spec) == _norm(
        (None, None) + want[2:])
    assert serving._row_sharding(None) is None
    assert serving._pool_sharding(None) is None


def test_anything_but_a_kv_cache_sharding_is_refused():
    for fn in (serving._row_sharding, serving._pool_sharding):
        with pytest.raises(ValueError, match="parallel/tp.kv_cache_sharding"):
            fn(object())
    cfg = u.cfg_of(max_len=64)
    model = u.build(cfg, 0, None)
    other = ptp.kv_cache_sharding(u.cfg_of(n_heads=8, n_kv_heads=4),
                                  pm.Mesh({"tp": 1}), 2)
    with pytest.raises(ValueError, match="kv_cache_sharding"):
        tl.generate(model, u.batch(1, 2, 4), 2, cache_sharding=other,
                    device="cpu")
    split = ptp.kv_cache_sharding(cfg, pm.Mesh({"tp": 2}), 2)
    with pytest.raises(ValueError, match="shard_model on the same mesh"):
        tl.generate(model, u.batch(1, 2, 4), 2, cache_sharding=split,
                    device="cpu")


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("axes", [{"tp": 2, "dp": 4},
                                  {"dp": 2, "fsdp": 2, "tp": 2}],
                         ids=["tp2dp4", "dp2fsdp2tp2"])
def test_int8_blocks_equal_device_puts_shards(axes):
    """Every leaf, every rank: the int8 payload and the scale the port's
    place keeps (from a quantized tree, as bridge.iter_int8_params draws
    it) are jax.device_put(quantize_params(params),
    transformer_param_sharding(...))'s shards on that device
    (test_tp_serving.py:135)."""
    jcfg = jl.tiny(dtype=jnp.float32)
    model_j = jl.Llama(jcfg)
    params = jax.jit(lambda r: model_j.init(
        r, jnp.zeros((1, 8), jnp.int32), train=False))(
            jax.random.PRNGKey(0))["params"]
    qp = jq.quantize_params(params)
    placed = jax.device_put(qp, jtp.transformer_param_sharding(
        qp, jm.make_mesh(axes)))
    tree = bridge.params_from_jax(u.cfg_of(),
                                  jax.tree.map(np.asarray, qp))
    n_q = 0
    for rank in range(8):
        mesh = pm.Mesh(pm.mesh_shape(axes, 8), rank=rank)
        with torch.device("meta"):
            model = tl.Llama(u.cfg_of())
        pl = place(model, mesh, ptp.transformer_param_sharding(
            {k: v if isinstance(v, QTensor) else tuple(v.shape)
             for k, v in tree.items()}, mesh), tree.items(), device="cpu",
            requires_grad=False)
        mine = pl.params(model)
        for name, whole in tree.items():
            leaf = _at(placed, ptp.jax_path(name))
            if not isinstance(whole, QTensor):
                continue
            n_q += 1
            mod_name, _, attr = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            scale = (mod.parametrizations[attr + "_scale"].original
                     if hasattr(mod, "parametrizations")
                     and attr + "_scale" in mod.parametrizations
                     else getattr(mod, attr + "_scale"))
            for part, got in (("q", mine[name]), ("scale", scale)):
                shard = next(s for s in getattr(leaf, part).addressable_shards
                             if s.device.id == rank)
                assert np.array_equal(got.numpy(), np.asarray(shard.data)), \
                    (name, part, rank)
    assert n_q == 8 * 12  # embed, lm_head, five kernels a block


def test_one_process_tied_generate_equals_jax():
    """The tied case's one process against JAX's generate on JAX's
    weights (the untied, int8, window, chunked and int8-KV cases are
    held by tests/test_torch_dense.py)."""
    jcfg = jl.tiny(dtype=jnp.float32, max_len=64, tie_embeddings=True)
    model_j = jl.Llama(jcfg)
    params = jax.jit(lambda r: model_j.init(
        r, jnp.zeros((1, 8), jnp.int32), train=False))(
            jax.random.PRNGKey(0))["params"]
    cfg = u.cfg_of(max_len=64, tie_embeddings=True)
    model = tl.Llama.from_params(
        cfg, bridge.params_from_jax(cfg, jax.tree.map(np.asarray, params)),
        device="cpu")
    prompt = u.batch(1, 4, 12)
    want = np.asarray(jl.generate(model_j, params, jnp.asarray(prompt), 6))
    got = tl.generate(model, prompt, 6, device="cpu")
    assert np.array_equal(got.numpy(), want)


# ----------------------------------------------------------- the spawned job
@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return u.run(tmp_path_factory.mktemp("tp_serving"))


@pytest.mark.parametrize("tag", sorted(u.JOBS))
def test_every_rank_equals_one_process(run, tag):
    u.check_outputs(tag, *run)


@pytest.mark.parametrize("tag", sorted(u.JOBS))
def test_each_ranks_cache_is_its_block(run, tag):
    """Each rank's cache (lanes, rings or pool) at the end is its block
    of one process's: its rows where the batch splits over the data
    axes, and its kv heads."""
    u.check_caches(tag, *run)


def test_params_and_caches_are_actually_sharded(run):
    """test_tp_serving.py:122: a tp rank's wq holds half the query heads
    and its cache half the kv heads (the batch over dp where it
    divides); at tp 4 each rank's cache holds the one kv head its query
    head reads (JAX replicates tiny's two)."""
    ranks, _ = run
    cfg = u.cfg_of()
    for r in range(8):
        got = ranks[r]["gen"]
        assert got["wq"] == (cfg.d_model, cfg.n_heads // 2, cfg.head_dim)
        k = got["caches"][0][0][0]
        assert tuple(k.shape[::2]) == (1, cfg.n_kv_heads // 2)
        tp4 = ranks[r]["tp4"]["caches"]
        assert all(c[0][0].shape[2] == 1 for c in tp4)
    mesh = pm.Mesh(pm.mesh_shape({"tp": 4, "dp": 2}, 8), rank=3)
    assert ptp.kv_cache_sharding(cfg, mesh, 4).kv_heads() == [1]


def test_speculation_gives_generate_tokens_and_cases_reach_their_aim(run):
    u.check_reach(run[1])


@pytest.mark.parametrize("tag", sorted(u.HANDOFF))
def test_tp_exports_are_one_process_exports(run, tag):
    u.check_exports(tag, *run)


@pytest.mark.parametrize("tag", sorted(u.HANDOFF))
def test_adoption_crosses_between_tp_and_one_process(run, tag):
    u.check_adoption(tag, *run)
