"""Sharded training over a tp x fsdp x dp mesh (parallel/mesh,
parallel/tp, parallel/placement, the sharded optimizer and Checkpointer):
one job of eight gloo processes on JAX's test mesh tp 2 x fsdp 2 x dp 2
(tests/test_llama.py:187) runs every case in turn
(tests/torch_sharded_util.py, JAX-free), each rank holding its shard of
the state as JAX's state_sharding places it and reading its data
member's rows, and each case is held against the port's one process on
the whole batch after two steps:

  - test_llama.py:187's adam step (untied lm_loss over the
    vocab-parallel lm_head, JAX's weights and tokens);
  - test_blocked_ce.py:152's tied blocked CE over a vocab-parallel
    embedding (min_fsdp_size 0, chunk 64 over a 96-row slice);
  - test_lora.py:96's LoRA step (the base sharded, the adapters whole);
  - the tiny Transformer under adamw and adafactor (min_fsdp_size 0);
  - the mixtral smoke model (the packed expert wi gathered over tp);
  - tp 4 x fsdp 2, which replicates tiny's wkv (KV = 2);
  - tests/test_runtime.py:263's runtime/train.make_train_step with
    JAX's DEFAULT_RULES and the state's shardings pinned, three steps;
  - a checkpoint written by the sharded job and resumed in one process,
    and one written by one process and resumed by the sharded job.

The one-process run is held against JAX's where no other test holds it
(the adam step and the blocked CE, on JAX's weights).  A second job of
two ranks runs train_llama --smoke --tp 2 and train_t5 --smoke --tp 2.

Tolerances (f32): losses and gradient norms 1e-5 relative; parameters
rtol 1e-5 + atol 1e-5 (the sums run in another order).  Under Adam and
AdamW the parameters are held by each leaf's update, relative error norm
1e-3: a gradient that cancels to near zero takes an update of about
lr·g/(|g| + eps), which turns the sums' rounding into visible moves of
single elements (one of the 1024 of blocked_ce's pos_embed moves
1.9e-5); their losses and gradient norms keep 1e-5.  Against JAX the
loss 1e-5 and the gradient norm 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_sharded_util as u
from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models import transformer as jt
from tf_operator_tpu.models.transformer import lm_loss as jlm_loss
from tf_operator_tpu.ops.blocked_ce import lm_blocked_loss as jblocked
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import transformer as tt
from tf_operator_tpu_torch.models.transformer_bridge import (
    transformer_params_from_jax)

ADAM = ("llama_adam", "blocked_ce", "lora", "t5_adamw", "train_step")
BLOCKED = dict(vocab_size=192, d_model=64, n_heads=4, n_layers=2, d_ff=128,
               max_len=16)


def _init(model, rng, toks):
    """flax's init, jitted (the same draws, without the eager trace)."""
    return jax.jit(lambda r, t: model.init(r, t, train=False))(
        rng, toks)["params"]


def _jax_llama():
    """test_llama.py:187's model, weights and tokens; the one-device loss
    and gradient norm come from `_jax_readings`."""
    cfg = jl.tiny(dtype=jnp.float32)
    model = jl.Llama(cfg)
    toks = jax.random.randint(jax.random.PRNGKey(0), (8, cfg.max_len), 0,
                              cfg.vocab_size)
    params = _init(model, jax.random.PRNGKey(0), toks)
    full = bridge.params_from_jax(tl.tiny(dtype=torch.float32),
                                  jax.tree.map(np.asarray, params),
                                  train=True)
    t = np.asarray(toks).astype(np.int64)
    return (dict(full=full, toks=[t, t], tied=False, opt="adam",
                 min_fsdp_size=2**14),
            lambda p: jlm_loss(model.apply({"params": p}, toks), toks),
            params)


def _jax_blocked():
    """test_blocked_ce.py:152's model, weights and tokens."""
    cfg = jt.TransformerConfig(causal=True, dtype=jnp.float32,
                               tie_embeddings=True, **BLOCKED)
    model = jt.Transformer(cfg)
    rng = jax.random.PRNGKey(0)
    toks = jax.random.randint(rng, (8, cfg.max_len), 0, cfg.vocab_size)
    params = _init(model, rng, toks)
    tcfg = tt.tiny(causal=True, dtype=torch.float32, **BLOCKED)
    full = transformer_params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                          params))
    t = np.asarray(toks).astype(np.int64)
    return (dict(full=full, toks=[t, t], opt="adam", blocked_chunk=64,
                 cfg_kw=BLOCKED),
            lambda p: jblocked(model, p, toks, chunk=64), params)


def _jax_readings(loss_fn, params):
    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), float(optax.global_norm(g))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The eight-rank job's readings, the one-process runs of the same
    cases (computed while the job runs), JAX's one-device readings, and
    the two-rank job of the CLIs."""
    tmp = tmp_path_factory.mktemp("sharded")
    llama_kw, llama_loss, llama_params = _jax_llama()
    blocked_kw, blocked_loss, blocked_params = _jax_blocked()
    for name, kw in (("llama_kw", llama_kw), ("blocked_kw", blocked_kw)):
        torch.save(kw, tmp / f"{name}.pt")
    one_dir, sharded_dir = str(tmp / "ckpt-one"), str(tmp / "ckpt-sharded")
    cases = {
        "llama_adam": ("llama", u.MESH, str(tmp / "llama_kw.pt")),
        "blocked_ce": ("transformer", u.MESH, str(tmp / "blocked_kw.pt")),
        "lora": ("llama", u.MESH, dict(tied=False, opt="adam",
                                        min_fsdp_size=2**14, lora_rank=2)),
        "t5_adamw": ("transformer", u.MESH, dict(opt="adamw")),
        "t5_adafactor": ("transformer", u.MESH, dict(opt="adafactor")),
        "mixtral": ("llama", u.MESH, dict(moe=True)),
        "tp4_wkv": ("llama", u.MESH_TP4, dict(d_ff=256)),
        "train_step": ("train_step", u.MESH, {}),
    }
    u.one_process("ckpt", save_dir=one_dir)
    job = u.start(dict(cases, ckpt=("ckpt", u.MESH, dict(
        load_dir=one_dir, save_dir=sharded_dir))), tmp)
    cli_tmp = tmp / "cli"
    cli_tmp.mkdir()
    cli = u.start({"cli": ("cli", None, dict(ckpt_dir=str(cli_tmp / "ck")))},
                  cli_tmp, n=2)
    jax_readings = {"llama_adam": _jax_readings(llama_loss, llama_params),
                    "blocked_ce": _jax_readings(blocked_loss,
                                                blocked_params)}
    one = {}
    for tag, (case, _, kw) in cases.items():
        one[tag] = u.one_process(case, **(llama_kw if tag == "llama_adam"
                                          else blocked_kw
                                          if tag == "blocked_ce" else kw))
    one["llama"] = u.one_process("llama")
    sharded = u.join(job)
    one["ckpt"] = u.one_process("ckpt", load_dir=sharded_dir)
    return {"one": one, "sharded": sharded, "jax": jax_readings,
            "cli": u.join(cli)["cli"]}


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("tag", ["llama_adam", "blocked_ce", "lora",
                                 "t5_adamw", "t5_adafactor", "mixtral",
                                 "tp4_wkv", "train_step"])
def test_sharded_job_equals_one_process(run, tag):
    got, want = run["sharded"][tag], run["one"][tag]
    steps = 3 if tag == "train_step" else u.STEPS
    assert len(got["losses"]) == steps and len(got["gnorms"]) == steps
    assert all(g > 0 for g in got["gnorms"])
    u.check(got, want, adam=tag in ADAM, tag=tag)


@pytest.mark.parametrize("tag", ["llama_adam", "blocked_ce"])
def test_one_process_equals_jax(run, tag):
    """The port's one process against JAX's one device: the first
    step's loss and global gradient norm."""
    loss, gnorm = run["jax"][tag]
    one = run["one"][tag]
    assert _rel(one["losses"][0], loss) < 1e-5, (one["losses"][0], loss)
    assert _rel(one["gnorms"][0], gnorm) < 1e-5, (one["gnorms"][0], gnorm)


def test_checkpoint_moves_between_one_process_and_the_mesh(run):
    """One process resumes the sharded job's step-1 checkpoint, and the
    sharded job resumes one process's: each second step equals one
    process's two steps."""
    want = run["one"]["llama"]
    for side in ("one", "sharded"):
        got = run[side]["ckpt"]
        assert got["restored_step"] == 1, side
        assert _rel(got["losses"][0], want["losses"][1]) < 1e-5, side
        for k, p in want["params"].items():
            torch.testing.assert_close(got["params"][k], p, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("run_name", ["llama", "t5"])
def test_cli_trains_at_tp_2(run, run_name):
    rc, out = run["cli"][run_name]
    assert rc == 0, out
    assert ("mesh {'dcn': 1, 'pp': 1, 'dp': 1, 'fsdp': 1, 'ep': 1, "
            "'tp': 2}") in out
    assert "complete: steps=2 resumed_from=None" in out


def test_cli_resumes_at_tp_2(run):
    rc, out = run["cli"]["llama-resume"]
    assert rc == 0, out
    assert "complete: steps=1 resumed_from=2" in out


def test_decoding_a_tp_model_refuses_naming_its_item():
    """A tensor-parallel model decodes (ROADMAP item 11h is done:
    tests/test_torch_tp_serving.py) over the cache of its own kv heads;
    a cache of every kv head, paged or dense, is refused, naming
    parallel/tp.kv_cache_sharding, before it is written."""
    from tf_operator_tpu_torch.models import paging
    from tf_operator_tpu_torch.parallel.comm import Tp

    cfg = tl.tiny(dtype=torch.float32)
    model = tl.Llama.from_params(cfg, bridge.init_params(cfg, 0,
                                                         device="cpu"),
                                 device="cpu")
    for mod in model.modules():   # as placement.place sets its group
        if hasattr(type(mod), "tp"):
            mod.tp = Tp(None, 0, 2)
    tok = torch.zeros((1, 1), dtype=torch.long)
    dense = tl.init_cache(cfg, 1, 16, device="cpu")
    pool = paging.init_block_pool(cfg, 4, 4, device="cpu")
    table = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    for cache, tbl in ((dense, None), (pool, table)):
        with pytest.raises(ValueError, match="kv_cache_sharding"):
            model(tok, cache=cache, cache_pos=0, block_table=tbl)
        assert all(float(t.abs().sum()) == 0.0 for kv in cache for t in kv)
