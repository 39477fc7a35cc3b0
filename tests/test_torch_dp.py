"""Data parallelism across processes (parallel/dp, runtime/bootstrap):
two gloo ranks, each on its rows of the global batch, against one
process on the whole batch, after two steps on the CPU (the cases run in
tests/torch_dp_util.py, one spawn of two JAX-free ranks for the file):

  - train_llama's step on its tied smoke model (blocked CE, adafactor);
  - the mixtral smoke model, whose MoE aux loss spans the global batch;
  - train_bert's step with masks that cover the ranks unevenly (the
    masked mean's count is the global one);
  - runtime/train.make_train_step on a small ResNet (BatchNorm's
    statistics, their backward and the running stats span the ranks);
  - the same ResNet from JAX-drawn variables against the JAX package's
    make_train_step under make_mesh({"dp": 2});
  - the four training CLIs as a job of two ranks: checkpoints written by
    rank 0 and resumed on both, a SIGTERM latched on one rank stops both
    at the same step with exit 143.

Tolerances (f32): losses 1e-5 relative; parameters and running stats
rtol 1e-5 + atol 1e-5 against one process (the sums run in another
order); both ranks' parameters bit-equal; against JAX the vision tests'
tolerances (losses 1e-5, parameter updates 1e-3 by relative error norm,
running stats 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_dp_util as u
from tf_operator_tpu.models import resnet as jr
from tf_operator_tpu.parallel.mesh import make_mesh
from tf_operator_tpu.runtime import train as jtr
from tf_operator_tpu_torch import train_llama, train_t5
from tf_operator_tpu_torch.models import vision_bridge as vb

STEP_CASES = ["llama", "mixtral", "bert", "resnet"]


def _jax_variables():
    """The small ResNet's variables in the flax tree, drawn with numpy
    (kernels lecun over their fan-in, BatchNorm scales and vars near 1)."""
    model_j = jr.ResNet(dtype=jnp.float32, **u.RESNET)
    x, _ = u.resnet_images(0)
    shapes = jax.eval_shape(lambda: model_j.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        n = rng.standard_normal(s.shape).astype(np.float32)
        if name.endswith("['kernel']"):
            return n / np.sqrt(np.prod(s.shape[:-1]))
        if name.endswith("['scale']") or name.endswith("['var']"):
            return 1.0 + 0.1 * np.abs(n)
        return 0.1 * n

    return model_j, jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's result on each of two spawned ranks (one spawn)."""
    tmp = tmp_path_factory.mktemp("dp")
    model_j, var = _jax_variables()
    kw = {"cli": {"ckpt_dir": str(tmp / "ckpt")},
          "resnet_jax": {"params": vb.resnet_params_from_jax(var)}}
    results = u.spawn(STEP_CASES + ["resnet_jax", "cli"], tmp, kw=kw)
    return dict(results=results, model_j=model_j, var=var,
                ckpt=tmp / "ckpt")


def _close(got, want, name):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("case", STEP_CASES)
def test_two_ranks_equal_one_process_on_the_whole_batch(ranks, case):
    r0, r1 = (r[case] for r in ranks["results"])
    ref = u.one_process(case)
    for k in ref["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    for k in ref["stats"]:
        assert torch.equal(r0["stats"][k], r1["stats"][k]), k
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=1e-5)
    assert any(not torch.equal(p, ref["start"][k])
               for k, p in ref["params"].items())
    for k, p in ref["params"].items():
        _close(r0["params"][k], p, k)
    for k, b in ref["stats"].items():
        _close(r0["stats"][k], b, k)
    if case == "bert":
        # the ranks masked different numbers of positions every step
        assert all(a != b for a, b in zip(r0["masked"], r1["masked"]))
        assert [a + b for a, b in zip(r0["masked"], r1["masked"])] == \
            ref["masked"]
    if case == "resnet":
        assert len(ref["stats"]) > 0


def test_two_ranks_equal_jax_under_a_dp_mesh(ranks):
    """The JAX step jitted over the global batch on a {"dp": 2} mesh of
    two host devices; the port's two ranks from the same variables."""
    model_j, var = ranks["model_j"], ranks["var"]
    got = ranks["results"][0]["resnet_jax"]
    tx = optax.sgd(0.1, momentum=0.9)
    state = jtr.TrainState(step=jnp.zeros((), jnp.int32),
                           params=var["params"],
                           opt_state=tx.init(var["params"]),
                           batch_stats=var["batch_stats"], tx=tx)
    mesh = make_mesh({"dp": 2}, devices=jax.devices()[:2])
    step = jtr.make_train_step(model_j, mesh=mesh)
    losses = []
    for i in range(u.STEPS):
        x, y = u.resnet_images(10 + i)
        state, m = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    start = vb.resnet_params_from_jax(var)
    want = vb.resnet_params_from_jax(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))
    for k, p in got["params"].items():
        d_got = (p - start[k]).double()
        d_want = (want[k] - start[k]).double()
        err = float(torch.linalg.vector_norm(d_got - d_want)
                    / torch.linalg.vector_norm(d_want).clamp_min(1e-30))
        assert err <= 1e-3, (k, err)
    for k, b in got["stats"].items():
        torch.testing.assert_close(b, want[k], rtol=0, atol=1e-5, msg=k)


def test_training_clis_run_as_two_ranks(ranks):
    """train_llama (a checkpoint a step, then a resume), train_bert,
    train_t5 (then a SIGTERM on rank 1 alone) and train_resnet as a job
    of two ranks: every run agrees on both ranks."""
    runs = [r["cli"] for r in ranks["results"]]
    for rank, run in enumerate(runs):
        for name, (rc, out) in run.items():
            assert rc == (143 if name == "t5-preempted" else 0), (name, out)
            assert f"host {rank}/2" in out, (name, out)
    last = [{k: out.strip().splitlines()[-1] for k, (_, out) in run.items()}
            for run in runs]
    assert last[0] == last[1]
    assert last[0]["llama"].startswith("complete: steps=2 resumed_from=None")
    assert last[0]["llama-resume"].startswith(
        "complete: steps=1 resumed_from=2")
    assert last[0]["t5-preempted"] == \
        "preempted (checkpointed): steps=1 resumed_from=2"
    assert last[0]["resnet"] == "done: steps=2 preempted=False"
    # rank 0 wrote each step once; both ranks resumed from it
    assert sorted(p.name for p in (ranks["ckpt"] / "llama").iterdir()) == \
        ["1", "2", "3"]
    assert sorted(p.name for p in (ranks["ckpt"] / "t5").iterdir()) == \
        ["1", "2", "3"]


@pytest.mark.parametrize("main,argv", [
    (train_llama.main, ["--smoke", "--tp", "2"]),
    (train_llama.main, ["--smoke", "--model", "mixtral", "--ep", "2"]),
    (train_t5.main, ["--smoke", "--tp", "2"]),
])
def test_tensor_and_expert_parallelism_stay_refused(main, argv, monkeypatch):
    """--tp and --ep are a job's layout now (tests/test_torch_sharded.py
    and test_torch_ep.py train them), so in a job of two ranks without
    its rendezvous the bootstrap names what is missing, as the JAX
    script's bootstrap runs before its --ep checks."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        main(argv + ["--device", "cpu"])
