"""The GPipe schedule (parallel/pp) against the JAX package's
(tests/test_pp.py's five tests, their cases and tolerances).

In one process (every stage held, parallel/ring.LocalRing) on the
forced host devices for JAX: the outputs of 4 stages on pp 4 x dp 2 at
4 and 8 microbatches within 1e-5 of JAX's make_pipeline_fn, the
gradients of the stacked leaves within 1e-4, JAX's refusals word for
word (an uneven batch, stacked stages that do not match the pp axis),
and a bf16 batch through f32 stages carrying f32 within 2e-2.

One spawned job of eight JAX-free gloo ranks
(tests/torch_sharded_util.start, tests/torch_pipeline_util.gpipe_case)
runs the same cases one stage a rank (parallel/ring.ProcessRing over
mesh.group("pp"): the hops are rotations, the backward autograd's), and
a data split (pp 2 x dp 4, batch_axes "dp": each rank its member's
rows, pp.data_rows; the gradients reduced over dp, pp.reduce_gradients_)
against the port's one process within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_pipeline_util as pu
from tests import torch_sharded_util as u
from tf_operator_tpu.parallel import pp as jpp
from tf_operator_tpu.parallel.mesh import make_mesh as jmake_mesh
from tf_operator_tpu_torch.parallel import pp
from tf_operator_tpu_torch.parallel.mesh import make_mesh

MESH = {"pp": 4, "dp": 2}            # tests/test_pp.py's mesh
CASE = "tests.torch_pipeline_util:gpipe_case"
JOBS = {   # tag: (mesh axes, keyword arguments of gpipe_case)
    "n_micro4": (MESH, dict(seed=0, batch=16, n_micro=4)),
    "n_micro8": (MESH, dict(seed=0, batch=16, n_micro=8)),
    "grads": (MESH, dict(seed=2, batch=8, n_micro=4)),
    "bf16": (MESH, dict(seed=8, batch=8, n_micro=4, bf16=True)),
    "dp_rows": ({"pp": 2, "dp": 4}, dict(seed=4, batch=16, n_micro=2,
                                         batch_axes="dp")),
}


def _jax_stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _jax(seed, batch, n_micro, bf16=False):
    """JAX's make_pipeline_fn on pp 4 x dp 2: outputs and the gradients
    of sum(out²) (jitted)."""
    stacked = jpp.stack_stage_params([
        {k: jnp.asarray(v) for k, v in s.items()}
        for s in pu.pp_params(seed)])
    x = jnp.asarray(pu.pp_batch(seed + 1, batch))
    if bf16:
        x = x.astype(jnp.bfloat16)
    run = jpp.make_pipeline_fn(jmake_mesh(MESH), _jax_stage, n_micro)
    out, g = jax.jit(lambda p, x: (run(p, x), jax.grad(
        lambda p: jnp.sum(run(p, x).astype(jnp.float32) ** 2))(p)))(
            stacked, x)
    return np.asarray(out.astype(jnp.float32)), jax.tree.map(np.asarray, g)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The job's readings (started first), JAX's and one process's."""
    job = u.start({tag: (CASE, axes, kw) for tag, (axes, kw)
                   in JOBS.items()}, tmp_path_factory.mktemp("pp"))
    jax_out = {tag: _jax(**kw) for tag, (_, kw) in JOBS.items()
               if tag != "dp_rows"}
    one = {tag: u.one_process(CASE, axes=axes, **kw)
           for tag, (axes, kw) in JOBS.items()}
    return {"got": u.join(job), "jax": jax_out, "one": one}


def _sequential(seed, x, n_stages=pu.PP_STAGES):
    for s in pu.pp_params(seed, n_stages):
        x = pu.pp_stage_fn({k: torch.from_numpy(v) for k, v in s.items()},
                           x)
    return x


def _job_equals_one(run, tag):
    got, one = run["got"][tag], run["one"][tag]
    torch.testing.assert_close(got["out"], one["out"], rtol=1e-5, atol=1e-5)
    for k in one["grads"]:
        torch.testing.assert_close(got["grads"][k], one["grads"][k],
                                   rtol=1e-5, atol=1e-5)
    assert got["stages_seen"] == list(range(len(one["grads"]["w"])))


@pytest.mark.parametrize("n_micro", [4, 8])
def test_gpipe_matches_sequential(run, n_micro):
    tag = f"n_micro{n_micro}"
    one = run["one"][tag]
    np.testing.assert_allclose(one["out"].numpy(), run["jax"][tag][0],
                               atol=1e-5, rtol=1e-5)
    want = _sequential(0, torch.from_numpy(pu.pp_batch(1, 16)))
    np.testing.assert_allclose(one["out"].numpy(), want.numpy(),
                               atol=1e-5, rtol=1e-5)
    _job_equals_one(run, tag)


def test_gpipe_grads_match_sequential(run):
    one = run["one"]["grads"]
    _, g = run["jax"]["grads"]
    for k in ("w", "b"):
        np.testing.assert_allclose(one["grads"][k].numpy(), g[k],
                                   atol=1e-4, rtol=1e-4)
    # the sequential stack's gradients, through torch's autograd
    params = [{k: torch.from_numpy(v).requires_grad_() for k, v in s.items()}
              for s in pu.pp_params(2)]
    x = torch.from_numpy(pu.pp_batch(3, 8))
    for p in params:
        x = pu.pp_stage_fn(p, x)
    (x ** 2).sum().backward()
    for k in ("w", "b"):
        want = torch.stack([p[k].grad for p in params])
        torch.testing.assert_close(one["grads"][k], want, atol=1e-4,
                                   rtol=1e-4)
    _job_equals_one(run, "grads")
    # a data split: each rank its member's rows, gradients over dp
    _job_equals_one(run, "dp_rows")
    want = _sequential(4, torch.from_numpy(pu.pp_batch(5, 16)), 2)
    torch.testing.assert_close(run["got"]["dp_rows"]["out"], want,
                               atol=1e-5, rtol=1e-5)


def _messages(port, jax_fn):
    with pytest.raises(ValueError) as got:
        port()
    with pytest.raises(ValueError) as want:
        jax_fn()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_gpipe_uneven_batch_raises():
    stacked = pp.stack_stage_params([{k: torch.from_numpy(v) for k, v in
                                      s.items()} for s in pu.pp_params(4)])
    jstacked = jpp.stack_stage_params([{k: jnp.asarray(v) for k, v in
                                        s.items()} for s in pu.pp_params(4)])
    x = pu.pp_batch(5, 8)
    msg = _messages(
        lambda: pp.make_pipeline_fn(make_mesh(MESH, world=8), pu.pp_stage_fn,
                                    n_micro=3)(stacked, torch.from_numpy(x)),
        lambda: jpp.make_pipeline_fn(jmake_mesh(MESH), _jax_stage,
                                     n_micro=3)(jstacked, jnp.asarray(x)))
    assert "not divisible" in msg


def test_gpipe_stage_count_mismatch_raises():
    """4 stacked stages on a pp=2 mesh must fail loudly, not silently run
    only stages [0, 2]."""
    stacked = pp.stack_stage_params([{k: torch.from_numpy(v) for k, v in
                                      s.items()} for s in pu.pp_params(6)])
    jstacked = jpp.stack_stage_params([{k: jnp.asarray(v) for k, v in
                                        s.items()} for s in pu.pp_params(6)])
    x = pu.pp_batch(7, 8)
    axes = {"pp": 2, "dp": 4}
    msg = _messages(
        lambda: pp.make_pipeline_fn(make_mesh(axes, world=8), pu.pp_stage_fn,
                                    n_micro=4)(stacked, torch.from_numpy(x)),
        lambda: jpp.make_pipeline_fn(jmake_mesh(axes), _jax_stage,
                                     n_micro=4)(jstacked, jnp.asarray(x)))
    assert "must match" in msg
    # and gpipe itself, handed a block with the wrong stage dim
    with pytest.raises(ValueError, match="stacked stage dim must equal"):
        pp.gpipe(pu.pp_stage_fn, stacked, torch.zeros(4, 2, pu.PP_D),
                 ring=pp.LocalRing(2))


def test_gpipe_bf16_batch_f32_params(run):
    """Dtype-promoting stages (bf16 batch through f32 params) carry the
    promoted dtype."""
    one = run["one"]["bf16"]
    assert one["out"].dtype == torch.float32
    np.testing.assert_allclose(one["out"].numpy(), run["jax"]["bf16"][0],
                               atol=2e-2, rtol=2e-2)
    want = _sequential(8, torch.from_numpy(pu.pp_batch(9, 8)).bfloat16())
    np.testing.assert_allclose(one["out"].numpy(), want.numpy(),
                               atol=2e-2, rtol=2e-2)
    got = run["got"]["bf16"]
    assert got["out"].dtype == torch.float32
    _job_equals_one(run, "bf16")
