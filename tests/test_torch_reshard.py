"""Checkpoint resharding (models/reshard) and the elastic-resize loss
trajectory against the JAX package's (tests/test_zreshard.py's eight
tests, their cases and tolerances).

The port's Checkpointer writes every leaf whole, so a resharded
checkpoint holds the same tensors; what is held here is the move's
contract.  In one process: state_shardings' spec of every leaf (params
and adam's moments) against JAX's on the forced host devices; a
checkpoint of step 9 resharded 2 -> 4 (twice: a crash re-run overwrites)
and 4 -> 2, the source untouched and every restored tensor equal;
JAX's refusals word for word (an in-place destination, a missing
checkpoint); host_gather's whole host tensors; reshard_shapes' summary.

Two spawned jobs of JAX-free gloo ranks (tests/torch_pipeline_util
.reshard_leg_case; the MLP placed on an fsdp mesh by state_shardings,
runtime/loop.run_training, the Checkpointer): two ranks train 6 steps on
fsdp 2, saving every 3, and drain on SIGTERM at the exact in-flight
step (a second run); the checkpoint is resharded to fsdp 4 in this
process; four ranks run a never-resized 12-step golden and resume the
resharded step for 6 more.  The resumed trajectory matches the golden
step for step (rtol 2e-4, atol 1e-5), and the golden JAX's fixed-size
golden on the same weights and batches.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_pipeline_util as pu
from tests import torch_sharded_util as u
from tf_operator_tpu.models import reshard as jrs
from tf_operator_tpu.parallel.mesh import make_mesh as jmake_mesh
from tf_operator_tpu.runtime.train import (create_train_state,
                                           make_train_step)
from tf_operator_tpu_torch.models.reshard import (
    host_gather, place_state, reshard_checkpoint, reshard_shapes,
    state_shardings)
from tf_operator_tpu_torch.parallel.mesh import make_mesh
from tf_operator_tpu_torch.runtime.train import Checkpointer

LEG = "tests.torch_pipeline_util:reshard_leg_case"


class _JaxMlp:
    """tests/test_zreshard.py's MLP, its weights the numpy draws of
    tests/torch_pipeline_util.mlp_init."""

    def init(self, rng, x, train=False):
        return {"params": {k: jnp.asarray(v)
                           for k, v in pu.mlp_init().items()}}

    def apply(self, variables, x, train=False):
        p = variables["params"]
        h = jax.nn.relu(x @ p["w1"] + p["b1"])
        return (h @ p["w2"] + p["b2"])[:, :pu.D_OUT]


def _jmesh(fsdp):
    return jmake_mesh({"fsdp": fsdp}, jax.devices()[:fsdp])


def _jax_state(fsdp):
    state = create_train_state(jax.random.PRNGKey(0), _JaxMlp(),
                               jnp.ones((8, pu.D_IN)), optax.adam(1e-2))
    return jrs.place_state(state, _jmesh(fsdp))


def _jax_golden(steps=12):
    """JAX's never-resized fsdp 4 run: a loss a step."""
    mesh = _jmesh(4)
    state = _jax_state(4)
    step = make_train_step(_JaxMlp(), has_batch_stats=False, mesh=mesh,
                           state_shardings=jrs.state_shardings(state, mesh))
    losses = []
    for x, y in pu.mlp_batches(0, steps):
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two jobs' readings (the two-rank legs, the reshard here, then
    the four-rank golden and resume), and JAX's golden."""
    tmp = tmp_path_factory.mktemp("reshard")
    src, dst = str(tmp / "src"), str(tmp / "dst")
    for job in ("small", "big"):
        (tmp / job).mkdir()
    small = u.start({
        "leg1": (LEG, {"fsdp": 2}, dict(num_steps=6, ckpt_dir=src,
                                        save_interval=3)),
        "drain": (LEG, {"fsdp": 2}, dict(num_steps=50, drain_at=7,
                                         ckpt_dir=str(tmp / "drain"))),
    }, tmp / "small", n=2)
    golden_jax = _jax_golden()
    legs = u.join(small)
    resharded = reshard_checkpoint(src, dst, make_mesh({"fsdp": 4},
                                                       world=4))
    big = u.start({
        "golden": (LEG, {"fsdp": 4}, dict(num_steps=12)),
        "leg2": (LEG, {"fsdp": 4}, dict(start=6, num_steps=12,
                                        ckpt_dir=dst)),
    }, tmp / "big", n=4)
    out = dict(u.join(big), **legs)
    return dict(out, jax=golden_jax, resharded=resharded,
                drain_dir=str(tmp / "drain"))


def _trim(spec) -> tuple:
    """A spec with its trailing Nones dropped (JAX's NamedSharding spec
    as the port writes one)."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _one_state():
    return pu.mlp_setup(None)[1]


# ----------------------------------------------------------- placement
def test_state_shardings_shards_large_leaves_and_replicates_small(run):
    state = _one_state()
    sh = state_shardings(state, make_mesh({"fsdp": 4}, world=4))
    assert "fsdp" in sh.params["w1"]            # large: sharded
    assert sh.params["b1"] == ()                # small: replicated
    # adam moments shaped like w1 shard exactly like w1 — the optimizer
    # state rides the same single placement rule
    assert sh.opt_state["mu"]["w1"] == sh.params["w1"]
    assert sh.opt_state["nu"]["w1"] == sh.params["w1"]
    # every leaf's spec is JAX's
    jsh = jrs.state_shardings(_jax_state(4), _jmesh(4))
    for k in ("w1", "b1", "w2", "b2"):
        assert _trim(sh.params[k]) == _trim(jsh.params[k].spec), k
        assert _trim(sh.opt_state["mu"][k]) == _trim(
            jsh.opt_state[0].mu[k].spec), k
    # a sharded state (the four ranks' of the golden run) reads the same
    assert run["golden"]["specs"] == sh.params
    assert run["golden"]["opt_specs"]["mu"] == sh.opt_state["mu"]
    assert run["golden"]["blocks"]["w1"] != (pu.D_IN, pu.D_HID)


def _files(directory):
    out = {}
    for root, _, names in os.walk(directory):
        for n in names:
            path = os.path.join(root, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, directory)] = f.read()
    return out


def test_reshard_checkpoint_grow_shrink_and_crash_rerun(tmp_path):
    # a state with moments: one step
    x, y = next(pu.mlp_batches(0, 1))
    model, state, step, _ = pu.mlp_setup(None)
    state, _ = step(state, torch.from_numpy(x), torch.from_numpy(y))
    state.step = 9
    src = str(tmp_path / "src")
    Checkpointer(src).save(9, state)
    before = _files(src)
    mesh2 = make_mesh({"fsdp": 2}, world=2)
    mesh4 = make_mesh({"fsdp": 4}, world=4)
    dst = str(tmp_path / "dst")
    assert reshard_checkpoint(src, dst, mesh4) == 9
    # crash-rerun idempotency: the destination is scratch until the
    # phase machine advances — a second run overwrites, same result
    assert reshard_checkpoint(src, dst, mesh4) == 9
    assert _files(src) == before            # the source is never touched
    assert sorted(os.listdir(dst)) == ["9"]
    restored = Checkpointer(dst).restore(_one_state())
    assert restored.step == 9
    for k, p in state.params.items():
        assert torch.equal(restored.params[k], p), k
        for m in ("mu", "nu"):
            assert torch.equal(restored.opt_state[m][k],
                               state.opt_state[m][k]), (m, k)
    # and back down: 4 -> 2 (the shrink-before-evict direction)
    dst2 = str(tmp_path / "dst2")
    assert reshard_checkpoint(dst, dst2, mesh2) == 9
    back = Checkpointer(dst2).restore(_one_state())
    assert torch.equal(back.params["w1"], state.params["w1"])
    # place_state: each rank's block under the one rule
    blocks = place_state(host_gather(state), mesh4)
    d = state_shardings(state, mesh4).params["w1"].index("fsdp")
    want = list(state.params["w1"].shape)
    want[d] //= 4
    assert list(blocks.params["w1"].shape) == want
    assert torch.equal(blocks.params["b1"], state.params["b1"])


def test_reshard_refuses_in_place_destination(tmp_path):
    with pytest.raises(ValueError, match="distinct") as got:
        reshard_checkpoint(str(tmp_path), str(tmp_path),
                           make_mesh({"fsdp": 2}, world=2))
    with pytest.raises(ValueError) as want:
        jrs.reshard_checkpoint(str(tmp_path), str(tmp_path), _jmesh(2))
    assert str(got.value) == str(want.value)


def test_reshard_without_checkpoint_raises(tmp_path):
    os.makedirs(tmp_path / "empty", exist_ok=True)
    with pytest.raises(ValueError, match="no checkpoint") as got:
        reshard_checkpoint(str(tmp_path / "empty"), str(tmp_path / "out"),
                           make_mesh({"fsdp": 2}, world=2))
    with pytest.raises(ValueError) as want:
        jrs.reshard_checkpoint(str(tmp_path / "empty"),
                               str(tmp_path / "jout"), _jmesh(2))
    assert str(got.value) == str(want.value)
    assert not os.path.exists(tmp_path / "out" / "0")


def test_host_gather_materializes_numpy(run):
    """Every leaf whole on the host (the port's leaves are CPU tensors);
    the job's sharded state gathers to the same leaves."""
    state = _one_state()
    host = host_gather(state)
    for k, p in host.params.items():
        assert p.device.type == "cpu" and p.shape == state.params[k].shape
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for m in ("mu", "nu") for t in host.opt_state[m].values())
    tree = host_gather({"params": dict(state.params)})
    assert all(torch.equal(tree["params"][k], p)
               for k, p in state.params.items())
    got = run["golden"]["host"]
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in state.params.items()}


def test_reshard_shapes_summary():
    for old, new in (({"Worker": 4}, {"Worker": 2}),
                     ({"Worker": 2}, {"Worker": 4}),
                     ({"Chief": 1, "Worker": 2}, {"Worker": 3})):
        assert reshard_shapes(old, new) == jrs.reshard_shapes(old, new)
    s = reshard_shapes({"Worker": 4}, {"Worker": 2})
    assert s["direction"] == "shrink"
    assert s["types"]["Worker"] == [4, 2]


# ------------------------------------------------- drain step exactness
def test_drain_saves_the_exact_inflight_step(run):
    """SIGTERM mid-run: the final checkpoint holds exactly the step the
    loop reached."""
    res = run["drain"]
    assert res["preempted"]
    assert res["steps_run"] == 8
    assert res["last_saved_step"] == 8
    assert Checkpointer(run["drain_dir"]).latest_step() == 8


# ------------------------------------------------------ loss trajectory
def test_loss_trajectory_resize_matches_fixed_size_golden(run):
    """train 6 steps @ fsdp=2 -> drain -> reshard -> resume @ fsdp=4 for
    6 more; the resumed trajectory matches a never-resized fsdp=4 run
    fed identical batches, and that run JAX's."""
    golden = run["golden"]["losses"]
    assert len(golden) == 12
    np.testing.assert_allclose(golden, run["jax"], rtol=2e-4, atol=1e-5)
    assert run["leg1"]["last_saved_step"] == 6
    np.testing.assert_allclose(run["leg1"]["losses"], golden[:6],
                               rtol=2e-4, atol=1e-5)
    assert run["resharded"] == 6
    leg2 = run["leg2"]
    assert leg2["resumed_from"] == 6          # exact step count preserved
    assert leg2["step"] == 12
    assert len(leg2["losses"]) == 6
    np.testing.assert_allclose(leg2["losses"], golden[6:], rtol=2e-4,
                               atol=1e-5)
