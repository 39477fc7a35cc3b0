"""The port's Checkpointer (tf_operator_tpu_torch.runtime.train) against the
JAX package's orbax Checkpointer, and training that resumes from it
against the JAX package's run_training.

Exact: the steps kept under max_to_keep, latest_step, saves at or below
the newest step (skipped by both: orbax's should_save), restore with
nothing saved, restore_params' error; the port's resumed run against its
own unbroken run, bit for bit; an async save followed by an in-place
update restores the saved bits; a save cut before its rename leaves the
step before as the latest; a save's files, its directory and its rename
are fsynced before an older step is deleted.  Against JAX's run_training
on the tiny tied f32 llama with a save and a resume: resumed_from,
steps_run and last_saved_step equal, every step's loss within 1e-5
relative and the final parameters within 2e-4 (the tolerances of
tests/test_torch_train.py::test_lm_step_matches_jax_train_llama).  One
f32 step of the windowed tiny llama (window 16, S=64, flash attention as
mistral's recipe runs it) gives JAX's loss and gradients.
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_train import _jax_lm_loss, _jax_train_llama
from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.ops.flash_attention import flash_attention as jflash
from tf_operator_tpu.runtime import loop as jloop
from tf_operator_tpu.runtime.train import Checkpointer as JCheckpointer
from tf_operator_tpu.runtime.train import TrainState as JTrainState
from tf_operator_tpu_torch import train_llama as ttl
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.ops import blocked_ce as tce
from tf_operator_tpu_torch.ops.flash_attention import flash_attention
from tf_operator_tpu_torch.runtime import optim
from tf_operator_tpu_torch.runtime import train as ttrain
from tf_operator_tpu_torch.runtime.loop import run_training
from tf_operator_tpu_torch.runtime.train import Checkpointer, TrainState

SEQ = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: one torch thread (the count is put back after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ orbax's semantics
def _port_state(seed: int = 0) -> TrainState:
    torch.manual_seed(seed)
    model = torch.nn.Linear(4, 3)
    return TrainState.create(model, optim.Adafactor(1e-3))


def _jax_state() -> JTrainState:
    tx = optax.adafactor(1e-3)
    p = {"w": jnp.ones((4, 3)), "b": jnp.zeros((3,))}
    return JTrainState(step=jnp.zeros((), jnp.int32), params=p,
                       opt_state=tx.init(p), batch_stats={}, tx=tx)


@pytest.mark.parametrize("async_save", [False, True])
def test_step_semantics_match_orbax(tmp_path, async_save):
    """One save sequence through both: the steps kept under max_to_keep
    (the port's directory against orbax's all_steps), latest_step after
    every save (a step at or below the newest is skipped by both), and
    the empty-directory answers."""
    mine = Checkpointer(str(tmp_path / "port"), max_to_keep=3,
                        async_save=async_save)
    theirs = JCheckpointer(str(tmp_path / "jax"), max_to_keep=3,
                           async_save=async_save)
    assert mine.latest_step() is None is theirs.latest_step()
    ps, js = _port_state(), _jax_state()
    assert mine.restore(ps) is ps and theirs.restore(js) is js
    with pytest.raises(ValueError) as a:
        mine.restore_params()
    with pytest.raises(ValueError) as b:
        theirs.restore_params(js.params)
    assert str(a.value) == str(b.value) == "no checkpoint to restore params from"
    for step in (1, 2, 3, 4, 4, 2, 5, 7, 6):
        mine.save(step, ps)
        theirs.save(step, js)
        assert mine.latest_step() == theirs.latest_step()
    mine.wait_until_finished()
    theirs.wait_until_finished()
    assert mine.all_steps() == list(theirs.mngr.all_steps()) == [4, 5, 7]
    assert sorted(os.listdir(tmp_path / "port")) == ["4", "5", "7"]
    # a fresh manager over the directory finds the same steps
    again = Checkpointer(str(tmp_path / "port"), max_to_keep=3)
    assert again.latest_step() == 7 and not again.save(7, ps)


def test_restore_puts_back_params_opt_state_and_step(tmp_path):
    """Saved after two optimizer steps; restored into a fresh state from
    another seed: every parameter, adafactor's count and statistics and
    the step come back bit for bit, the parameters in place."""
    state = _port_state(0)
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(1))
    for _ in range(2):
        loss = (state.params["weight"] @ x.t()).square().mean()
        loss.backward()
        state.apply_gradients()
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.save(2, state)
    fresh = _port_state(1)
    before = {k: p for k, p in fresh.params.items()}
    out = ckpt.restore(fresh)
    assert out is fresh and fresh.step == 2
    assert fresh.opt_state["count"] == state.opt_state["count"] == 2
    for k, p in state.params.items():
        assert fresh.params[k] is before[k]  # the model's own tensor
        assert torch.equal(fresh.params[k], p)
    for part in ("v_row", "v_col", "v"):
        assert fresh.opt_state[part].keys() == state.opt_state[part].keys()
        for k, v in state.opt_state[part].items():
            assert torch.equal(fresh.opt_state[part][k], v)
    got = ckpt.restore_params({"weight": torch.empty(0, dtype=torch.bfloat16)})
    assert list(got) == ["weight"] and got["weight"].dtype == torch.bfloat16
    assert torch.equal(got["weight"], state.params["weight"].bfloat16())


def test_async_save_snapshots_before_an_in_place_step(tmp_path, monkeypatch):
    """The write is held until the parameters have been overwritten in
    place: the restore still gives the bits of the moment of save()."""
    state = _port_state(0)
    saved = {k: p.detach().clone() for k, p in state.params.items()}
    go = threading.Event()
    real_save = torch.save

    def held_save(obj, path):
        assert go.wait(timeout=30)
        real_save(obj, path)

    monkeypatch.setattr(torch, "save", held_save)
    ckpt = Checkpointer(str(tmp_path), async_save=True)
    assert ckpt.save(1, state)
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)
    go.set()
    ckpt.wait_until_finished()
    monkeypatch.setattr(torch, "save", real_save)
    fresh = ckpt.restore(_port_state(3))
    for k, v in saved.items():
        assert torch.equal(fresh.params[k], v)


@pytest.mark.parametrize("async_save", [False, True])
def test_a_cut_save_leaves_the_step_before(tmp_path, monkeypatch,
                                           async_save):
    """A save that dies between its temporary write and its rename (a
    SIGTERM, an OOM, a full disk) leaves no step behind: latest_step()
    is the last complete step, which restores; the next save of that
    step goes through."""
    state = _port_state(0)
    ckpt = Checkpointer(str(tmp_path), async_save=async_save)
    ckpt.save(1, state, wait=True)
    at_1 = state.params["weight"].detach().clone()

    def cut(src, dst):
        raise OSError("cut before the rename")

    monkeypatch.setattr(ttrain.os, "replace", cut)
    with torch.no_grad():
        state.params["weight"].add_(1.0)
    if async_save:
        ckpt.save(2, state)
        with pytest.raises(OSError, match="cut before the rename"):
            ckpt.wait_until_finished()
    else:
        with pytest.raises(OSError, match="cut before the rename"):
            ckpt.save(2, state)
    monkeypatch.undo()
    assert ckpt.latest_step() == 1 == Checkpointer(str(tmp_path)).latest_step()
    assert ckpt.all_steps() == [1]
    fresh = ckpt.restore(_port_state(4))
    assert torch.equal(fresh.params["weight"], at_1)
    assert ckpt.save(2, state, wait=True) and ckpt.latest_step() == 2


@pytest.mark.parametrize("async_save", [False, True])
def test_a_save_is_on_disk_before_older_steps_go(tmp_path, monkeypatch,
                                                 async_save):
    """Each file is fsynced after it is written, then the temporary
    directory, then the rename (the checkpoint directory); only after
    that is the step that max_to_keep drops deleted, so the loss of the
    node after a save never leaves a renamed step with unwritten files
    and no older step."""
    state = _port_state(0)
    ckpt = Checkpointer(str(tmp_path), max_to_keep=1, async_save=async_save)
    ckpt.save(1, state, wait=True)
    events = []
    fsync, replace, rmtree = os.fsync, os.replace, ttrain.shutil.rmtree

    def record_fsync(fd):
        events.append(("fsync", os.path.relpath(
            os.readlink(f"/proc/self/fd/{fd}"), tmp_path)))
        fsync(fd)

    def record_replace(src, dst):
        events.append(("replace", os.path.relpath(src, tmp_path),
                       os.path.relpath(dst, tmp_path)))
        replace(src, dst)

    def record_rmtree(path, **kw):
        events.append(("rmtree", os.path.relpath(path, tmp_path)))
        rmtree(path, **kw)

    monkeypatch.setattr(ttrain.os, "fsync", record_fsync)
    monkeypatch.setattr(ttrain.os, "replace", record_replace)
    monkeypatch.setattr(ttrain.shutil, "rmtree", record_rmtree)
    ckpt.save(2, state)
    ckpt.wait_until_finished()
    monkeypatch.undo()
    tmp = ".tmp-2"
    assert events == [("rmtree", tmp),  # a cut save's leftovers
                      ("fsync", f"{tmp}/{ttrain.PARAMS_FILE}"),
                      ("fsync", f"{tmp}/{ttrain.STATE_FILE}"),
                      ("fsync", tmp), ("replace", tmp, "2"),
                      ("fsync", "."), ("rmtree", "1")]
    assert ckpt.all_steps() == [2]


# --------------------------------------------- resume against run_training
def _tiny_pair(flash=False, **kw):
    """The tiny tied f32 llama on both sides, from one flax init; flash:
    with flash attention (the Pallas kernel in interpret mode on the JAX
    side, the plain versions on the port's)."""
    kw["tie_embeddings"] = True
    cfg_j = jl.tiny(dtype=jnp.float32, **kw,
                    **({"attention_fn": jflash} if flash else {}))
    cfg_t = tl.tiny(dtype=torch.float32, **kw,
                    **({"attention_fn": flash_attention} if flash else {}))
    model_j = jl.Llama(cfg_j)
    params = model_j.init(jax.random.PRNGKey(0),
                          jnp.zeros((2, SEQ), jnp.int32),
                          train=False)["params"]
    host = jax.tree.map(np.asarray, params)
    return model_j, params, cfg_t, host


def _port_state_of(cfg_t, host):
    model = tl.Llama.from_params(
        cfg_t, bridge.params_from_jax(cfg_t, host, train=True),
        device="cpu", train=True)
    return model, TrainState.create(model, optim.Adafactor(1e-3))


BATCHES = [np.random.default_rng(20 + i).integers(0, 256, (2, SEQ))
           .astype(np.int32) for i in range(4)]


@pytest.fixture(scope="module")
def jax_resume(tmp_path_factory):
    """JAX's run_training: 2 steps saved, a fresh state resumed to 4.
    -> (per-step losses, the resumed run's LoopResult, params)."""
    model_j, params, _, _ = _tiny_pair()
    jtl = _jax_train_llama()
    step_j = jtl.make_lm_step(model_j)
    losses = []

    def step(state, tokens):
        state, m = step_j(state, tokens)
        losses.append(float(m["loss"]))
        return state, m

    def fresh():
        tx = optax.adafactor(1e-3)
        p = jax.tree.map(jnp.array, params)
        return JTrainState(step=jnp.zeros((), jnp.int32), params=p,
                           opt_state=tx.init(p), batch_stats={}, tx=tx)

    ckpt = JCheckpointer(str(tmp_path_factory.mktemp("jax_ckpt")))
    first = jloop.run_training(
        fresh(), step, iter([(jnp.asarray(b),) for b in BATCHES[:2]]),
        num_steps=2, checkpointer=ckpt, save_interval_steps=2)
    second = jloop.run_training(
        fresh(), step, iter([(jnp.asarray(b),) for b in BATCHES[2:]]),
        num_steps=4, checkpointer=ckpt, save_interval_steps=2)
    return losses, first, second, jax.tree.map(np.asarray,
                                               second.state.params)


def _port_run(cfg_t, host, batches, num_steps, ckpt):
    model, state = _port_state_of(cfg_t, host)
    step_t = ttl.make_lm_step(model)
    losses = []

    def step(state, tokens):
        state, m = step_t(state, tokens)
        losses.append(float(m["loss"]))
        return state, m

    res = run_training(state, step,
                       iter([(torch.from_numpy(b),) for b in batches]),
                       num_steps=num_steps, checkpointer=ckpt,
                       save_interval_steps=2)
    return losses, res


def test_resume_matches_jax_run_training_and_the_unbroken_run(
        jax_resume, tmp_path):
    j_losses, j_first, j_second, j_params = jax_resume
    _, _, cfg_t, host = _tiny_pair()
    ckpt = Checkpointer(str(tmp_path), async_save=True)
    l1, first = _port_run(cfg_t, host, BATCHES[:2], 2, ckpt)
    l2, second = _port_run(cfg_t, host, BATCHES[2:], 4, ckpt)
    for mine, theirs in ((first, j_first), (second, j_second)):
        assert (mine.resumed_from, mine.steps_run, mine.last_saved_step,
                mine.preempted) == (theirs.resumed_from, theirs.steps_run,
                                    theirs.last_saved_step, theirs.preempted)
    assert second.resumed_from == 2 and second.state.step == 4
    np.testing.assert_allclose(l1 + l2, j_losses, rtol=1e-5)
    want = bridge.params_from_jax(cfg_t, j_params, train=True)
    for k, p in second.state.params.items():
        torch.testing.assert_close(p.detach(), want[k], rtol=2e-4,
                                   atol=2e-4, msg=k)
    # the port's own unbroken run: the same losses and parameters, bit
    # for bit
    lu, unbroken = _port_run(cfg_t, host, BATCHES, 4, None)
    assert lu == l1 + l2
    for k, p in unbroken.state.params.items():
        assert torch.equal(second.state.params[k], p), k
    assert ckpt.all_steps() == [2, 4]


# ------------------------------------------------- mistral's windowed step
def test_windowed_lm_step_matches_jax():
    """One f32 step of the tiny llama at window 16 over S=64 (the window
    cuts the sequence): the loss and every parameter's gradient equal
    JAX's make_lm_step with flash attention, and differ from the
    unwindowed model's."""
    model_j, params, cfg_t, host = _tiny_pair(flash=True, sliding_window=16)
    assert cfg_t.sliding_window < SEQ
    tokens = BATCHES[0]
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: _jax_lm_loss(model_j, p, tokens)))(params)
    model, state = _port_state_of(cfg_t, host)
    loss = tce.lm_blocked_loss(model, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    want = bridge.params_from_jax(cfg_t, jax.tree.map(np.asarray, grads_j),
                                  train=True)
    for k, p in model.named_parameters():
        torch.testing.assert_close(p.grad, want[k], rtol=2e-4, atol=2e-4,
                                   msg=k)
    # the step itself: JAX's first optimizer step gives the same loss
    state_t, m_t = ttl.make_lm_step(model)(state, torch.from_numpy(tokens))
    assert state_t.step == 1
    np.testing.assert_allclose(float(m_t["loss"]), float(loss_j), rtol=1e-5)
    full, _ = _port_state_of(tl.tiny(dtype=torch.float32, tie_embeddings=True,
                                     attention_fn=flash_attention), host)
    unwindowed = tce.lm_blocked_loss(full, torch.from_numpy(tokens)).item()
    assert abs(unwindowed - loss.item()) > 1e-4
