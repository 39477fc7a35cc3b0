"""The port's training runtime against the JAX package's: adafactor against
optax.adafactor, the llama3-recipe train step (examples/llama/train_llama.py
make_lm_step) on a tiny tied f32 llama with flash attention and remat,
gradient accumulation, and run_training's resume/preemption/metrics
behaviour (tests/test_loop.py's cases, with an in-memory checkpointer
double standing in for orbax).

Inputs come from numpy seeds and go to both sides.  Tolerances: the
optimizer 1e-6 relative (the same f32 chain, other reduction orders);
step-1 gradients 2e-4 (tests/test_ops.py's flash gradient tolerance);
losses 1e-5 relative.  Parameters are not compared element by element
after an update: adafactor's first step is close to sign(g), so an
element whose gradient is near zero can flip on summation-order noise.
"""
import copy
import importlib.util
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.ops.flash_attention import flash_attention as jflash
from tf_operator_tpu.runtime.train import TrainState as JTrainState
from tf_operator_tpu_torch import train_llama as ttl
from tf_operator_tpu_torch.engine.tracing import get_tracer
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.ops import blocked_ce as tce
from tf_operator_tpu_torch.ops.flash_attention import flash_attention
from tf_operator_tpu_torch.runtime import optim
from tf_operator_tpu_torch.runtime.loop import PreemptionGuard, run_training
from tf_operator_tpu_torch.runtime.profiler import (
    Profiler, StepProfile, device_memory_stats)
from tf_operator_tpu_torch.runtime.train import (
    TrainState, cross_entropy_loss, make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_train_llama():
    spec = importlib.util.spec_from_file_location(
        "_jax_train_llama", os.path.join(REPO, "examples/llama/train_llama.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- adafactor
SHAPES = {"vec": (300,), "factored": (256, 2, 128), "small": (64, 4, 32),
          "tie": (128, 3, 128), "wide": (130, 1, 140)}


def test_factored_dims_follow_numpy_argsort():
    assert optim.factored_dims((4096, 2, 8, 128)) == (3, 0)
    assert optim.factored_dims((256, 2, 128)) == (2, 0)
    assert optim.factored_dims((64, 4, 32)) is None
    assert optim.factored_dims((300,)) is None
    order = np.argsort((128, 3, 128))
    assert optim.factored_dims((128, 3, 128)) == (int(order[-2]),
                                                  int(order[-1]))


def test_adafactor_matches_optax_three_steps():
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    params["tiny"] = np.full((8,), 1e-4, np.float32)  # rms under 1e-3
    grads = [{k: (rng.standard_normal(p.shape) * 10 ** rng.uniform(-3, 1))
              .astype(np.float32) for k, p in params.items()}
             for _ in range(3)]
    tx = optax.adafactor(1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    update = jax.jit(tx.update)
    opt = optim.Adafactor(1e-3)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for g in grads:
        upd, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        ts = opt.update_(tp, ts)
        assert all(p.grad is None for p in tp.values())
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert ts["count"] == 3 == int(js[0].count)
    assert set(ts["v_row"]) == {"factored", "tie", "wide"}
    for k in ts["v_row"]:
        np.testing.assert_allclose(ts["v_row"][k].numpy(),
                                   np.asarray(js[0].v_row[k]), rtol=1e-6)
        np.testing.assert_allclose(ts["v_col"][k].numpy(),
                                   np.asarray(js[0].v_col[k]), rtol=1e-6)


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd_momentum", "sgd"])
def test_optimizer_matches_optax_three_steps(name):
    """AdamW, Adam and SGD (with and without momentum) as the JAX entry
    points build them (optax.adamw(1e-4, weight_decay=0.01) for BERT,
    adam(1e-3) for MNIST, sgd(0.1, momentum=0.9) for ResNet, sgd(0.01)
    for dist-mnist): parameters and optimizer state after each of three
    steps, 1e-6."""
    tx, opt = {
        "adamw": (optax.adamw(1e-4, weight_decay=0.01),
                  optim.AdamW(1e-4, weight_decay=0.01)),
        "adam": (optax.adam(1e-3), optim.Adam(1e-3)),
        "sgd_momentum": (optax.sgd(0.1, momentum=0.9),
                         optim.SGD(0.1, momentum=0.9)),
        "sgd": (optax.sgd(0.01), optim.SGD(0.01)),
    }[name]
    rng = np.random.default_rng(1)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(p.shape) * 10 ** rng.uniform(-3, 1))
              .astype(np.float32) for k, p in params.items()}
             for _ in range(3)]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    update = jax.jit(tx.update)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for g in grads:
        upd, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        ts = opt.update_(tp, ts)
        assert all(p.grad is None for p in tp.values())
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert ts["count"] == 3
    state = ({"mu": js[0].mu, "nu": js[0].nu} if name.startswith("adam")
             else {"trace": js[0].trace} if name == "sgd_momentum" else {})
    for slot, want in state.items():
        for k in params:
            ref = np.asarray(want[k])
            np.testing.assert_allclose(ts[slot][k].numpy(), ref, rtol=1e-6,
                                       atol=1e-12, err_msg=f"{slot} {k}")


# ------------------------------------------------------- the llama3 step
def _tiny_pair(seq):
    """The tiny tied f32 llama with flash attention and remat, on both
    sides, from one flax init."""
    cfg_j = jl.tiny(tie_embeddings=True, dtype=jnp.float32, remat=True,
                    attention_fn=jflash)
    cfg_t = tl.tiny(tie_embeddings=True, dtype=torch.float32, remat=True,
                    attention_fn=flash_attention)
    model_j = jl.Llama(cfg_j)
    params = model_j.init(jax.random.PRNGKey(0),
                          jnp.zeros((2, seq), jnp.int32), train=False)["params"]
    model_t = tl.Llama.from_params(
        cfg_t, bridge.params_from_jax(cfg_t, jax.tree.map(np.asarray, params),
                                      train=True),
        device="cpu", train=True)
    return model_j, params, model_t


def test_lm_step_matches_jax_train_llama():
    """Three steps of make_lm_step from the same params and batches: the
    step-1 gradients of every parameter, and the loss of every step."""
    seq = 64
    batches = [np.random.default_rng(10 + i).integers(0, 256, (2, seq))
               .astype(np.int32) for i in range(3)]
    model_j, params, model_t = _tiny_pair(seq)

    grads_j = jax.jit(jax.grad(
        lambda p: _jax_lm_loss(model_j, p, batches[0])))(params)
    want = bridge.params_from_jax(model_t.cfg,
                                  jax.tree.map(np.asarray, grads_j),
                                  train=True)
    tce.lm_blocked_loss(model_t, torch.from_numpy(batches[0])).backward()
    for k, p in model_t.named_parameters():
        torch.testing.assert_close(p.grad, want[k], rtol=2e-4, atol=2e-4,
                                   msg=k)
        p.grad = None

    jtl = _jax_train_llama()
    tx = optax.adafactor(1e-3)
    state_j = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params), batch_stats={}, tx=tx)
    step_j = jtl.make_lm_step(model_j)
    state_t = TrainState.create(model_t, optim.Adafactor(1e-3))
    step_t = ttl.make_lm_step(model_t)
    for tokens in batches:
        state_j, m_j = step_j(state_j, jnp.asarray(tokens))
        state_t, m_t = step_t(state_t, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5)
    assert state_t.step == 3 == int(state_j.step)


def _jax_lm_loss(model, params, tokens):
    from tf_operator_tpu.ops.blocked_ce import lm_blocked_loss

    return lm_blocked_loss(model, params, jnp.asarray(tokens))


def test_flash_and_einsum_llama_agree():
    """The port's full-sequence forward through flash attention equals
    the JAX forward's logits and the port's einsum default (which repeats
    kv to H heads)."""
    model_j, params, model_t = _tiny_pair(32)
    tokens = np.random.default_rng(4).integers(0, 256, (2, 32))
    want = np.asarray(model_j.apply({"params": params}, jnp.asarray(tokens)))
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        got = model_t(t)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    plain = tl.Llama.from_params(
        tl.tiny(tie_embeddings=True, dtype=torch.float32),
        dict(model_t.state_dict()), device="cpu")
    with torch.no_grad():
        torch.testing.assert_close(plain(t), got, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ train step
class _Sgd:
    """An optimizer double: p -= lr * grad, gradients dropped."""

    def __init__(self, lr=0.1):
        self.lr = lr

    def init(self, params):
        return {"count": 0}

    @torch.no_grad()
    def update_(self, params, state):
        for p in params.values():
            p.sub_(self.lr * p.grad)
            p.grad = None
        return {"count": state["count"] + 1}


def _linear():
    torch.manual_seed(0)
    return torch.nn.Linear(8, 4)


def _data(n=8, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 8), generator=g), torch.arange(n) % 4


def test_accum_steps_equals_one_full_batch():
    x, y = _data()
    out = []
    for accum in (1, 2):
        model = _linear()
        state = TrainState.create(model, _Sgd())
        state, metrics = make_train_step(model, accum_steps=accum)(state, x, y)
        out.append((metrics, {k: p.detach().clone()
                              for k, p in state.params.items()}))
    (m1, p1), (m2, p2) = out
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(m2["accuracy"], m1["accuracy"])
    for k in p1:
        torch.testing.assert_close(p2[k], p1[k], rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(_linear(), accum_steps=3)(
            TrainState.create(_linear(), _Sgd()), x, y)


def test_cross_entropy_loss_matches_optax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (3, 5))
    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.asarray(labels)).mean()
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ---------------------------------------------------------- run_training
class _MemCheckpointer:
    """A checkpointer double keeping copies in a dict shared between
    instances (a 'recreated pod' finds the saves); refuses duplicate
    steps as orbax does."""

    def __init__(self, store):
        self.store = store

    def save(self, step, state, wait=False):
        if step in self.store:
            raise ValueError(f"step {step} already saved")
        self.store[step] = copy.deepcopy(
            (state.step, {k: p.detach() for k, p in state.params.items()},
             state.opt_state))

    def latest_step(self):
        return max(self.store) if self.store else None

    def restore(self, state):
        step, params, opt_state = copy.deepcopy(self.store[self.latest_step()])
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(params[k])
        state.step, state.opt_state = step, opt_state
        return state

    def wait_until_finished(self):
        pass


def _state():
    model = _linear()
    return TrainState.create(model, _Sgd()), make_train_step(model)


def _batches(n=10_000):
    x, y = _data()
    for _ in range(n):
        yield (x, y)


def test_loop_runs_to_num_steps():
    state, step = _state()
    res = run_training(state, step, _batches(), num_steps=7)
    assert res.steps_run == 7 and res.state.step == 7
    assert not res.preempted and res.resumed_from is None
    assert "loss" in res.last_metrics and res.last_saved_step is None


def test_checkpoint_resume_continues_where_left_off():
    store = {}
    state, step = _state()
    res1 = run_training(state, step, _batches(), num_steps=5,
                        checkpointer=_MemCheckpointer(store),
                        save_interval_steps=2)
    assert res1.state.step == 5 and sorted(store) == [2, 4, 5]
    state, step = _state()
    res2 = run_training(state, step, _batches(), num_steps=8,
                        checkpointer=_MemCheckpointer(store),
                        save_interval_steps=2)
    assert res2.resumed_from == 5 and res2.steps_run == 3
    assert res2.state.step == 8 and res2.last_saved_step == 8


def test_resume_params_match_uninterrupted_run():
    state, step = _state()
    full = run_training(state, step, _batches(), num_steps=6)
    store = {}
    state, step = _state()
    run_training(state, step, _batches(), num_steps=3,
                 checkpointer=_MemCheckpointer(store))
    state, step = _state()
    resumed = run_training(state, step, _batches(), num_steps=6,
                           checkpointer=_MemCheckpointer(store))
    for k, p in full.state.params.items():
        torch.testing.assert_close(resumed.state.params[k], p, rtol=0,
                                   atol=1e-6)


def test_preemption_triggers_final_save():
    store = {}
    guard = PreemptionGuard(install=False)
    lines = []

    def preempting():
        for i, b in enumerate(_batches()):
            if i == 3:
                guard.trigger()
            yield b

    state, step = _state()
    res = run_training(state, step, preempting(), num_steps=100,
                       checkpointer=_MemCheckpointer(store),
                       save_interval_steps=50, guard=guard,
                       metrics_sink=lines.append)
    assert res.preempted and res.steps_run == 4
    assert _MemCheckpointer(store).latest_step() == 4 == res.last_saved_step


def test_preemption_on_interval_boundary_no_double_save():
    store = {}
    guard = PreemptionGuard(install=False)

    def batches():
        for i, b in enumerate(_batches()):
            if i == 1:
                guard.trigger()
            yield b

    state, step = _state()
    res = run_training(state, step, batches(), num_steps=100,
                       checkpointer=_MemCheckpointer(store),
                       save_interval_steps=2, guard=guard)
    assert res.preempted and sorted(store) == [2]


def test_no_resave_when_resume_finds_run_complete():
    store = {}
    state, step = _state()
    run_training(state, step, _batches(), num_steps=3,
                 checkpointer=_MemCheckpointer(store))
    state, step = _state()
    res = run_training(state, step, _batches(), num_steps=3,
                       checkpointer=_MemCheckpointer(store))
    assert res.steps_run == 0 and res.resumed_from == 3


def test_loop_emits_metrics_lines():
    lines = []
    state, step = _state()
    res = run_training(state, step, _batches(), num_steps=6,
                       log_interval_steps=2, profiler=Profiler(batch_size=2),
                       metrics_sink=lines.append)
    assert len(lines) == 3
    payload = json.loads(lines[-1])
    assert payload["step"] == 6 and payload["steps_per_sec"] > 0
    assert payload["examples_per_sec"] > 0 and "loss" in payload
    assert 0 < res.goodput["goodput"] <= 1


def test_step_profile_stats():
    p = StepProfile(window=10)
    for _ in range(5):
        p.tick()
    assert p.steps_recorded == 4 and p.steps_per_sec() > 0
    assert p.percentile(99) >= p.percentile(50) >= 0
    p.reset()
    assert p.steps_recorded == 0 and p.steps_per_sec() == 0.0


def test_profiler_trace_window_writes_a_trace(tmp_path):
    """The window's trace holds the train step's phase ranges, one
    `train_step` and one `train_step.optimizer` a step, and the tracer's
    spans of that capture are steps 1 and 2."""
    prof = Profiler(trace_dir=str(tmp_path), trace_start_step=1,
                    trace_num_steps=2)
    state, step = _state()
    held = get_tracer().traces()
    run_training(state, step, _batches(), num_steps=5, profiler=prof)
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1
    names = [e.get("name") for e in json.loads(traces[0].read_text())
             ["traceEvents"] if e.get("cat") == "user_annotation"]
    assert names.count("train_step") == 2
    assert names.count("train_step.optimizer") == 2
    seen = {id(r) for r in held}
    roots = [r for r in get_tracer().traces()
             if r.name == "train_step" and id(r) not in seen]
    assert [r.attrs["step"] for r in roots] == [1, 2]
    assert get_tracer().phase_totals()["train_step"].count == 2


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only answer")
    assert device_memory_stats() == {}


def test_train_llama_smoke_on_cpu(capsys):
    """The CPU smoke run trains, and leaves the process's SIGTERM handler
    as it found it."""
    before = signal.getsignal(signal.SIGTERM)
    assert ttl.main(["--smoke", "--device", "cpu", "--steps", "3",
                     "--per-host-batch", "2", "--seq-len", "16"]) == 0
    out = capsys.readouterr().out
    assert "complete: steps=3" in out
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--ep", "2"],
                                  ["--ring", "--tp", "2"],
                                  ["--model", "mixtral", "--steps", "2",
                                   "--per-host-batch", "1",
                                   "--seq-len", "16"]])
def test_train_llama_refuses_what_is_not_ported(flag, capsys):
    """train_llama refuses nothing now.  --model mixtral trains, as the
    JAX script does, and so do --tp 2 and --ring --tp 2 in one process:
    the mesh {"tp": 1}, as JAX's local_mesh_axes clamps it, the ring one
    member (tests/test_torch_sharded.py and test_torch_ring_tp.py train
    tp 2 in a job); --ep on a dense model exits with the JAX script's
    message (tests/test_torch_ep.py trains --ep 2 in a job)."""
    argv = ["--smoke", "--device", "cpu"] + flag
    if flag == ["--ep", "2"]:
        with pytest.raises(SystemExit, match="--ep only applies to "
                           "--model=mixtral"):
            ttl.main(argv)
        return
    if "--tp" in flag:
        assert ttl.main(argv + ["--steps", "2", "--per-host-batch", "1",
                                "--seq-len", "16"]) == 0
        out = capsys.readouterr().out
        assert "'tp': 1}" in out and "complete: steps=2" in out
        assert ("ring attention over LocalRing(1)" in out) == (
            "--ring" in flag)
        return
    assert ttl.main(argv) == 0
    assert "complete: steps=2" in capsys.readouterr().out
