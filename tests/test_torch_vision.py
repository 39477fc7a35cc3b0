"""The port's vision models and their training runtime (models/resnet.py,
models/mnist.py, models/flax_layers.py, models/vision_bridge.py,
runtime/train.create_train_state / make_train_step with batch
statistics / make_eval_step, the Checkpointer with batch stats) against
the JAX package, on the CPU at small f32 sizes.

The same numpy images and variables (in the flax tree's structure, drawn
with numpy) go to both sides, through the bridge.  ResNet runs with
stage sizes [1, 1] and width 8 at an even 32² input, where flax's "SAME"
pads the stride-2 conv2 and max pool on the high side only, and at an
odd 33², in training and eval mode and through two SGD-momentum steps
with accum_steps 1 and 2 (the running stats chained micro-batch after
micro-batch).  Tolerances (f32): logits 1e-4 by relative error norm;
batch stats 1e-5; gradients and parameter updates 1e-3 by relative
error norm; losses 1e-5 relative; the bf16 forward 2e-2 + 2e-2·|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models import mnist as jm
from tf_operator_tpu.models import resnet as jr
from tf_operator_tpu.runtime import train as jtr
from tf_operator_tpu_torch.models import flax_layers as fl
from tf_operator_tpu_torch.models import mnist as tm
from tf_operator_tpu_torch.models import resnet as tr
from tf_operator_tpu_torch.models import vision_bridge as vb
from tf_operator_tpu_torch.runtime import optim
from tf_operator_tpu_torch.runtime.train import (
    Checkpointer, TrainState, create_train_state, make_eval_step,
    make_train_step)

RESNET = dict(stage_sizes=[1, 1], width=8, num_classes=10)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one torch thread (the count is put back after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _variables(model_j, x):
    """Variables in the flax tree's structure (jax.eval_shape, no
    compile) drawn with numpy: kernels lecun over their fan-in, BatchNorm
    scales and biases near 1 and 0 (bn3's too, so the residual branch
    counts), running stats mean 0.1·n, var 1 + 0.1·|n|."""
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

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _images(size: int, b: int = 4, c: int = 3, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, size, size, c)).astype(np.float32),
            rng.integers(0, 10, (b,)).astype(np.int32))


def _resnet_pair(size: int, dtype=None):
    model_j = jr.ResNet(dtype=dtype or jnp.float32, **RESNET)
    x, y = _images(size)
    var = _variables(model_j, x)
    model_t = tr.ResNet(dtype=torch.bfloat16 if dtype else torch.float32,
                        **RESNET)
    model_t.load_state_dict(vb.resnet_params_from_jax(var))
    return model_j, var, model_t, x, y


@pytest.fixture(scope="module", params=[32, 33])
def resnet(request):
    """The JAX references at one input size: the train-mode logits and
    batch stats, the eval-mode logits under the new stats, the loss
    gradients."""
    size = request.param
    model_j, var, model_t, x, y = _resnet_pair(size)

    def loss_j(p):
        out, upd = model_j.apply({"params": p, "batch_stats":
                                  var["batch_stats"]}, jnp.asarray(x),
                                 train=True, mutable=["batch_stats"])
        return jtr.cross_entropy_loss(out, jnp.asarray(y)), (out, upd)

    (_, (logits, upd)), grads = jax.jit(jax.value_and_grad(
        loss_j, has_aux=True))(var["params"])
    evaluated = jax.jit(lambda v: model_j.apply(v, jnp.asarray(x),
                                                train=False))(
        {"params": var["params"], "batch_stats": upd["batch_stats"]})
    return dict(size=size, model_j=model_j, var=var, model_t=model_t, x=x,
                y=y, logits=logits,
                stats=vb.resnet_params_from_jax(
                    {"batch_stats": jax.tree.map(np.asarray,
                                                 upd["batch_stats"])}),
                eval=evaluated,
                grads=vb.resnet_params_from_jax(
                    {"params": jax.tree.map(np.asarray, grads)}))


def test_same_pads_are_flax_s():
    """flax's "SAME": a 3x3 stride-2 window over an even size pads only
    the high side; over an odd size, both; stride 1 pads k // 2."""
    assert fl.same_pads(32, 3, 2) == (0, 1)
    assert fl.same_pads(33, 3, 2) == (1, 1)
    assert fl.same_pads(16, 1, 2) == (0, 0)
    assert fl.same_pads(28, 5, 1) == (2, 2)
    assert fl.same_pads(112, 3, 2) == (0, 1)


def test_resnet_train_forward_and_batch_stats(resnet):
    model_t = resnet["model_t"]
    model_t.load_state_dict(vb.resnet_params_from_jax(resnet["var"]))
    model_t.train()
    with torch.no_grad():
        logits = model_t(torch.from_numpy(resnet["x"]))
    assert logits.dtype == torch.float32
    assert rel(logits, resnet["logits"]) <= 1e-4
    buffers = dict(model_t.named_buffers())
    assert set(buffers) == set(resnet["stats"])
    for name, want in resnet["stats"].items():
        torch.testing.assert_close(buffers[name], want, rtol=0, atol=1e-5,
                                   msg=name)
    model_t.eval()
    with torch.no_grad():
        evaluated = model_t(torch.from_numpy(resnet["x"]))
    assert rel(evaluated, resnet["eval"]) <= 1e-4


def test_resnet_grads_match_jax(resnet):
    model_t = resnet["model_t"]
    model_t.load_state_dict(vb.resnet_params_from_jax(resnet["var"]))
    model_t.train()
    logits = model_t(torch.from_numpy(resnet["x"]))
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(resnet["y"]).long()).backward()
    for name, p in model_t.named_parameters():
        assert rel(p.grad, resnet["grads"][name]) <= 1e-3, name
        p.grad = None


@pytest.mark.parametrize("accum", [1, 2])
def test_resnet_train_steps_match_jax(accum):
    """Two steps of make_train_step with sgd(0.1, momentum=0.9) against
    the JAX step (accum_steps 2: a scan over micro-batches that chains
    the running stats): losses, accuracy, parameter updates, batch
    stats."""
    model_j, var, model_t, x, y = _resnet_pair(32)
    tx = optax.sgd(0.1, momentum=0.9)
    state_j = jtr.TrainState(step=jnp.zeros((), jnp.int32),
                             params=var["params"],
                             opt_state=tx.init(var["params"]),
                             batch_stats=var["batch_stats"], tx=tx)
    step_j = jtr.make_train_step(model_j, accum_steps=accum)
    state_t = TrainState.create(model_t, optim.SGD(0.1, momentum=0.9))
    step_t = make_train_step(model_t, accum_steps=accum)
    start = {k: p.detach().clone() for k, p in state_t.params.items()}
    for i in range(2):
        xi, yi = _images(32, seed=10 + i)
        state_j, m_j = step_j(state_j, jnp.asarray(xi), jnp.asarray(yi))
        state_t, m_t = step_t(state_t, torch.from_numpy(xi),
                              torch.from_numpy(yi))
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m_t["accuracy"]),
                                   float(m_j["accuracy"]))
    want = vb.resnet_params_from_jax(jax.tree.map(np.asarray, {
        "params": state_j.params, "batch_stats": state_j.batch_stats}))
    for name, p in state_t.params.items():
        assert rel(p - start[name], want[name] - start[name]) <= 1e-3, name
    assert set(state_t.batch_stats) == {k for k in want
                                        if k.endswith((".mean", ".var"))}
    for name, b in state_t.batch_stats.items():
        torch.testing.assert_close(b, want[name], rtol=0, atol=1e-5,
                                   msg=name)
    assert state_t.step == 2 == int(state_j.step)


@pytest.mark.parametrize("name", ["cnn", "mlp"])
def test_mnist_models_match_jax(name):
    """MnistCNN (adam) and MnistMLP (sgd): logits, then two train steps:
    losses and parameter updates."""
    model_j = {"cnn": jm.MnistCNN, "mlp": jm.MnistMLP}[name](
        dtype=jnp.float32)
    model_t = {"cnn": tm.MnistCNN, "mlp": tm.MnistMLP}[name](
        dtype=torch.float32)
    x, _ = _images(28, c=1, seed=3)
    var = _variables(model_j, x)
    model_t.load_state_dict(vb.mnist_params_from_jax(var))
    want = jax.jit(lambda v: model_j.apply(v, jnp.asarray(x)))(var)
    with torch.no_grad():
        assert rel(model_t(torch.from_numpy(x)), want) <= 1e-4
    tx, opt = ((optax.adam(1e-3), optim.Adam(1e-3)) if name == "cnn"
               else (optax.sgd(0.01), optim.SGD(0.01)))
    state_j = jtr.TrainState(step=jnp.zeros((), jnp.int32),
                             params=var["params"],
                             opt_state=tx.init(var["params"]),
                             batch_stats={}, tx=tx)
    step_j = jtr.make_train_step(model_j)
    state_t = TrainState.create(model_t, opt)
    step_t = make_train_step(model_t)
    start = {k: p.detach().clone() for k, p in state_t.params.items()}
    for i in range(2):
        xi, yi = _images(28, c=1, seed=20 + i)
        state_j, m_j = step_j(state_j, jnp.asarray(xi), jnp.asarray(yi))
        state_t, m_t = step_t(state_t, torch.from_numpy(xi),
                              torch.from_numpy(yi))
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5)
    got = vb.mnist_params_from_jax(
        {"params": jax.tree.map(np.asarray, state_j.params)})
    for k, p in state_t.params.items():
        assert rel(p - start[k], got[k] - start[k]) <= 1e-3, k
    assert state_t.batch_stats == {}


def test_bf16_forward_matches_jax():
    """The bf16 compute path (bf16 convolutions and products, f32
    statistics and head) in training mode, within 2e-2 + 2e-2·|ref|."""
    model_j, var, model_t, x, _ = _resnet_pair(32, dtype=jnp.bfloat16)
    want, _ = jax.jit(lambda v: model_j.apply(
        v, jnp.asarray(x), train=True, mutable=["batch_stats"]))(var)
    with torch.no_grad():
        got = model_t(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


def test_create_train_state_eval_step_and_checkpoint(tmp_path):
    """create_train_state draws a seeded ResNet whose batch stats are the
    model's buffers; make_eval_step equals the JAX eval step on the same
    variables; a checkpoint restores the running stats in place."""
    model_t = tr.ResNet(dtype=torch.float32, **RESNET)
    x, y = _images(32)
    state = create_train_state(model_t, torch.from_numpy(x),
                               optim.SGD(0.1, momentum=0.9), seed=3,
                               device="cpu")
    again = create_train_state(tr.ResNet(dtype=torch.float32, **RESNET),
                               torch.from_numpy(x), optim.SGD(0.1), seed=3,
                               device="cpu")
    assert all(torch.equal(p, again.params[k])
               for k, p in state.params.items())
    buffers = dict(model_t.named_buffers())
    assert set(state.batch_stats) == set(buffers) and all(
        state.batch_stats[k] is b for k, b in buffers.items())
    assert float(model_t.stage1_block1.bn3.scale.detach().abs().max()) == 0.0
    assert model_t.training

    step = make_train_step(model_t)
    state, _ = step(state, torch.from_numpy(x), torch.from_numpy(y))
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.save(1, state)
    saved = {k: b.clone() for k, b in state.batch_stats.items()}
    metrics = make_eval_step(model_t)(state, torch.from_numpy(x),
                                      torch.from_numpy(y))
    assert model_t.training

    model_j = jr.ResNet(dtype=jnp.float32, **RESNET)
    var = {"params": {}, "batch_stats": {}}
    for coll, tree in (("params", state.params),
                       ("batch_stats", state.batch_stats)):
        for name, t in tree.items():
            a = t.detach().numpy()
            if name.endswith(".weight"):
                name, a = name[:-len("weight")] + "kernel", a.transpose(
                    2, 3, 1, 0)
            *path, last = name.split(".")
            node = var[coll]
            for p in path:
                node = node.setdefault(p, {})
            node[last] = a
    want = jtr.make_eval_step(model_j)(
        jtr.TrainState(step=jnp.zeros((), jnp.int32), params=var["params"],
                       opt_state=None, batch_stats=var["batch_stats"],
                       tx=optax.sgd(0.1)),
        jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(metrics["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["accuracy"]),
                               float(want["accuracy"]))

    state, _ = step(state, torch.from_numpy(x), torch.from_numpy(y))
    assert not all(torch.equal(b, saved[k])
                   for k, b in state.batch_stats.items())
    state = ckpt.restore(state)
    assert state.step == 1
    for k, b in buffers.items():
        assert state.batch_stats[k] is b
        torch.testing.assert_close(b, saved[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="has_batch_stats=False"):
        make_train_step(model_t, has_batch_stats=False)
