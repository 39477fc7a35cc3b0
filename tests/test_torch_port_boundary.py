"""The port's boundaries: tf_operator_tpu_torch imports neither JAX nor the
JAX package, its entry points never drop to the CPU on their own, and
chip_smoke.py refuses to report without a card."""
import json
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import tf_operator_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    names = [tf_operator_tpu_torch.__name__]
    for info in pkgutil.walk_packages(tf_operator_tpu_torch.__path__,
                                      tf_operator_tpu_torch.__name__ + "."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax():
    """Each module of the port imports in a fresh interpreter where jax
    and flax cannot be imported at all, and leaves no module of the JAX
    package loaded."""
    names = _modules()
    for name in ("models.serving", "models.quant", "ops.flash_attention",
                 "ops.blocked_ce", "runtime.optim", "runtime.train",
                 "runtime.loop", "runtime.profiler", "train_llama",
                 "ops.zigzag", "ops.ring_attention", "ops.ring_flash",
                 "parallel.ring", "parallel.mesh", "engine.metrics",
                 "engine.tracing", "models.telemetry",
                 "models.speculative", "generate_llama", "serve_llama",
                 "data.loader", "data.tokenize", "models.convert",
                 "parallel.ep", "models.transformer",
                 "models.transformer_bridge", "models.flax_layers",
                 "models.resnet", "models.mnist", "models.vision_bridge",
                 "train_bert", "train_t5", "train_resnet", "train_mnist",
                 "train_dist_mnist", "models.lora", "runtime.bootstrap",
                 "parallel.dp", "parallel.tp", "parallel.comm",
                 "parallel.placement", "parallel.pp", "models.pipeline",
                 "models.pipeline_llama", "ops.ulysses", "models.reshard"):
        assert "tf_operator_tpu_torch." + name in names
    code = (
        "import importlib, json, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax'):\n"
        "    sys.modules[m] = None\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] == 'tf_operator_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a card")


def test_entry_points_default_to_cuda_and_raise_without_it(no_card):
    from tf_operator_tpu_torch.device import resolve_device
    from tf_operator_tpu_torch.models import bridge, llama, paging
    from tf_operator_tpu_torch.models.serving import serve_loop

    cfg = llama.tiny(n_layers=1)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.init_params(cfg, seed=0)
    params = bridge.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        llama.Llama.from_params(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        paging.init_block_pool(cfg, 4, 4)
    model = llama.Llama.from_params(cfg, params, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_loop(model, [[1, 2, 3]], max_new_tokens=2)
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_dense_entry_points_default_to_cuda_and_raise_without_it(no_card):
    """generate, speculative_generate, init_cache, dense serve_loop and
    the generate_llama and serve_llama entry points run on the card unless
    asked for the CPU, and raise without one."""
    from tf_operator_tpu_torch import generate_llama
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.models.serving import serve_loop
    from tf_operator_tpu_torch.models.speculative import speculative_generate

    cfg = llama.tiny(n_layers=1)
    model = llama.Llama.from_params(
        cfg, bridge.init_params(cfg, seed=0, device="cpu"), device="cpu")
    prompt = [[1, 2, 3]]
    with pytest.raises(RuntimeError, match="cuda"):
        llama.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        llama.generate(model, prompt, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        speculative_generate(model, model, prompt, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_loop(model, prompt, max_new_tokens=2, paged=False)
    with pytest.raises(RuntimeError, match="cuda"):
        generate_llama.main(["--smoke", "--prompt", "hi"])
    from tf_operator_tpu_torch import serve_llama
    with pytest.raises(RuntimeError, match="cuda"):
        serve_llama.main(["--smoke", "--prompt", "hi"])
    assert llama.generate(model, prompt, 2, device="cpu").shape == (1, 2)


def test_kernel_build_needs_nvcc(no_card, tmp_path, monkeypatch):
    """No nvcc, no kernel: the build raises instead of falling back."""
    from tf_operator_tpu_torch import kernels

    if shutil.which("nvcc"):
        pytest.skip("nvcc is on PATH")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_all()


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(no_card, tmp_path, where):
    """In the checkout and in a directory holding only chip_smoke.py, on
    a machine without a card: a non-zero exit and no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_training_entry_points_raise_without_a_card(no_card):
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import ring_flash as rf
    from tf_operator_tpu_torch.parallel.ring import LocalRing

    with pytest.raises(RuntimeError, match="cuda"):
        train_llama.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        train_llama.main(["--smoke", "--ring", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        next(train_llama.lm_batches(1, 8, 16, seed=0))
    with pytest.raises(RuntimeError, match="cuda"):
        train_llama.token_record_pipeline("unused", 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.init_params(llama.tiny(n_layers=1), seed=0, train=True)
    meta = torch.empty((1, 8, 2, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(meta, meta, meta, True)
    ring_fn = rf.make_ring_flash_attention_fn(LocalRing(2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ring_fn(meta, meta, meta, True)


def test_model_zoo_entry_points_raise_without_a_card(no_card, monkeypatch):
    """The BERT/T5 and vision CLIs, their data and weights run on the
    card unless asked for the CPU, and raise without one."""
    from tf_operator_tpu_torch import (
        train_bert, train_dist_mnist, train_mnist, train_resnet, train_t5)
    from tf_operator_tpu_torch.models import flax_layers, mnist, transformer
    from tf_operator_tpu_torch.models.transformer_bridge import (
        init_transformer_params)
    from tf_operator_tpu_torch.runtime.optim import SGD
    from tf_operator_tpu_torch.runtime.train import create_train_state

    for main in (train_bert.main, train_t5.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        train_resnet.main(["--image-size", "32", "--per-host-batch", "1",
                           "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        train_mnist.main(["--steps", "1"])
    monkeypatch.setenv("TF_CONFIG", '{"task": {"type": "worker"}}')
    with pytest.raises(RuntimeError, match="cuda"):
        train_dist_mnist.main(["--steps", "1"])
    for batches in (train_bert.mlm_batches(1, 8, 16, 0),
                    train_t5.lm_batches(1, 8, 16, 0),
                    train_resnet.synthetic_imagenet(1, 8, 0),
                    train_mnist.synthetic_mnist(1)):
        with pytest.raises(RuntimeError, match="cuda"):
            next(batches)
    with pytest.raises(RuntimeError, match="cuda"):
        init_transformer_params(transformer.tiny(), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        flax_layers.init_(mnist.MnistMLP(), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        create_train_state(mnist.MnistMLP(), torch.zeros((1, 28, 28, 1)),
                           SGD(0.1))


def test_flash_kernels_need_nvcc(no_card, tmp_path, monkeypatch):
    """The kernel path of each K2 wrapper raises when nvcc is missing,
    instead of running the plain version."""
    from tf_operator_tpu_torch import kernels
    from tf_operator_tpu_torch.ops import flash_attention as fa

    if shutil.which("nvcc"):
        pytest.skip("nvcc is on PATH")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(fa, "_lib", None)
    q = torch.zeros((1, 8, 2, 4))
    k = torch.zeros((1, 8, 1, 4))
    lse = torch.zeros((1, 2, 8))
    before = dict(fa.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa._launch_fwd(q, k, k, True, None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa._launch_dq(q, k, k, q, lse, lse, True, None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa._launch_dkv(q, k, k, q, lse, lse, True, None)
    assert fa.launches == before


def test_ring_kernels_need_nvcc(no_card, tmp_path, monkeypatch):
    """The kernel path of each K3 wrapper raises when nvcc is missing,
    instead of running the plain version."""
    from tf_operator_tpu_torch import kernels
    from tf_operator_tpu_torch.ops import ring_flash as rf

    if shutil.which("nvcc"):
        pytest.skip("nvcc is on PATH")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(rf, "_lib", None)
    monkeypatch.setattr(rf, "_on", lambda x: "cuda")
    q = torch.zeros((1, 8, 2, 4))
    k = torch.zeros((1, 8, 1, 4))
    stat = torch.zeros((1, 2, 8))
    offs = ((0, 4), (0, 4), True, None)
    before = dict(rf.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rf.ring_fwd(q, k, k, stat, stat.clone(), q.clone(), *offs)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rf.ring_dq(q, k, k, q, stat, stat, q.clone(), *offs)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rf.ring_dkv(q, k, k, q, stat, stat, k.clone(), k.clone(), *offs)
    assert rf.launches == before
