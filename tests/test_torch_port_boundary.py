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
    assert "tf_operator_tpu_torch.models.serving" in names
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
