"""What a run loads and what the reference may import."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import core
from portbench.tests import tiny

PB = Path(__file__).resolve().parents[1]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tf_operator_tpu_torch_x", sys)
    assert "tf_operator_tpu" not in core.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "optax.contrib", sys)
    assert "optax" in core.forbidden_loaded()


def test_a_metric_that_loads_jax_leaves_no_result(tmp_path):
    """A per-layer reader, loaded while the result line is built, that
    imports a module named jax: the run exits 3 and prints no line."""
    root = tiny.make_root(tmp_path)
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    (root / "portbench" / "metrics" / "mfu.train.py").write_text(
        "import sys\nsys.path.insert(0, %r)\nimport jax  # noqa: F401\n\n"
        "def read(r):\n    return 1.0\n" % str(stub))
    code = ("import io, sys\nfrom contextlib import redirect_stdout\n"
            "sys.path.insert(0, %r)\nfrom pathlib import Path\n"
            "from portbench.harness import core\nbuf = io.StringIO()\n"
            "with redirect_stdout(buf):\n"
            "    rc = core.run(['--workload', 'tiny_dense.train', '--seed', "
            "'5', '--seconds', '0.2', '--trace', '1'], root=Path(%r), "
            "pb=Path(%r), device='cpu')\n"
            "print('RC', rc, 'OUT', repr(buf.getvalue()))\n"
            % (str(PB.parent), str(root), str(root / "portbench")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "RC 3 OUT ''", out.stdout
    assert "forbidden modules loaded in this process: ['jax']" in out.stderr


RUN_AND_LIST = """
import json, sys
sys.path.insert(0, {repo!r})
from pathlib import Path
from portbench.tests import tiny
root = Path({root!r})
for cell in ("tiny_dense.train", "tiny_moe.serve"):
    assert tiny.run_cell(root, cell, trace=1)["correct"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    root = tiny.make_root(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", RUN_AND_LIST.format(repo=str(PB.parent),
                                                   root=str(root))],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "tf_operator_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & set(core.FORBIDDEN), loaded & set(core.FORBIDDEN)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("tf_operator_tpu_torch",) + core.FORBIDDEN, name
        if top == "portbench":
            assert name.startswith("portbench.reference"), name


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.llama, portbench.reference.train, "
            "portbench.reference.serve, portbench.reference.precision; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(PB.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "tf_operator_tpu_torch" not in out.stdout
    assert "jax" not in out.stdout.split("'")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mistral_7b.train.s8192"])
def test_a_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, str(PB / "run.py"), "--workload", cell, "--seed",
         "4000000001", "--seconds", "1", "--trace", "0"],
        cwd=PB.parent, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line
