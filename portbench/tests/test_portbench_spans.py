"""The readers of the train step's phase spans (forward_ms.train,
backward_ms.train, optimizer_ms.train, head_ms.train) over whole tiny
train_lm runs on the CPU, through portbench's own entry."""
import pytest

from portbench.harness import core
from portbench.tests import tiny

TRAIN = "tiny_dense.train"
SPANS = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
         "head_ms.train")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("portbench"))


def _ms(line, name):
    return line["metrics"][name]["value"]


def test_a_traced_run_reports_the_four_phases(root):
    line = tiny.run_cell(root, TRAIN, trace=1)
    assert line["correct"], line
    assert set(SPANS) <= set(line["metrics"])
    assert all(line["metrics"][m]["unit"] == "ms" for m in SPANS)
    per_step_ms = 1e3 * line["device"]["window_s"] / line["attempted"]
    phases = sum(_ms(line, m) for m in SPANS[:3])
    assert 0 < phases <= per_step_ms
    # the head lies inside the forward and the backward
    assert 0 < _ms(line, "head_ms.train") < (
        _ms(line, "forward_ms.train") + _ms(line, "backward_ms.train"))


def test_an_untraced_run_reports_the_end_to_end_metrics_only(root):
    line = tiny.run_cell(root, TRAIN, trace=0)
    assert set(line["metrics"]) == {"setup_s", "train_tokens_per_s"}


def test_two_traced_runs_read_their_own_windows(root):
    """Each run's readers find exactly that run's window steps (a reader
    gives nothing when the count differs), so both report every phase."""
    lines = [tiny.run_cell(root, TRAIN, seed=seed, seconds=seconds, trace=1)
             for seed, seconds in ((3000000001, 0.3), (3000000002, 0.6))]
    for line in lines:
        assert line["correct"]
        assert set(SPANS) <= set(line["metrics"]), line["metrics"]


class _OldTracer:
    """A tracer without phase spans, as the program before them."""


@pytest.mark.parametrize("name", SPANS)
def test_a_program_without_phase_spans_gives_nothing(root, name,
                                                     monkeypatch):
    from tf_operator_tpu_torch.engine import tracing

    reader = core.Bench(root, root / "portbench").metric(name)
    readings = {"kind": "train_lm", "trace": object(),
                "work": {"steps": 3}}
    monkeypatch.setattr(tracing, "get_tracer", _OldTracer)
    assert reader.read(readings) is None
    monkeypatch.undo()
    assert reader.read(dict(readings, trace=None)) is None
    assert reader.read(dict(readings, kind="serve_lm")) is None
