"""BENCHMARK.json against the benchmark's contract, and every name in it
found by its file under portbench/."""
import json
import re
from pathlib import Path

import pytest

from portbench.harness import core

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(MANIFEST) == KEYS
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", MANIFEST["configs"] + MANIFEST["workloads"]
                         + MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            v = entry[key]
            assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v


def test_names_are_unique():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[key]]
        assert len(names) == len(set(names)), key
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_metric_entries():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        # every cell the metric lists reports the metric it moves
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in cells:
        reported = [m for m in MANIFEST["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])


def test_rooflines_and_mfu_named_so():
    for m in MANIFEST["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    moved = {m["moves"] for m in MANIFEST["per_layer"]
             if m["name"].split(".")[0].endswith("_roofline")}
    assert moved <= {m["moves"] for m in MANIFEST["per_layer"]
                     if "mfu" in m["name"]}


def test_configs_cells_and_files():
    cfgs = {c["name"]: c for c in MANIFEST["configs"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert all(NAME.match(k) for k in c["reduced"])
    used = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in cfgs
        used.add(w["config"])
        cell = json.loads((ROOT / "portbench" / "workloads"
                           / f"{w['name']}.json").read_text())
        assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
        assert all(v is not None for v in cell["limits"].values())
        traffic = json.loads((ROOT / "portbench" / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench" / "kinds" / f"{traffic['kind']}.py").exists()
    assert used == set(cfgs)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_readers_and_kernel_classes_found_by_name():
    bench = core.Bench(ROOT)
    for m in MANIFEST["per_layer"]:
        assert callable(bench.metric(m["name"]).read)
    classes = bench.kernel_classes()
    assert {"flash_attention", "paged_attention"} <= set(classes)
    for mod in classes.values():
        assert mod.PATTERNS and callable(mod.bound)
    # the program's kernels come before the library's patterns
    assert [c for c, m in classes.items() if m.SOURCE is None] == \
        list(classes)[-1:]


def test_files_under_paths_are_named_from_names():
    ok = re.compile(r"^[A-Za-z0-9_.\-/]+$")
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts or ".cache" in p.parts:
            continue
        assert ok.match(str(p.relative_to(ROOT))), p
