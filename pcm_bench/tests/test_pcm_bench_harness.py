"""The benchmark's files: every cell, configuration, traffic driver and
per-layer metric of BENCHMARK.json is found by name; BENCHMARK.json keeps
the contract's shape; nothing the runs load is JAX or the JAX package; the
CLI refuses to run without a card."""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

from pcm_bench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["pcm_bench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for cell in m.get("workloads", CELLS):  # each cell also reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    for cell in CELLS:  # setup_s, one more end-to-end metric and one per-layer metric
        assert len(harness.cell_metrics(BENCH, cell, False)) >= 2
        assert harness.cell_metrics(BENCH, cell, True)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    spec = harness.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert spec["config"] == entry["config"] and spec["traffic"] == entry["traffic"]
    assert (harness.HERE / "traffic" / f"{spec['traffic']}.py").is_file()
    conf = next(c for c in BENCH["configs"] if c["name"] == spec["config"])
    assert conf["file"] == f"pcm_bench/configs/{spec['config']}.json"
    assert spec["config_spec"]["reduced"] == conf["reduced"] == []
    limits = [v for v in spec["limits"].values() if v is not None]
    assert limits and all(v > 0 for v in limits)


@pytest.mark.parametrize("metric", PER_LAYER)
def test_every_per_layer_metric_has_a_reader(metric):
    read = harness.reader(metric)
    assert read({"kind": "none"}) is None  # nothing to read: nothing returned


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imported_roots(path)) & {"pcm_tpu_torch", "pcm_tpu", "jax", "jaxlib",
                                             "flax"}


def test_nothing_of_the_benchmark_imports_jax():
    for path in harness.HERE.rglob("*.py"):
        assert not set(_imported_roots(path)) & {"pcm_tpu", "jax", "jaxlib", "flax"}, path


def test_loaded_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pcm_tpu_torch_lookalike", sys)
    assert "pcm_tpu_torch_lookalike" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "pcm_tpu.fake", sys)
    assert "pcm_tpu.fake" in harness.loaded_forbidden()


def test_the_cli_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "pcm_bench.run", "--workload", CELLS[0],
                          "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
                         cwd=harness.REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_result_line_shape():
    run = harness.Run(end_to_end={"train_samples_per_s": 4.5, "peak_gib": 24.2,
                                  "setup_s": 40.0},
                      record={}, checks={"loss_gap": (0.001, 0.01)}, attempted=12, failed=0,
                      memory_peak_bytes=123)
    line = harness.result_line(BENCH, CELLS[0], run, False,
                               {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and set(line["metrics"]) == {
        "train_samples_per_s", "peak_gib", "setup_s"}
    assert json.loads(json.dumps(line)) == line
    run.checks["loss_gap"] = (0.02, 0.01)
    assert harness.result_line(BENCH, CELLS[0], run, False,
                               {"platform": "gpu", "kind": "x", "count": 1})["correct"] is False
