"""Each cell end to end at TINY size on the CPU, through `harness.run_cell`
(the path the CLI takes after its look for a card): the traffic driver, the
reference's comparison, every per-layer reader and the result line; and the
comparison seeing the control (the program's int8 frozen weights with its
int8 products) and each fault the cell can have (a step that returns its
state unchanged, half of the batch left out) as not correct; and the driver
refusing a family, a remat or a frozen precision that it does not know.
At TINY size the program runs in fp32, so it meets its reference to
round-off (readings under 1e-3 here); the TINY limits sit well above that."""

import json
import subprocess
import sys

import pytest
import torch

from pcm_bench import harness
from pcm_bench.traffic import train_cached
from tiny import TRAIN_CELLS, tiny_cell

TRAIN_LIMIT = 1e-2
SEED = 2 ** 31 + 12345  # the driver's seeds pass 32 signed bits
INFO = {"platform": "cpu", "kind": "cpu", "count": 1}
BENCH = harness.benchmark()


def _run(cell, tmp_path, trace=False, seconds=1.0, keys=None, **options):
    spec = dict(tiny_cell(cell, TRAIN_LIMIT), **(keys or {}))
    return harness.run_cell(cell, SEED, seconds, trace, torch.device("cpu"), str(tmp_path),
                            spec=spec, options=options)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_cell_runs_and_is_correct(cell, trace, tmp_path):
    run = _run(cell, tmp_path, trace)
    line = harness.result_line(BENCH, cell, run, trace, INFO)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    names = {m["name"] for m in harness.cell_metrics(BENCH, cell, trace)}
    got = set(line["metrics"])
    if trace:  # the device's metrics find no device operation on the CPU
        assert got == {n for n in names if "idle" not in n and "roofline" not in n}
        assert line["device"]["busy_s"] == 0.0 and line["device"]["window_s"] > 0
    else:
        assert got == names
    assert all(v["value"] >= 0 for v in line["metrics"].values())
    assert list(line)[-1] == "checks"
    assert json.loads(json.dumps(line)) == line


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "fused"])
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_training_control_and_faults_are_not_correct(cell, fault, tmp_path):
    if fault == "fused":  # the control: calibrate.py's control_fused
        run = _run(cell, tmp_path, keys={"frozen_dtype": "int8", "int8_matmul": "fused"})
    else:
        run = _run(cell, tmp_path, fault=fault)
    assert not harness.correct(run.checks), run.record["gaps"]
    if fault == "unchanged":  # a state left unchanged reads 1
        assert run.record["gaps"]["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("remat", ["full", "none", "dots_small+fa"])
def test_remat_reaches_the_bundle(remat):
    spec = tiny_cell(TRAIN_CELLS[1])
    spec["remat"] = remat
    bundle = train_cached._bundle(spec["config_spec"], spec, torch.float32)
    assert bundle.remat == (remat != "none")
    assert bundle.remat_policy == (None if remat in ("full", "none") else remat)


@pytest.mark.parametrize("bad", [
    {"remat": "dots_sometimes"}, {"frozen_dtype": "fp8"}, {"int8_matmul": "fused"},
    {"family": "sd15"}, {"remat_granularity": "block"}])
def test_unknown_values_are_refused(bad, tmp_path):
    spec = tiny_cell(TRAIN_CELLS[1])  # sd3: its builder takes no remat granularity
    if "family" in bad:
        spec["config_spec"] = dict(spec["config_spec"], **bad)
    else:
        spec.update(bad)
    with pytest.raises(ValueError):
        harness.run_cell(TRAIN_CELLS[1], SEED, 1.0, False, torch.device("cpu"), str(tmp_path),
                         spec=spec)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_the_cli_on_a_card(cell):
    """One short run of each cell as the driver runs it (on a CUDA card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "pcm_bench.run", "--workload", cell,
                          "--seed", str(SEED), "--seconds", "5", "--trace", "0"],
                         cwd=harness.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
