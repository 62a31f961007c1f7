"""Whole runs at tiny sizes on the CPU: the result line's shape, the check
coming out true on the sound program and false under each fault the cells
can have, the control, and what the benchmark loads."""

import json
import subprocess
import sys
import time

import pytest
import torch

from port_bench.harness import guard, runner
from port_bench.harness.cell import HERE, ROOT
from port_bench.tests.tiny import tiny_cell

SD_CELLS = ["sd_v1_512.txt2img_b4", "sd_v1_512.txt2img_b1"]
DPM_CELLS = ["cifar10_ddpm.fid_b1000", "cifar10_ddpm.sample_b64"]
CPU = torch.device("cpu")


def _run(name, trace=False, seconds=1.0):
    return runner.run(tiny_cell(name), 2 ** 31 + 7, seconds, trace, CPU, time.perf_counter(),
                      log=lambda *a, **k: None)


@pytest.mark.parametrize("name", SD_CELLS + DPM_CELLS)
def test_result_line(name):
    out = _run(name)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    json.dumps(out)
    e2e = set(out["metrics"])
    assert "setup_s" in e2e and len(e2e) == 2
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


@pytest.mark.parametrize("name", [SD_CELLS[1], DPM_CELLS[0]])
def test_traced_result_line(name):
    out = _run(name, trace=True)
    assert out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in out["breakdown"].values())
    assert "setup_s" not in out["metrics"]
    assert any(k.startswith("trajectory_ms.") for k in out["metrics"])


def _fault(monkeypatch, what):
    from dpm_solver_tpu_torch.models import CLIPTokenizer
    from dpm_solver_tpu_torch.pipelines import stable_diffusion
    from dpm_solver_tpu_torch.solver import sample

    original = sample.DPM_Solver.sample
    if what == "state_unchanged":       # the trajectory hands back its start
        monkeypatch.setattr(sample.DPM_Solver, "sample",
                            lambda self, x, *a, **k: x.clone() if not k.get(
                                "return_intermediate") else (x.clone(), None))
    elif what == "sample_altered":      # one answer altered where it is produced
        def altered(self, x, *a, **k):
            out = original(self, x, *a, **k)
            out = out.clone()
            out[0] = -out[0]
            return out
        monkeypatch.setattr(sample.DPM_Solver, "sample", altered)
    elif what == "image_altered":
        images = stable_diffusion._images

        def altered_images(x):
            out = images(x).clone()
            out[0] = 1.0 - out[0]
            return out
        monkeypatch.setattr(stable_diffusion, "_images", altered_images)
    elif what == "token_altered":
        call = CLIPTokenizer.__call__

        def altered_ids(self, prompts, max_length=77):
            ids = call(self, prompts, max_length)
            ids[0, 1] = (ids[0, 1] + 1) % 49406
            return ids
        monkeypatch.setattr(CLIPTokenizer, "__call__", altered_ids)


@pytest.mark.parametrize("name,fault", [
    (SD_CELLS[0], "state_unchanged"), (SD_CELLS[0], "image_altered"),
    (SD_CELLS[0], "token_altered"), (SD_CELLS[1], "state_unchanged"),
    (DPM_CELLS[0], "state_unchanged"), (DPM_CELLS[0], "sample_altered"),
    (DPM_CELLS[1], "state_unchanged"), (DPM_CELLS[1], "sample_altered")])
def test_faults_make_the_check_fail(monkeypatch, name, fault):
    _fault(monkeypatch, fault)
    out = _run(name)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name", DPM_CELLS)
def test_control_fails_at_tiny_size(name):
    from port_bench.control import readings

    cell = tiny_cell(name, batch=4)
    rows = readings(cell, [11, 12, 13], "fp8", 1, CPU, log=lambda *a, **k: None)
    sound = readings(cell, [11], None, 1, CPU, log=lambda *a, **k: None)
    assert all(r["numbers"]["sample_rel"] > 100 * sound[0]["numbers"]["sample_rel"] for r in rows)


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    assert {str(p.relative_to(ROOT)): guard.imports_forbidden(p) for p in files
            if guard.imports_forbidden(p)} == {}


def test_top_level_names_are_compared_whole():
    assert guard.loaded_forbidden(["dpm_solver_tpu_torch", "dpm_solver_tpu_torch.ops",
                                   "jaxtyping", "flax_like"]) == []
    assert guard.loaded_forbidden(["dpm_solver_tpu.ops", "jax.numpy", "flax"]) == [
        "dpm_solver_tpu", "flax", "jax"]


def test_a_run_loads_nothing_forbidden():
    code = ("import sys; sys.path.insert(0, %r); import port_bench.run, port_bench.control;"
            "import port_bench.harness.runner, port_bench.entries.sd_txt2img,"
            " port_bench.entries.dpm_sample, dpm_solver_tpu_torch.pipelines,"
            " dpm_solver_tpu_torch.models, dpm_solver_tpu_torch.solver;"
            "from port_bench.harness import guard; print(guard.loaded_forbidden())") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", SD_CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("name,variant", [(SD_CELLS[0], "w8a8_conv"), (SD_CELLS[1], "w8a8_conv"),
                                          (DPM_CELLS[0], "fp8"), (DPM_CELLS[1], "fp8")])
def test_control_fails_on_the_card(card, name, variant):
    """The control at the cell's own size, three seeds: each reads past a limit."""
    from port_bench.control import readings
    from port_bench.harness.cell import Cell, load_benchmark

    cell = Cell(load_benchmark(), name)
    rows = readings(cell, [101, 102, 103], variant, int(cell.traffic["check"]["requests"]),
                    card, log=lambda *a, **k: None)
    for r in rows:
        assert any(r["numbers"][k] > limit for k, limit in cell.limits.items()), r
