"""The harness: the result line's shape, a run with no card, a checkout
without the program, cells found from new files alone, and the import
check on whole top-level names."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from sdrbench import run

from .conftest import ROOT, TINY

torch.set_num_threads(1)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _env(**extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT), **extra)
    return env


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(trace):
    res = run.run_cell(ROOT, "spectrum.capture", 77, 0.3, trace, device=torch.device("cpu"),
                       overrides=TINY)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(res["correct"], bool) and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in BENCH[kind]}
    for name, m in res["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # a CPU run reads no device metric
        assert set(res["metrics"]) == {"call_host_us"}
    else:
        assert set(res["metrics"]) == {"input_msps", "setup_s"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_no_card_exits_nonzero_and_prints_nothing():
    done = subprocess.run([sys.executable, "-m", "sdrbench.run", "--workload",
                           "spectrum.capture", "--seed", "3", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert done.stdout.strip() == ""


def test_checkout_of_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "sdrbench", tmp_path / "sdrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run([sys.executable, "-m", "sdrbench.run", "--workload", "spectrum.capture",
                           "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
                          text=True, timeout=120)
    assert done.returncode != 0
    assert done.stdout.strip() == ""


NEW_CELL = r"""
import json, sys, torch
from pathlib import Path
from sdrbench import run
res = run.run_cell(Path("."), "spectrum.tiny", 5, 0.2, False, device=torch.device("cpu"),
                   overrides={"capture_samples": 8192 * 2 * 4})
print(json.dumps(res))
"""


def test_a_cell_added_as_new_files_only(tmp_path):
    """A configuration, a traffic mix and a metric that exist only as new
    files (and entries) in a copy are found by name."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "sdrbench", tmp_path / "sdrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    sb = tmp_path / "sdrbench"
    cfg = json.loads((sb / "configs/spectrum_fused.json").read_text())
    cfg["name"] = "spectrum_tiny"
    cfg["chain"]["n_fft"] = 1024
    (sb / "configs/spectrum_tiny.json").write_text(json.dumps(cfg))
    for sub in ("reference", "cost"):
        shutil.copy(sb / sub / "spectrum_fused.py", sb / sub / "spectrum_tiny.py")
    (sb / "traffic/tiny_8k.json").write_text(json.dumps({
        "frame": 8192, "k": 2, "ahead": 2, "warmup_dispatches": 2, "check_dispatches": 3,
        "trace_dispatches": 4}))
    (sb / "metrics/frames_done.py").write_text(
        "def read(run):\n    return float(run.window['dispatches'] * run.k)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "spectrum_tiny", "source": "test", "reduced": [],
                             "file": "sdrbench/configs/spectrum_tiny.json", "why": "test"})
    bench["workloads"].append({"name": "spectrum.tiny", "config": "spectrum_tiny",
                               "traffic": "tiny_8k", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "frames_done", "unit": "count", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["spectrum.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    done = subprocess.run([sys.executable, "-c", NEW_CELL], cwd=tmp_path, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    res = json.loads(done.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert set(res["metrics"]) == {"input_msps", "setup_s", "frames_done"}
    assert res["metrics"]["frames_done"]["value"] == res["attempted"]


IMPORTS = r"""
import json, sys, torch
from pathlib import Path
from sdrbench import run
res = run.run_cell(Path("."), "spectrum.capture", 8, 0.2, True, device=torch.device("cpu"),
                   overrides={"frame": 4096, "capture_samples": 4096 * 4 * 4,
                              "warmup_dispatches": 2, "check_dispatches": 2,
                              "trace_dispatches": 2})
print(json.dumps(run.loaded_forbidden()))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_after_a_run():
    """After a run, no module's top-level name is jax, jaxlib, flax or the
    JAX package; the port (whose name begins with the JAX package's) is."""
    done = subprocess.run([sys.executable, "-c", IMPORTS], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    forbidden, tops = (json.loads(line) for line in done.stdout.strip().splitlines()[-2:])
    assert forbidden == []
    assert not set(tops) & {"jax", "jaxlib", "flax", "futuresdr_tpu"}
    assert "futuresdr_tpu_torch" in tops


def test_forbidden_names_compare_whole(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "futuresdr_tpu_torch.sdrbench_probe",
                        types.ModuleType("probe"))
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "futuresdr_tpu.ops", types.ModuleType("probe"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("probe"))
    assert run.loaded_forbidden() == ["futuresdr_tpu.ops", "jaxlib"]


def test_benchmark_names_and_units_use_the_allowed_characters():
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            assert name.match(e["name"]), e["name"]
            if "unit" in e:
                assert unit.match(e["unit"]), e["unit"]
    for w in BENCH["workloads"]:
        assert name.match(w["traffic"]) and name.match(w["config"])
        assert len(w["why"]) <= 200
        assert (ROOT / "sdrbench/traffic" / f"{w['traffic']}.json").exists()


@pytest.mark.gpu
def test_a_short_run_of_each_cell_on_the_card(cuda):
    for w in BENCH["workloads"]:
        res = run.run_cell(ROOT, w["name"], 21, 0.5, False, device=cuda,
                           overrides={"warmup_dispatches": 8, "check_dispatches": 2})
        assert res["correct"], (w["name"], res["checks"])
