"""The last line of a run, driven through the harness on the CPU at a
tiny size (its look for a card skipped), and what ``run.py`` does where
there is no card."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from bench.lib import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_the_result_line(workload, tiny_root):
    r = harness.execute(workload, 2 ** 31 + 5, 0.2, False,
                        time.perf_counter(), device="cpu", root=tiny_root)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] >= 1 and r["failed"] == 0
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"]: m["unit"] for m in harness.reports(spec, workload)}
    assert {k: v["unit"] for k, v in r["metrics"].items()} == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    limits = json.loads((ROOT / "bench" / "limits" /
                         f"{workload}.json").read_text())["limits"]
    assert set(r["checks"]) == set(limits)
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    # a sound run at the tiny size passes the cell's own limits
    assert r["correct"] is True, r["checks"]
    json.dumps(r)


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_reads_its_per_layer_metrics_or_leaves_them_out(
        workload, tiny_root):
    r = harness.execute(workload, 11, 0.1, True, time.perf_counter(),
                        device="cpu", root=tiny_root)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    allowed = {m["name"] for m in harness.per_layer(spec, workload)}
    assert set(r["metrics"]) <= allowed
    # the step's share of the peak needs no device trace
    assert any(k.startswith("step_mfu") for k in r["metrics"])
    for v in r["metrics"].values():
        assert 0 <= v["value"] <= 100 and v["unit"] == "%"
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr
