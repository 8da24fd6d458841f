"""``BENCHMARK.json`` and the files it names: every cell finds its
configuration, mix, family, driver and limits by name, every per-layer
metric its reader, and the file keeps the contract's shape."""

import importlib
import json
import re
from pathlib import Path

import pytest

from bench.lib import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_shape():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert cells <= 24 and len(SPEC["configs"]) <= 24
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43_200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) or "hidden" in k
                       or "intermediate" in k for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_finds_its_files_by_name(workload):
    s = harness.cell_spec(workload)
    fam = harness.family(s["model"], s["mix"])
    drv = harness.driver(s["mix"])
    assert callable(drv.run) and callable(drv.end_to_end)
    assert fam.specs() and s["limits"]["control"]
    assert s["limits"]["limits"] and all(
        v > 0 for v in s["limits"]["limits"].values())
    mine = harness.reports(SPEC, workload)
    names = {m["name"] for m in mine}
    assert "setup_s" in names and len(names) >= 2
    layer = harness.per_layer(SPEC, workload)
    assert layer
    for m in layer:
        assert m["moves"] in names
        assert callable(harness.reader(m["name"]))


def test_every_metric_has_its_reader_and_every_config_its_file():
    for m in SPEC["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        model = json.loads((ROOT / c["file"]).read_text())
        assert model["name"] == c["name"] and model["source"]
        importlib.import_module(f"bench.families.{model['family']}")
        for key in c["reduced"]:
            assert key in model and key in model["published"]
            assert model[key] != model["published"][key]


def test_layers_are_named_alike():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"], set()).add(m["name"].split(".")[0])
    assert set(by_layer) == {"trainer step", "optimizer", "attention",
                             "sparse lookups", "device"}
