"""Shared fixtures of the benchmark's CPU tests: the repository on the
import path, a ``card`` fixture that skips where there is no NVIDIA GPU,
and a tiny copy of each cell (its configuration cut to a few thousand
parameters, its traffic to a few rows) that runs on the CPU in seconds."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "granite-3-2b-unscaled": dict(num_hidden_layers=2, hidden_size=64,
                                  num_attention_heads=8,
                                  num_key_value_heads=2, head_dim=8,
                                  intermediate_size=256, vocab_size=512,
                                  attention_multiplier=8 ** -0.5),
    "dlrm-mlperf": dict(table_rows=[1000, 50, 3, 200], embed_dim=16,
                        bot_mlp=[64, 32, 16], top_mlp=[64, 32, 1]),
    "dlrm-mlperf-published": dict(table_rows=[1000, 50, 3, 200],
                                  embed_dim=16, bot_mlp=[64, 32, 16],
                                  top_mlp=[64, 32, 1]),
}
TINY_TRAFFIC = {"train-4k": dict(batch=4, seq=64, microbatches=2, pool=3),
                "train": dict(batch=256, pool=3, trace_steps=2),
                "serve-bulk": dict(batch=512, pool=3, trace_steps=2)}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    return torch.device("cuda", 0)


def _load(path: Path) -> dict:
    return json.loads(path.read_text())


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A checkout's ``BENCHMARK.json`` with every configuration and mix
    cut to a tiny size; the cells' own limits."""
    root = tmp_path_factory.mktemp("tiny")
    spec = _load(ROOT / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits"):
        (root / "bench" / sub).mkdir(parents=True)
    for c in spec["configs"]:
        model = {**_load(ROOT / c["file"]), **TINY[c["name"]]}
        (root / c["file"]).write_text(json.dumps(model))
    for w in spec["workloads"]:
        name = w["traffic"]
        path = root / "bench" / "traffic" / f"{name}.json"
        mix = {**_load(ROOT / "bench" / "traffic" / f"{name}.json"),
               **TINY_TRAFFIC[name]}
        path.write_text(json.dumps(mix))
        limits = ROOT / "bench" / "limits" / f"{w['name']}.json"
        (root / "bench" / "limits" / limits.name).write_text(
            limits.read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(autouse=True)
def few_threads():
    width = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(width)
