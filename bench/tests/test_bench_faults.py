"""A run whose timed path is broken comes out not correct: each fault a
cell can have (``lib/faults.py``, by the cell's driver), planted in the
port, driven through the rest of a run on the CPU at a tiny size (the
look for a card skipped), judged by the cell's own limits."""

import json
import time
from pathlib import Path

import pytest

from bench.lib import harness
from bench.lib.faults import FAULTS

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
CASES = [(w, f) for w in CELLS
         for f in sorted(FAULTS[harness.cell_spec(w)["mix"]["driver"]])]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_fault_is_not_correct(workload, fault, tiny_root):
    driver = harness.cell_spec(workload)["mix"]["driver"]
    with FAULTS[driver][fault]():
        r = harness.execute(workload, 2 ** 31 + 9, 0.1, False,
                            time.perf_counter(), device="cpu", root=tiny_root)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_the_faults_are_lifted_after_the_run():
    from repro_torch.models import recsys
    from repro_torch.train import trainer

    before = (trainer.adamw_update, trainer.value_and_grad,
              recsys.dlrm_forward)
    for faults in FAULTS.values():
        for fault in faults.values():
            with fault():
                pass
    assert (trainer.adamw_update, trainer.value_and_grad,
            recsys.dlrm_forward) == before
