"""The control: the reference put in the program's place and computed in
the precision below the one the configuration states (FP8 products for
granite's bf16 GEMMs and for DLRM's bf16 serving, bf16 optimizer state
for DLRM's f32 training state).  On the CPU at a tiny size it reads
further from the reference than the port does on the same seed; on the
card, at the cell's own size, it fails the cell's limits on three seeds
(``python -m pytest bench/tests -m card`` there)."""

import json
from pathlib import Path

import pytest

from bench.lib import compare, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def readings(workload, root, seed, device):
    """The cell's sound, reference and control readings on ``seed``."""
    s = harness.cell_spec(workload, root)
    fam = harness.family(s["model"], s["mix"])
    drv = harness.driver(s["mix"])
    lim = s["limits"]
    prog = drv.program_readings(fam, seed, device, lim, 0.5)
    ref = drv.reference_readings(fam, seed, device, lim, prog)
    ctl = drv.reference_readings(fam, seed, device, lim, prog, control=True)
    return drv, lim, prog, ref, ctl


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_reads_further_than_the_port(workload, tiny_root):
    drv, lim, prog, ref, ctl = readings(workload, tiny_root, 2 ** 31 + 3,
                                        "cpu")
    sound, control = drv.numbers(prog, ref), drv.numbers(ctl, ref)
    assert any(control[k] > 2 * sound[k] for k in lim["limits"]), (
        control, sound)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limits_at_the_cells_size(workload, card):
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        drv, lim, prog, ref, ctl = readings(workload, ROOT, seed, card)
        ok, checks = compare.judge(drv.numbers(ctl, ref), lim["limits"])
        assert not ok, checks
