"""The LM family serving on its ``model`` shards on a mesh
(``LMBundle.serve_step``: ``prefill`` and ``decode_step`` under
``models.transformer.lm_plan``), on CPU gloo ranks, against the same
steps in one process and against the JAX package's GSPMD cells.

Ranks are processes of ``tests/torch_mesh_workers.py serve`` on a
file-store gloo group (no network, ``OMP_NUM_THREADS=1``), in f32, from
params drawn by the port.  On a (1, 2) ``("data", "model")`` mesh:
granite-3-2b REDUCED (heads, K/V, MLP and vocabulary split), granite with
one K/V head (K/V whole, each rank's K/V head taken from the gathered
new token), granite with 6 query heads over 3 K/V heads (the heads whole:
the ranks' attention all-reduced rather than reduce-scattered) and
moonshot-v1-16b-a3b REDUCED (experts split); on a (2, 2) mesh granite
and moonshot.  Each case: a prompt of 4 x 24 tokens through the prefill
cell's step, then 4 decode steps of 8 rows on a cache of S_max 64 placed
as the decode cell lays it out (the sequence split over ``model``: 32
positions a rank), whose rows start at lengths on the blocks' edges
(``k * 32 - 1``, ``k * 32``), empty on the second block, full, and one
that crosses the edge.  The logits of the prefill and of each step are
held to one process's within 1e-5 of the largest logit; every rank's
block of the cache after the steps equals the same slice of the one
process's cache (the new entries were written by their owners alone:
any other rank's write would land inside its own block); the prefill's
K/V are the rank's heads of the one process's; MoE drops summed over the
batch ranks equal one process's; and the count of ``model`` collectives
is above 0.  On (2, 2) granite and moonshot are also held to the
reference's jitted ``prefill`` and ``decode_step`` under the bundle's
shardings (``tests/torch_mesh_ref.py servestep``, 4 forced host
devices) within 1e-5 of the largest logit.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.tree import flatten_with_path, path_name

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_workers import MOE_ARCH, lm_bundle_f32  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")
PROMPT = (4, 24)
S_MAX = 64
STEPS = 4
# the rows' starting lengths on a cache of 64 split over 2 ranks (blocks of
# 32): empty, block edges from both sides, the cache's last position and
# full, one row that crosses the edge in the steps, one that never
# reaches the second block
LENS = (0, 31, 32, 30, 63, 64, 5, 62)

# case: (mesh, arch, config changes)
CASES = {
    "granite_1x2": ((1, 2), "granite-3-2b", {}),
    "granite_kv1_1x2": ((1, 2), "granite-3-2b", {"n_kv_heads": 1}),
    "granite_h6_1x2": ((1, 2), "granite-3-2b", {"n_heads": 6,
                                                "n_kv_heads": 3}),
    "moonshot_1x2": ((1, 2), MOE_ARCH, {}),
    "granite_2x2": ((2, 2), "granite-3-2b", {}),
    "moonshot_2x2": ((2, 2), MOE_ARCH, {}),
}
# the (2, 2) cases held to the reference's cells (its SERVE_ARCHS)
REF_CASES = {"granite_2x2": "granite-3-2b", "moonshot_2x2": MOE_ARCH}


def _inputs(name: str, bundle) -> dict:
    """Serving params (f32), a prompt, a cache of random K/V at ``LENS``
    and the steps' tokens, from a seed of the case's own."""
    cfg = bundle.config
    gen = torch.Generator().manual_seed(len(name))
    params = bundle.init(gen, masters=False)
    rng = np.random.RandomState(len(name))
    kv = (cfg.n_layers, len(LENS), cfg.n_kv_heads, S_MAX, cfg.d_head)
    return {
        "arch": bundle.name, "params": params,
        "tokens": torch.from_numpy(
            rng.randint(0, cfg.vocab, PROMPT).astype(np.int32)),
        "cache": {
            "k": torch.from_numpy(rng.standard_normal(kv).astype(np.float32)),
            "v": torch.from_numpy(rng.standard_normal(kv).astype(np.float32)),
            "len": torch.tensor(LENS, dtype=torch.int32)},
        "steps": torch.from_numpy(
            rng.randint(0, cfg.vocab, (STEPS, len(LENS))).astype(np.int32)),
    }


def _ranks(world: int, data: int, d: Path) -> list:
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_workers.py"),
         "serve", str(r), str(world), str(d), str(data)], env=ENV,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _wait(procs) -> None:
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


def _one_process(bundle, case: dict) -> dict:
    """The same steps with no mesh, on the whole batch and cache."""
    logits, kv = bundle.serve_step("prefill_32k")(
        case["params"], {"tokens": case["tokens"]})
    cache = {k: v.clone() for k, v in case["cache"].items()}
    step = bundle.serve_step("decode_32k")
    steps, dropped = [], []
    for tok in case["steps"]:
        out, c = step(case["params"], {"token": tok, "cache": cache})
        cache["len"] = c["len"]
        steps.append(out)
        dropped.append(float(c.get("moe_dropped", 0.0)))
    return {"prefill": logits, "prefill_k": kv["k"], "prefill_v": kv["v"],
            "prefill_dropped": float(kv.get("moe_dropped", 0.0)),
            "decode": torch.stack(steps), "dropped": dropped, **cache}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' ranks and the reference's cells, run side by side:
    (the cases' inputs, each case's per-rank results, the reference's
    arrays)."""
    d = tmp_path_factory.mktemp("serve")
    cases = {name: {**_inputs(name, lm_bundle_f32(arch, **changes)),
                    "changes": changes}
             for name, (_, arch, changes) in CASES.items()}
    ref_in = {}
    for name, arch in REF_CASES.items():
        case = cases[name]
        for p, t in flatten_with_path(case["params"]):
            ref_in[f"{arch}/init/{path_name(p)}"] = t.numpy()
        ref_in[f"{arch}/tokens"] = case["tokens"].numpy()
        for k in ("k", "v"):   # the reference's (L, B, S_max, n_kv, D)
            ref_in[f"{arch}/{k}"] = case["cache"][k].permute(
                0, 1, 3, 2, 4).numpy()
        ref_in[f"{arch}/len"] = case["cache"]["len"].numpy()
        ref_in[f"{arch}/steps"] = case["steps"].numpy()
    np.savez(d / "ref_in.npz", **ref_in)
    procs = [(None, [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"),
         "servestep", str(d / "ref_in.npz"), str(d / "ref_out.npz")],
        env=dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)])]
    for shape in sorted({m for m, *_ in CASES.values()}):
        sub = d / f"{shape[0]}x{shape[1]}"
        sub.mkdir()
        torch.save({n: c for n, c in cases.items() if CASES[n][0] == shape},
                   sub / "serve_inputs.pt")
        procs.append((sub, _ranks(shape[0] * shape[1], shape[0], sub)))
    out = {}
    for sub, ranks in procs:
        _wait(ranks)
        if sub is not None:
            out.update(torch.load(sub / "serve_out.pt"))
    return cases, out, dict(np.load(d / "ref_out.npz"))


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    scale = float(want.abs().max())
    err = float((got.double() - want.double()).abs().max())
    assert err <= TOL * scale, f"{what}: {err} > {TOL} * {scale}"


def _rows(per_rank, key: str) -> torch.Tensor:
    """``key`` of the ranks at model coordinate 0, in batch order."""
    return torch.cat([r[key] for c, r in sorted(per_rank, key=lambda x: x[0])
                      if c[1] == 0], 0)


@pytest.mark.parametrize("name", list(CASES))
def test_serve_steps_match_one_process(runs, name):
    cases, out, _ = runs
    case, got = cases[name], out[name]
    (data, model), _, changes = CASES[name]
    bundle = lm_bundle_f32(case["arch"], **changes)
    want = _one_process(bundle, case)
    cfg = bundle.config
    # every rank of a batch block returns the same whole logits
    for c, r in got:
        b = PROMPT[0] // data
        _close(r["prefill"], want["prefill"][c[0] * b:(c[0] + 1) * b],
               f"{name} prefill {c}")
        b = len(LENS) // data
        _close(r["decode"], want["decode"][:, c[0] * b:(c[0] + 1) * b],
               f"{name} decode {c}")
    # each rank's block of the cache: rows over data, positions over model;
    # the (row, position) entries the steps wrote are the one process's
    def wrote(cache, first):
        return (cache["k"] != first).any(dim=(0, 2, 4))

    s_loc = S_MAX // model
    want_wrote = wrote(want, case["cache"]["k"])
    start = np.asarray(LENS)
    assert int(want_wrote.sum()) == int(
        (np.minimum(start + STEPS, S_MAX) - np.minimum(start, S_MAX)).sum())
    for c, r in got:
        b = len(LENS) // data
        rows = slice(c[0] * b, (c[0] + 1) * b)
        seq = slice(c[1] * s_loc, (c[1] + 1) * s_loc)
        for k in ("k", "v"):
            assert r[k].shape == (cfg.n_layers, b, cfg.n_kv_heads, s_loc,
                                  cfg.d_head)
            _close(r[k], want[k][:, rows, :, seq], f"{name} {k} {c}")
        assert torch.equal(r["len"], want["len"][rows])
        assert torch.equal(wrote(r, case["cache"]["k"][:, rows, :, seq]),
                           want_wrote[rows, seq]), (name, c)
    # the prefill's K/V: this rank's heads of the whole (K/V heads whole,
    # or the one its query heads read)
    for c, r in got:
        b = PROMPT[0] // data
        nkv = r["prefill_k"].shape[2]
        if nkv == cfg.n_kv_heads:           # the heads whole
            first = 0
        elif nkv * model == cfg.n_kv_heads:  # K/V split with the heads
            first = c[1] * nkv
        else:                               # the K/V head of its group
            first = c[1] * (cfg.n_heads // model) // (cfg.n_heads
                                                      // cfg.n_kv_heads)
        heads = slice(first, first + nkv)
        for k in ("k", "v"):
            _close(r[f"prefill_{k}"],
                   want[f"prefill_{k}"][:, c[0] * b:(c[0] + 1) * b, heads],
                   f"{name} prefill {k} {c}")
    assert all(r["collectives"] > 0 for _, r in got)
    if cfg.moe is not None:
        assert sum(r["prefill_dropped"] for c, r in got if c[1] == 0) \
            == want["prefill_dropped"]
        for i in range(STEPS):
            assert sum(r["dropped"][i] for c, r in got if c[1] == 0) \
                == want["dropped"][i]


@pytest.mark.parametrize("name", list(REF_CASES))
def test_serve_steps_match_the_reference_gspmd_cells(runs, name):
    """The (2, 2) ranks' logits against the JAX package's jitted cells
    under the bundle's shardings."""
    _, out, ref = runs
    arch = REF_CASES[name]
    got = out[name]
    _close(_rows(got, "prefill"), torch.from_numpy(ref[f"{arch}/prefill"]),
           f"{name} prefill")
    decode = torch.cat([r["decode"] for c, r in sorted(got) if c[1] == 0], 1)
    _close(decode, torch.from_numpy(ref[f"{arch}/decode"]), f"{name} decode")
