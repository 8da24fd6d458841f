"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``launch.roofline``, ``kernels.costs``) on the CPU.

  * ``model_flops`` equals the reference's ``repro.launch.roofline
    .model_flops`` bit for bit, every arch x cell at 1, 256 and 512
    chips;
  * ``roofline_terms`` on hand-computed inputs, a group on one node
    against one over two nodes;
  * exact counts on tiny programs (a matmul's FLOPs and bytes, 17 layers
    of a loop, the peak of live storages, an all-reduce over a 16-rank
    group of a fake world of 256 with its ring wire bytes);
  * the charge chokepoint: a flash-attention call on meta tensors inside
    a dry run is one charge of its cost and no launch; a tensor with no
    data that reaches a launch outside a dry run raises; a CPU call
    inside one charges nothing;
  * at REDUCED on a (2, 2) mesh, ten cells (five train cells, the LM's
    serve cells granite ``prefill_32k`` and ``decode_32k`` and moonshot
    ``decode_32k``, and the recsys serve cells DLRM ``serve_bulk`` and
    two-tower ``retrieval_cand``) against the reference's dry run of the
    same cells (``tests/torch_mesh_ref.py dryrun``, 4 forced host
    devices): the per-rank dot FLOPs within the band each test states,
    and ``argument_size`` equal;
  * granite-3-2b's ``train_4k`` at full width on the (16, 16) mesh: it
    traces, its flash charges are the step's launches, and the ``model``
    all-reduces it sees are ``MODEL_COLLECTIVES``' count;
  * MACE's ``minibatch_lg`` at full width on the (16, 16) mesh: its
    route's 13 collectives over ``data``, a sixteenth of the whole
    batch's dot FLOPs a rank;
  * two-tower's ``train_batch`` at full width on the (16, 16) mesh: no
    table gathered, under 1 GB of wire bytes and 10 GB of peak;
  * moonshot's ``decode_32k`` at full width on the (16, 16) mesh: it
    fits 80 GB, its ``argument_size`` is the rules' cut, it computes on
    its ``model`` shards with the cache's sequence split;
  * two-tower's ``retrieval_cand`` at full width on the (16, 16) mesh:
    no table gathered, one merge (an all-gather over ``data``), 100 ids.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs.registry import ARCH_IDS as REF_ARCH_IDS
from repro.configs.registry import shape_cells as ref_shape_cells
from repro.launch import roofline as ref_roofline

from repro_torch.configs.registry import ARCH_IDS, get_bundle, shape_cells
from repro_torch.device import dry_running
from repro_torch.kernels import costs
from repro_torch.kernels.flash_attention.kernel import (
    FLASH_ATTENTION,
    FLASH_ATTENTION_WGMMA,
    flash_attention,
)
from repro_torch.launch import dryrun
from repro_torch.launch import roofline
from repro_torch.launch.mesh import HW
from repro_torch.tree import leaves

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
REDUCED_CELLS = (("granite-3-2b", "train_4k"),
                 ("moonshot-v1-16b-a3b", "train_4k"),
                 ("dlrm-mlperf", "train_batch"), ("mace", "molecule"),
                 ("two-tower-retrieval", "train_batch"),
                 ("granite-3-2b", "prefill_32k"),
                 ("granite-3-2b", "decode_32k"),
                 ("moonshot-v1-16b-a3b", "decode_32k"),
                 ("dlrm-mlperf", "serve_bulk"),
                 ("two-tower-retrieval", "retrieval_cand"))


# ------------------------------------------------------------ model_flops --
@pytest.mark.parametrize("arch,cell", [(a, c) for a in ARCH_IDS
                                       for c in shape_cells(a)])
def test_model_flops_matches_reference(arch, cell):
    assert arch in REF_ARCH_IDS and cell in ref_shape_cells(arch)
    for n in (1, 256, 512):
        got = roofline.model_flops(arch, cell, n)
        assert got is not None
        assert got == ref_roofline.model_flops(arch, cell, n)


# --------------------------------------------------------- roofline terms --
def test_roofline_terms_on_one_node_and_across_nodes():
    flops = {"bf16": 989e12 * 0.25, "f32": 67e12 * 0.5,
             "tf32x3": 165e12 * 0.125}
    node = roofline.roofline_terms(flops, 3.35e12 * 0.1, 450e9 * 0.5, 0.0)
    assert node["compute_s"] == pytest.approx(0.875)
    assert node["memory_s"] == pytest.approx(0.1)
    assert node["collective_s"] == pytest.approx(0.5)
    assert node["dominant"] == "compute"
    assert node["bound_s"] == pytest.approx(0.875)
    assert node["compute_fraction"] == pytest.approx(1.0)
    # the same wire bytes over a ring that leaves the node: the NIC
    cross = roofline.roofline_terms(flops, 3.35e12 * 0.1, 0.0, 450e9 * 0.5)
    assert cross["collective_s"] == pytest.approx(450e9 * 0.5 / 50e9)
    assert cross["dominant"] == "collective"
    assert cross["compute_fraction"] == pytest.approx(0.875 / 4.5)
    assert roofline.spans_nodes(range(8)) is False
    assert roofline.spans_nodes(range(16)) is True
    assert roofline.spans_nodes([0, 16, 32]) is True
    assert roofline.wire_bytes("all-reduce", 16, 1600) == 2 * 15 / 16 * 1600
    assert roofline.wire_bytes("all-gather", 4, 400) == 300
    assert roofline.wire_bytes("reduce-scatter", 4, 100) == 300
    assert roofline.wire_bytes("all-reduce", 1, 100) == 0


def test_costs_bound_the_card():
    c = costs.flash_cost(2, 32, 8, 4096, 64, torch.bfloat16, True)
    assert c.flops == 4 * 2 * 32 * 64 * 4096 * 4097 / 2
    assert c.nbytes == (2 * 2 * 32 * 4096 * 64 + 2 * 2 * 8 * 4096 * 64) * 2
    assert c.bound_ms() == max(c.flops / 989e12, c.nbytes / 3.35e12) * 1e3
    assert c.bound_by() == "operations" and c.dtype == "bf16"
    assert costs.flash_cost(1, 1, 1, 8, 8, torch.float32, False).dtype \
        == "tf32x3"
    m = costs.member_cost(1 << 14, 1 << 24, 1)
    assert m.nbytes == 9 * (1 << 14) + 32 * (1 << 14) + 32
    assert m.bound_by() == "bytes"
    assert HW["peak_tf32x3_flops"] == 495e12 / 3


# ------------------------------------------------------ tiny programs ------
def _counted(fn, *args, model_group=None):
    count = dryrun.Count({}, model_group)
    for t in args:
        count.hold(t)
    with dry_running(count), dryrun.Counting(count):
        out = fn(*args)
    return count, out


def test_matmul_flops_bytes_and_peak():
    a = torch.empty(64, 128, device="meta")
    b = torch.empty(128, 32, device="meta", dtype=torch.bfloat16)
    count, _ = _counted(lambda x, y: x @ x.T, a, b)
    assert count.flops == {"f32": 2 * 64 * 128 * 64}
    assert count.aten_flops == 2 * 64 * 128 * 64
    # x.T is a view: free; the product reads x twice, writes 64 x 64
    assert count.bytes == 2 * 64 * 128 * 4 + 64 * 64 * 4
    count, _ = _counted(lambda x, y: y.T @ y, a, b)
    assert count.flops == {"bf16": 2 * 32 * 128 * 32}

    def program(x, y):
        t = x * 2          # 32 KB
        u = t + 1          # 32 KB, both live
        del t
        return u.sum()     # t freed before the sum

    count, out = _counted(program, a, b)
    args = 64 * 128 * 4 + 128 * 32 * 2
    assert count.peak == args + 2 * 64 * 128 * 4
    assert count.live == args + 4   # u freed on return, the sum held


def test_a_loop_of_17_layers_is_counted_17_times():
    x = torch.empty(8, 16, device="meta")
    w = torch.empty(16, 16, device="meta")

    def layers(x, w):
        for _ in range(17):
            x = torch.relu(x @ w)
        return x

    count, _ = _counted(layers, x, w)
    assert count.aten_flops == 17 * 2 * 8 * 16 * 16
    assert count.ops == 34


@pytest.fixture
def fake_world():
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_an_all_reduce_over_16_ranks_of_256(fake_world):
    node = dist.new_group(list(range(8)))
    wide = dist.new_group(list(range(16)))
    x = torch.empty(1024, 64, device="meta")

    def program(x):
        dist.all_reduce(x, group=wide)
        dist.all_reduce(x, group=node)
        parts = [torch.empty_like(x) for _ in range(8)]
        dist.all_gather(parts, x, group=node)

    count, _ = _counted(program, x, model_group=wide.group_name)
    nbytes = 1024 * 64 * 4
    coll = count.collectives()
    assert coll["counts"] == {"all-reduce": 2, "all-gather": 1}
    assert coll["result_bytes"]["all-reduce"] == 2 * nbytes
    assert count.cross_node_wire == 2 * 15 / 16 * nbytes
    assert count.node_wire == 2 * 7 / 8 * nbytes + 7 / 8 * 8 * nbytes
    assert coll["total_wire_bytes"] == int(count.cross_node_wire
                                           + count.node_wire)
    assert count.model_collectives == 1
    assert count.bytes == 0     # collectives are not HBM traffic here


# ------------------------------------------------------- the chokepoint --
def _qkv(device, dtype=torch.bfloat16, S=256, D=64):
    return [torch.empty(2, h, S, D, dtype=dtype, device=device)
            for h in (8, 2, 2)]


def test_a_meta_flash_call_is_one_charge_of_its_cost():
    count = dryrun.Count({}, None)
    before = FLASH_ATTENTION_WGMMA.launches
    with dry_running(count):
        out = flash_attention(*_qkv("meta"), causal=True)
    assert out.shape == (2, 8, 256, 64) and out.device.type == "meta"
    want = costs.flash_cost(2, 8, 2, 256, 64, torch.bfloat16, True)
    assert count.kernels == {"flash_attention_wgmma": {
        "launches": 1, "flops": want.flops, "bytes": want.nbytes}}
    assert count.flops == {"bf16": want.flops}
    assert FLASH_ATTENTION_WGMMA.launches == before


def test_a_fake_tensor_at_a_launch_outside_a_dry_run_raises():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q, k, v = _qkv("cuda")
        with pytest.raises(RuntimeError, match="outside a dry run"):
            flash_attention(q, k, v)
        with pytest.raises(RuntimeError, match="outside a dry run"):
            flash_attention(*(t.float() for t in (q, k, v)))
    with pytest.raises(RuntimeError, match="outside a dry run"):
        FLASH_ATTENTION.charged((torch.empty(4, device="meta"),),
                                lambda: None)
    assert FLASH_ATTENTION.charged((torch.empty(4),), lambda: None) is False
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(*_qkv("meta"))


def test_a_cpu_call_inside_a_dry_run_charges_nothing():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(t.shape, generator=gen)
               for t in _qkv("meta", torch.float32, S=16, D=8))
    count = dryrun.Count({}, None)
    launches = (FLASH_ATTENTION.launches, FLASH_ATTENTION_WGMMA.launches)
    with dry_running(count):
        out = flash_attention(q, k, v)
    assert torch.isfinite(out).all()
    assert count.kernels == {} and count.flops == {} and count.bytes == 0
    assert (FLASH_ATTENTION.launches,
            FLASH_ATTENTION_WGMMA.launches) == launches


# ------------------------------------------ REDUCED against the reference --
@pytest.fixture(scope="module")
def ref_dryrun(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "dryrun.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"),
                    "dryrun", str(out)], env=env, check=True, timeout=300)
    return json.loads(out.read_text())


# the factor by which the port repeats a rank's share that the reference
# splits on a (2, 2) mesh: none, as every family splits as the reference
# does (MACE's nodes and edges over data, each rank on its own blocks)
REPEATED = {"granite-3-2b": 1, "moonshot-v1-16b-a3b": 1, "dlrm-mlperf": 1,
            "mace": 1, "two-tower-retrieval": 1}


@pytest.mark.parametrize("arch,cell", REDUCED_CELLS)
def test_reduced_dot_flops_and_arguments_match_reference(arch, cell,
                                                         ref_dryrun):
    bundle = get_bundle(arch, reduced=True)
    r = dryrun.run(bundle, cell, (2, 2), ("data", "model"),
                   flop_counter=True)
    want = ref_dryrun[f"{arch}|{cell}"]
    assert r["ok"]
    assert r["memory"]["argument_size"] == want["argument_size"]
    if r["kind"] == "serve" and bundle.family == "recsys":
        # No backward pass.  Per rank, the port's aten dot FLOPs (the
        # bag kernel's charge is a gather's, which the reference's dots
        # leave out) are at least the reference's and at most twice
        # them: the port repeats on each of the two ``model`` ranks what
        # GSPMD spreads over them (DLRM's interaction of a rank's rows,
        # 1.29 here; two-tower's scoring of the whole candidates, 1.89).
        ratio = r["aten_dot_flops"] / want["dot_flops"]
        assert 1.0 <= ratio <= 2.0, ratio
        # the lookups' sums over ``model`` are ``c10d`` collectives over
        # its group beside ``tensor_parallel``'s
        assert r["model_collectives_counted"] > 0
        assert r["model_collectives_counted"] <= r["model_collectives"] \
            <= r["model_collectives_counted"] + r["row_collectives_counted"]
    elif r["kind"] == "serve":
        # No backward pass.  The reference's prefill at REDUCED computes
        # every score of its S x S (``mha``, below S 4,096), where the
        # flash kernel charges the causal half, S (S + 1) / 2 pairs: the
        # rest is its charge times (S - 1) / (S + 1).  What remains is
        # the same products, but that a MoE decode's dispatch group that
        # spans the batch ranks is routed, dispatched and combined on
        # each of them (fault 3's repair): at most 5% more here.
        S = bundle.shapes[cell][1]
        skipped = sum(k["flops"] for name, k in r["kernels"].items()
                      if name.startswith("flash")) * (S - 1) / (S + 1)
        ratio = (r["flops"] + skipped) / want["dot_flops"]
        assert 1.0 <= ratio <= 1.05, ratio
        assert r["model_collectives"] == r["model_collectives_counted"] > 0
    else:
        # Per rank, the port counts at least the reference's dot FLOPs
        # times what it repeats, and at most a third more: it recomputes
        # every block (and MACE layer) in the backward pass, where the
        # reference's "dots" remat saves the products, which adds up to
        # one forward in three passes.
        ratio = r["flops"] / want["dot_flops"] / REPEATED[arch]
        assert 1.0 <= ratio <= 4 / 3, ratio
    assert r["flops"] == pytest.approx(sum(r["flops_by_dtype"].values()))
    assert r["aten_dot_flops"] == r["flop_counter_total"]


# ------------------------------------------------------- one full cell --
def test_granite_train_at_full_width_on_the_single_mesh():
    bundle = get_bundle("granite-3-2b")
    r = dryrun.run(bundle, "train_4k", (16, 16), ("data", "model"),
                   flop_counter=True)
    assert r["ok"] and r["n_chips"] == 256
    mb, L = bundle.microbatches, bundle.config.n_layers
    # remat: the forward runs again in the backward pass
    assert r["kernels"]["flash_attention_wgmma"]["launches"] == 2 * L * mb
    assert r["kernels"]["flash_attention_backward_wgmma"]["launches"] \
        == L * mb
    # and the optimizer's fused update, one launch a leaf
    n_leaves = len(leaves(bundle.abstract_params()))
    assert r["kernels"]["adamw"]["launches"] == n_leaves
    assert set(r["kernels"]) == {"flash_attention_wgmma",
                                 "flash_attention_backward_wgmma", "adamw"}
    assert r["model_collectives"] == r["model_collectives_counted"] > 0
    assert r["aten_dot_flops"] == r["flop_counter_total"]
    assert r["collectives"]["by_axis"]["model"]["cross_node"]
    assert r["memory"]["fits"]


# MACE's ``minibatch_lg`` on (16, 16) counted over MODEL_FLOPS when every
# rank ran the whole batch (the dry run before the route on the batch
# shards, as PERF.md records it)
MACE_MINIBATCH_WHOLE_X_MODEL = 298.55


def test_mace_minibatch_at_full_width_computes_on_its_data_shards():
    """The sampled cell's 169,984 nodes and 168,960 edges split over
    ``data`` on (16, 16): the route's 13 collectives (the positions
    gathered once; per layer, forward and recomputed, the states
    gathered and the messages summed into their owners, and both
    transposed) all over ``data``, and a rank's dot FLOPs a sixteenth of
    the whole batch's."""
    bundle = get_bundle("mace")
    r = dryrun.run(bundle, "minibatch_lg", (16, 16), ("data", "model"))
    layers = bundle.cell_specs["minibatch_lg"].config.n_layers
    assert r["ok"]
    assert r["graph_collectives_counted"] == 1 + 3 * layers * 2
    assert set(r["collectives"]["by_axis"]) == {"data"}
    assert r["collectives"]["by_axis"]["data"]["count"] \
        >= r["graph_collectives_counted"]
    x_model = r["flops"] / roofline.model_flops("mace", "minibatch_lg", 256)
    assert MACE_MINIBATCH_WHOLE_X_MODEL / x_model == pytest.approx(
        16, rel=0.02)


def test_two_tower_train_at_full_width_gathers_no_table(monkeypatch):
    """two-tower's ``train_batch`` at published widths on the (16, 16)
    mesh looks its tables up where their rows lie: no all-gather as large
    as its smallest table (a 100,000-row one, 102.4 MB in f32), under
    1 GB of wire bytes and under 10 GB of peak a rank (gathered whole,
    the tables took 35.16 GB of wire bytes and a 50.0 GB peak)."""
    from repro_torch.models.recsys import row_tables

    gathers = []
    count = dryrun.Count._collective

    def spy(self, func, kind, args, kwargs, outs):
        if kind == "all-gather":
            gathers.append(sum(dryrun._nbytes(t) for t in outs))
        return count(self, func, kind, args, kwargs, outs)

    monkeypatch.setattr(dryrun.Count, "_collective", spy)
    bundle = get_bundle("two-tower-retrieval")
    r = dryrun.run(bundle, "train_batch", (16, 16), ("data", "model"))
    cfg = bundle.config
    smallest = min(rows for rows, _ in row_tables(cfg).values()) \
        * cfg.embed_dim * 4
    assert r["ok"] and gathers
    assert max(gathers) < smallest
    assert r["collectives"]["total_wire_bytes"] < 1e9
    assert r["memory"]["peak_size"] < 10e9


def test_moonshot_decode_at_full_width_fits_on_its_shards():
    """moonshot-v1-16b-a3b's ``decode_32k`` (128 slots x 32,768) at
    published widths on the (16, 16) mesh: the serve step computes on
    the weights' ``model`` shards with the cache's sequence split over
    ``model`` (one paged launch a layer over 2,048 positions of each of
    the rank's 8 rows), it fits 80 GB a rank (with the weights whole on
    every rank and the sequence whole, the count was 160.2 GB), and its
    ``argument_size`` is
    the rules' cut of the f32 params plus the cell's cut of its
    inputs."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tree import leaves

    bundle = get_bundle("moonshot-v1-16b-a3b")
    cfg = bundle.config
    r = dryrun.run(bundle, "decode_32k", (16, 16), ("data", "model"))
    assert r["ok"] and r["memory"]["fits"]
    assert r["memory"]["peak_size"] < 80e9
    assert r["kernels"]["paged_attention"]["launches"] == cfg.n_layers
    # per layer, 128 / 16 rows x n_kv heads of 32,768 / 16 positions
    B, S = bundle.shapes["decode_32k"]
    tokens = cfg.n_layers * (B // 16) * cfg.n_kv_heads * (S // 16)
    assert r["kernels"]["paged_attention"]["flops"] == \
        4 * cfg.d_head * (cfg.n_heads // cfg.n_kv_heads) * tokens
    assert r["model_collectives"] == r["model_collectives_counted"] > 0

    def cut(tree, shardings, sizes):
        total = 0
        for t, sh in zip(leaves(tree), leaves(shardings)):
            n = math.prod(t.shape)
            for e in sh.spec:
                for axis in ((e,) if isinstance(e, str) else (e or ())):
                    n //= sizes[axis]
            total += n * t.element_size()
        return total

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
        sizes = shd.axis_sizes(mesh)
        params = bundle.abstract_params()
        inputs = bundle.abstract_inputs("decode_32k")["batch"]
        want = cut(params, shd.shard_by_rules(params, mesh, bundle.rules),
                   sizes) + cut(inputs, shd.sanitize_shardings(
                       bundle.input_sharding("decode_32k", mesh)["batch"],
                       inputs, mesh), sizes)
    finally:
        dist.destroy_process_group()
    assert r["memory"]["argument_size"] == want


def test_two_tower_retrieval_at_full_width_merges_over_data(monkeypatch):
    """two-tower's ``retrieval_cand`` at published widths on the (16, 16)
    mesh: the 1,000,000 candidates split over ``data`` (62,500 a rank),
    the query's tables looked up where their rows lie (no all-gather as
    large as the smallest table the query reads, ``ctx``'s 100,000 rows,
    51.2 MB in bf16), each rank's top 100 merged by one all-gather over
    ``data`` (16 ranks x 100 (score, id) pairs in f64, 25,600 bytes),
    and 100 ids (int64) returned."""
    from repro_torch.models.recsys import RETRIEVAL_K

    gathers = []
    count = dryrun.Count._collective

    def spy(self, func, kind, args, kwargs, outs):
        if kind == "all-gather":
            gathers.append(sum(dryrun._nbytes(t) for t in outs))
        return count(self, func, kind, args, kwargs, outs)

    monkeypatch.setattr(dryrun.Count, "_collective", spy)
    bundle = get_bundle("two-tower-retrieval")
    cfg = bundle.config
    r = dryrun.run(bundle, "retrieval_cand", (16, 16), ("data", "model"))
    assert r["ok"] and r["memory"]["fits"]
    assert r["merge_collectives_counted"] == 1
    assert 16 * RETRIEVAL_K * 2 * 8 in gathers
    assert max(gathers) < cfg.n_context * cfg.embed_dim * 2
    assert r["collectives"]["by_axis"]["data"]["count"] >= 1
    assert r["memory"]["output_size"] == RETRIEVAL_K * 8


# ------------------------------------------- the card's cross-check --
def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_holds_the_dry_run_to_the_step():
    """``chip_smoke.dryrun_failures`` on a granite REDUCED dry run and a
    step that agrees, then with one launch, one collective and one FLOP
    off: each disagreement fails."""
    smoke = _chip_smoke()
    dry = dryrun.run(get_bundle("granite-3-2b", reduced=True), "train_4k",
                     (1, 1), ("data", "model"), flop_counter=True)
    real = {"launches": {k: v["launches"] for k, v in dry["kernels"].items()},
            "model_collectives": dry["model_collectives"],
            "flop_counter_total": dry["flop_counter_total"]}
    real["launches"]["embedding_bags"] = 0
    assert dry["model_collectives"] > 0
    assert smoke.dryrun_failures(dry, real) == []
    k = next(iter(real["launches"]))
    for bad in ({"launches": {**real["launches"], k: 1 + real["launches"][k]}},
                {"model_collectives": real["model_collectives"] + 1},
                {"flop_counter_total": real["flop_counter_total"] + 1}):
        assert len(smoke.dryrun_failures(dry, {**real, **bad})) >= 1
