"""The port's sharding slice against the JAX package, on the CPU: the
rule engine, every bundle's param, opt and input specs on the production
meshes, their DTensor placements, ``constrain``, ``launch.mesh`` and the
launcher's ``--mesh``.

The reference runs once in a subprocess whose XLA_FLAGS force 512 host
devices (``tests/torch_mesh_ref.py specs``) and writes its specs to JSON;
the port resolves its own over DeviceMeshes of PyTorch's fake process
group (no ranks run), a world of 256 for (16, 16) and of 512 for
(2, 16, 16).  Specs must be equal entry for entry.  The one layout
difference: the port's KV cache is head-major, (L, B, n_kv, S_max, D)
where the reference's is (L, B, S_max, n_kv, D), so a decode cell's
cache spec is compared after that permutation.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

import jax
from jax.sharding import PartitionSpec as JP

from repro.distributed import hooks as ref_hooks
from repro.distributed import sharding as ref_shd

from repro_torch.configs.registry import ARCH_IDS, get_bundle
from repro_torch.distributed import hooks
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P, NamedSharding
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train as port_launch
from repro_torch.tree import flatten_with_path, leaves, path_name

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"single": (False, 256), "multi": (True, 512)}
KV_PERM = (0, 1, 3, 2, 4)   # reference cache layout -> the port's


class FakeMesh:
    """The reference tests' duck-typed mesh (axis names and sizes)."""

    def __init__(self, sizes):
        self._sizes = dict(sizes)

    @property
    def axis_names(self):
        return tuple(self._sizes)

    @property
    def shape(self):
        return dict(self._sizes)


def _spec(s) -> list:
    return [None if e is None else e if isinstance(e, str) else list(e)
            for e in tuple(s)]


def _named(tree) -> dict:
    return {path_name(p): _spec(s.spec) for p, s in flatten_with_path(tree)}


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "specs.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"),
                    "specs", str(out)], env=env, check=True, timeout=300)
    return json.loads(out.read_text())


@pytest.fixture(params=list(MESHES))
def fake_mesh(request):
    """(name, DeviceMesh) of the production mesh over a fake world."""
    multi, world = MESHES[request.param]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield request.param, port_mesh.make_production_mesh(
            multi_pod=multi, device="cpu")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ rule engine --
RESOLVE_CASES = [
    ({"pod": 2, "data": 16, "model": 16}, ("model", None), (32, 7)),
    ({"pod": 2, "data": 16, "model": 16}, (("pod", "data", "model"), None),
     (64, 5)),
    ({"pod": 2, "data": 16, "model": 16}, (("pod", "data", "model"), None),
     (1024, 5)),
    ({"pod": 2, "data": 16, "model": 16}, ("model",), (122753,)),
    ({"pod": 2, "data": 16, "model": 16}, ("nonexistent",), (16,)),
    ({"data": 16, "model": 16}, (("data", "model"),), (48,)),
    ({"data": 16, "model": 16}, (("pod", "data", "model"), None), (4096, 3)),
    ({"data": 16, "model": 16}, (("pod", "data"), "model"), (6, 18)),
    ({"data": 16, "model": 16}, (None, ("model", "data")), (3, 8)),
]


@pytest.mark.parametrize("sizes,spec,shape", RESOLVE_CASES)
def test_resolve_spec_matches_reference(sizes, spec, shape):
    m = FakeMesh(sizes)
    assert _spec(shd.resolve_spec(m, spec, shape)) == \
        _spec(ref_shd.resolve_spec(m, spec, shape))


@pytest.mark.parametrize("names,dim", [
    (("pod", "data", "model"), 512), (("pod", "data", "model"), 96),
    (("data", "model"), 48), (("model", "data"), 7), (("data",), 1),
])
def test_fit_axes_matches_reference(names, dim):
    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert shd._fit_axes(m, names, dim) == ref_shd._fit_axes(m, names, dim)


def test_batch_spec_shard_batch_and_replicated_match_reference():
    import jax.numpy as jnp

    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    batch = {"a": torch.zeros(64, 3), "b": torch.zeros(7), "c": torch.zeros(()),
             "d": torch.zeros(32, 2, 2)}
    got = shd.shard_batch(batch, m, leading_specs={"d": P(None, "model")})
    assert _spec(shd.batch_spec(m)) == _spec(ref_shd.batch_spec(
        jax.make_mesh((1, 1, 1), ("pod", "data", "model"))))
    assert _named(got) == {"a": [["pod", "data"], None], "b": [], "c": [],
                           "d": [None, "model"]}
    assert all(s.spec == P() for s in leaves(shd.replicated(m, batch)))
    # sanitize pads a short spec and degrades what does not divide
    fixed = shd.sanitize_shardings(
        {"x": NamedSharding(m, P("model"))},
        {"x": torch.empty(24, 8, 3, device="meta")}, m)
    assert fixed["x"].spec == P(None, None, None)
    ref = ref_shd.resolve_spec(m, ("model", None, None), (24, 8, 3))
    assert _spec(fixed["x"].spec) == _spec(ref)
    del jnp


# -------------------------------------------------------- bundles' specs --
@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bundle_specs_equal_reference(ref_specs, fake_mesh, arch, size):
    """Param, opt and every cell's input specs, spec for spec."""
    name, mesh = fake_mesh
    want = ref_specs[f"{arch}|{size}|{name}"]
    b = get_bundle(arch, reduced=size == "reduced")
    assert _named(b.param_shardings(mesh)) == want["params"]
    assert _named(b.opt_shardings(mesh)) == want["opt"]
    assert sorted(b.cells) == sorted(want["inputs"])
    for cell in b.cells:
        got = _named(b.input_sharding(cell, mesh))
        exp = dict(want["inputs"][cell])
        for k in ("batch/cache/k", "batch/cache/v"):
            if k in exp:
                exp[k] = [exp[k][i] for i in KV_PERM]
        assert got == exp, cell
    # abstract trees take no memory
    assert all(t.device.type == "meta" for t in leaves(b.abstract_params()))
    assert all(t.device.type == "meta" for t in leaves(b.abstract_opt()))


def test_placements_translate_specs(fake_mesh):
    """A dim over a tuple of axes shards on each of their mesh dims, in
    mesh order; a spec out of mesh order raises."""
    name, mesh = fake_mesh
    order = list(shd.axis_sizes(mesh))
    tree = {"tables": {"t0": {"table": torch.empty(1024, 8, device="meta")}}}
    table = shd.shard_by_rules(tree, mesh, shd.RECSYS_RULES)["tables"]["t0"][
        "table"]
    want = [Shard(0) if a in ("pod", "data", "model") else Replicate()
            for a in order]
    assert list(table.placements) == want
    lm = get_bundle("granite-3-2b").param_shardings(mesh)
    wq = lm["block"]["wq"]["w"]                      # (L, d, q): data, model
    assert wq.spec == P(None, "data", "model")
    assert list(wq.placements) == [
        {"pod": Replicate(), "data": Shard(1), "model": Shard(2)}[a]
        for a in order]
    assert all(isinstance(p, Replicate)
               for p in lm["block"]["ln1"].placements)
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements(mesh, P(("model", "data")))


def test_place_takes_this_ranks_block_without_copying():
    dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=8)
    try:
        mesh = port_mesh.make_mesh((2, 4), ("data", "model"), device="cpu")
        x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6 * 4)
        d = shd.place(x, NamedSharding(mesh, P("data", "model")))
        assert isinstance(d, DTensor) and d.shape == x.shape
        # rank 5 sits at (1, 1): rows 4-7, columns 6-11
        assert torch.equal(d.to_local(), x[4:8, 6:12])
        assert d.to_local().data_ptr() == x[4, 6:].data_ptr()
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- constrain --
ENTRIES = [("batch", None, "model", None), ("batch", None, None),
           (None, "model"), ("batch", "nonexistent", "data")]


@pytest.mark.parametrize("entries", ENTRIES)
def test_constrain_resolves_entries_as_the_reference(entries, monkeypatch):
    """Outside a mesh both are no-ops; inside one the port resolves
    "batch", axis names and None to the spec the reference hands
    ``with_sharding_constraint``."""
    x = torch.zeros(4, 4, 4, 4)
    assert hooks.constrain(x, *entries) is x
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda v, spec: seen.append(spec) or v)
    assert ref_hooks.constrain(1.0, *entries) == 1.0 and not seen
    for shape, axes in (((1, 1), ("data", "model")),
                        ((1, 1, 1), ("pod", "data", "model"))):
        with jax.set_mesh(jax.make_mesh(shape, axes)):
            ref_hooks.constrain(1.0, *entries)
        want = seen.pop()
        assert isinstance(want, JP)
        got = hooks.resolve_entries(axes, entries)
        assert _spec(got) == _spec(want)
        with hooks.use_mesh(FakeMesh(dict(zip(axes, shape)))):
            assert hooks.constrain(x, *entries) is x  # a local tensor


def test_constrain_redistributes_a_dtensor(fake_mesh):
    name, mesh = fake_mesh
    full = torch.zeros(64, 8, 32, 16)
    d = shd.place(full, NamedSharding(mesh, P()))
    with hooks.use_mesh(mesh):
        out = hooks.constrain(d, "batch", None, "model", None)
    assert tuple(out.placements) == shd.placements(
        mesh, hooks.resolve_entries(tuple(shd.axis_sizes(mesh)),
                                    ("batch", None, "model", None)))
    assert hooks.active_mesh() is None


# ------------------------------------------------------------ launch.mesh --
def test_mesh_module_imports_without_touching_a_device():
    code = ("import torch.distributed as d; import repro_torch.launch.mesh; "
            "assert not d.is_initialized(); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                  CUDA_VISIBLE_DEVICES=""))
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("multi,need", [(False, 256), (True, 512)])
def test_production_mesh_names_the_size_it_needs(multi, need):
    with pytest.raises(ValueError, match=f"needs {need} ranks, but no"):
        port_mesh.make_production_mesh(multi_pod=multi, device="cpu")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        with pytest.raises(ValueError,
                           match=f"needs {need} ranks, but the world has 8"):
            port_mesh.make_production_mesh(multi_pod=multi, device="cpu")
        with pytest.raises(ValueError, match="needs 1 ranks"):
            port_mesh.make_host_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_launcher_places_reduced_params_with_reference_specs(ref_specs):
    """``--mesh single`` on a fake world of 256: the trainer's params
    and AdamW state are DTensors placed by the reference's specs."""
    dist.init_process_group("fake", store=FakeStore(), rank=17,
                            world_size=256)
    try:
        tr = port_launch.main(["--device", "cpu", "--mesh", "single",
                               "--steps", "0"])
    finally:
        dist.destroy_process_group()
    want = ref_specs["granite-3-2b|reduced|single"]["params"]
    mesh = leaves(tr.params)[0].device_mesh
    assert tuple(mesh.shape) == (16, 16)
    for p, leaf in flatten_with_path(tr.params):
        assert isinstance(leaf, DTensor)
        assert tuple(leaf.placements) == shd.placements(
            mesh, tuple(tuple(e) if isinstance(e, list) else e
                        for e in want[path_name(p)])), path_name(p)
    for p, leaf in flatten_with_path(tr.opt_state["mu"]):
        assert isinstance(leaf, DTensor)
    assert tr.step_num == 0
