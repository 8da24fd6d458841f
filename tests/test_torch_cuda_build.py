"""The kernel library's build rule (``repro_torch.kernels.cuda_lib``), on
the CPU: the library's name hashes the ``csrc/*.cuh`` headers beside the
``*.cu`` sources, so an edited header builds anew, and ``nvcc`` compiles
the sources alone.  ``nvcc`` itself is replaced by a recorder here; the
card builds for real (``chip_smoke.py``)."""

import subprocess
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro_torch.kernels import cuda_lib


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    """A csrc/ of two sources and a header, a build dir, and an ``nvcc``
    that records its command lines and writes the outputs they name."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "shared.cuh"\nint a;\n')
    (csrc / "b.cu").write_text('#include "shared.cuh"\nint b;\n')
    (csrc / "shared.cuh").write_text("#pragma once\nconstexpr int k = 1;\n")
    calls = []

    def record(cmd):
        calls.append(list(cmd))
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

    class Popen:
        def __init__(self, cmd, **_):
            record(cmd)
            self.returncode = 0

        def communicate(self):
            return "", None

    def run(cmd, **_):
        record(cmd)
        return SimpleNamespace(returncode=0, stdout="")

    monkeypatch.setattr(cuda_lib, "CSRC", csrc)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", Popen)
    monkeypatch.setattr(subprocess, "run", run)
    return csrc, calls


@pytest.mark.parametrize("edited", ["shared.cuh", "a.cu"])
def test_an_edited_file_names_a_new_library(fake_tree, edited):
    """Editing a header, like editing a source, changes the library's
    name and builds it anew; an unchanged tree reuses the built one."""
    csrc, calls = fake_tree
    first = cuda_lib.build()
    assert first.exists() and calls
    calls.clear()
    assert cuda_lib.build() == first and not calls
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    second = cuda_lib.build()
    assert second != first and second.exists() and calls


def test_nvcc_compiles_the_sources_and_no_header(fake_tree):
    """One ``-c`` call a ``.cu`` file, a link of their objects, and no
    ``.cuh`` on any command line."""
    csrc, calls = fake_tree
    cuda_lib.build()
    compiled = sorted(Path(c[c.index("-c") + 1]).name
                      for c in calls if "-c" in c)
    assert compiled == ["a.cu", "b.cu"]
    assert sum("-shared" in c for c in calls) == 1
    assert not any(arg.endswith(".cuh") for c in calls for arg in c)


def test_the_repository_header_is_hashed_not_compiled():
    """``hopper.cuh`` (the shared Hopper helpers) is a header of the real
    csrc/, included by both wgmma sources, and not a source."""
    names = {p.name for p in cuda_lib.headers()}
    assert "hopper.cuh" in names
    assert not any(p.suffix == ".cuh" for p in cuda_lib.sources())
    for src in ("flash_attention_wgmma.cu", "flash_attention_bwd.cu"):
        assert '#include "hopper.cuh"' in (cuda_lib.CSRC / src).read_text()
