"""The port stands alone: it imports neither JAX nor the ``repro``
package, its entry points refuse to run on a missing card unless the
caller asks for the CPU, and its trace registry is the reference's."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    """Every import, lazy ones inside functions included."""
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.core.proximity import ProximityEngine
    from repro_torch.kernels.intersect.ops import doc_member_mask
    from repro_torch.kernels.posting_decode.ops import DeviceDecoder
    from repro_torch.search.join import torch_window_join
    from repro_torch.search.service import SearchService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.array([[1, 2]], dtype=np.int64)
    with pytest.raises(RuntimeError):
        DeviceDecoder()
    with pytest.raises(RuntimeError):
        doc_member_mask(a[:, 0], a[:, 0])
    with pytest.raises(RuntimeError):
        torch_window_join(a, a, 1)
    with pytest.raises(RuntimeError):
        SearchService(object())
    with pytest.raises(RuntimeError):
        ProximityEngine(object())


def test_chip_smoke_fails_without_the_repo(tmp_path):
    """Alone in a directory (and here without a card) the script exits
    non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_trace_schema_copy_equals_reference():
    from repro.search import schema as ref
    from repro_torch.search import schema as port

    assert port.TRACE_SCHEMA == ref.TRACE_SCHEMA
    assert port.TRACE_COUNTERS == ref.TRACE_COUNTERS
