"""The port stands alone: it imports neither JAX (nor ``ml_dtypes``,
which ships with JAX) nor the reference package, and its entry points do
not quietly fall back to the CPU."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def imported_modules(path: pathlib.Path) -> set:
    """Top-level names of every absolute import in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_port_files_import_neither_jax_nor_reference():
    assert len(PORT_FILES) > 15
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/index/quantized.py",
            "src/repro_torch/index/store.py",
            "src/repro_torch/index/mutable.py",
            "src/repro_torch/index/cli.py",
            "src/repro_torch/core/subseq.py",
            "src/repro_torch/core/search.py",
            "src/repro_torch/kernels/level_ops.py",
            "src/repro_torch/obs/__init__.py",
            "src/repro_torch/obs/trace.py",
            "src/repro_torch/obs/spans.py",
            "src/repro_torch/obs/calibration.py",
            "src/repro_torch/obs/metrics.py",
            "src/repro_torch/data/curation.py"} <= names
    offenders = {str(p.relative_to(ROOT)): sorted(
                     imported_modules(p) & set(FORBIDDEN))
                 for p in PORT_FILES}
    assert {k: v for k, v in offenders.items() if v} == {}
    # The scan sees the imports it is meant to catch.
    probe = ROOT / "tests" / "test_torch_isolation.py"
    assert {"numpy", "torch"} <= imported_modules(probe)


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.serve, repro_torch.launch.serve\n"
            "import repro_torch.kernels.fused_query\n"
            "import repro_torch.index.quantized, repro_torch.index.store\n"
            "import repro_torch.index.mutable, repro_torch.index.cli\n"
            "import repro_torch.core.subseq, repro_torch.core.search\n"
            "import repro_torch.kernels.level_ops\n"
            "import repro_torch.obs, repro_torch.obs.metrics\n"
            "import repro_torch.data.curation\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'repro')]\n"
            "assert not bad, bad\n")
    env_path = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr


def test_entry_points_without_a_device_raise_when_cuda_is_absent(monkeypatch):
    from repro_torch.core import engine
    from repro_torch.core.fastsax import FastSAXConfig, build_index
    from repro_torch.serve import SearchService, ServeConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = np.random.default_rng(0).standard_normal((64, 128))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.build_device_index(db, (8,), 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.device_index_from_host(
            build_index(db, FastSAXConfig(n_segments=(8,))))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.device_index_from_numpy(
            db, (db * db).sum(-1), [np.zeros((64, 8), np.int32)],
            [np.zeros(64)], (8,), 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchService.from_series(db, ServeConfig())
    # Asking for the CPU works, and then the torch engine serves.
    svc = SearchService.from_series(db, ServeConfig(), device="cpu")
    assert svc.backend.backend == "torch"


def test_tiered_entry_points_without_a_device_raise_when_cuda_is_absent(
        monkeypatch):
    from repro_torch.core import engine
    from repro_torch.core.fastsax import FastSAXConfig, build_index
    from repro_torch.index.quantized import quantize_host_index
    from repro_torch.serve import SearchService, ServeConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = np.random.default_rng(0).standard_normal((200, 64))
    host = build_index(db, FastSAXConfig(n_segments=(4, 8)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.quantized_device_index(quantize_host_index(host, "int8"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.TieredIndex.from_host(host, "bf16")
    cfg = ServeConfig(levels=(4, 8), quantization="int8")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchService.from_series(db, cfg)
    svc = SearchService.from_series(db, cfg, device="cpu")
    assert svc.backend.backend == "torch"
    assert svc.backend.tindex.dev.device.type == "cpu"
