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
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))
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
            "src/repro_torch/data/curation.py",
            "src/repro_torch/runtime/__init__.py",
            "src/repro_torch/runtime/chaos.py",
            "src/repro_torch/runtime/fault_tolerance.py",
            "src/repro_torch/core/dist_search.py",
            "src/repro_torch/index/sharded.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/models/__init__.py",
            "src/repro_torch/models/layers.py",
            "src/repro_torch/models/ssm.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/configs/__init__.py",
            "src/repro_torch/training/__init__.py",
            "src/repro_torch/training/optimizer.py",
            "src/repro_torch/training/step.py",
            "src/repro_torch/training/compress.py",
            "src/repro_torch/data/tokens.py",
            "src/repro_torch/checkpoint/__init__.py",
            "src/repro_torch/checkpoint/manager.py",
            "src/repro_torch/checkpoint/layout.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/runtime/sharding.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/runtime/roofline.py",
            "src/repro_torch/runtime/collectives.py",
            "src/repro_torch/runtime/op_cost.py",
            "src/repro_torch/configs/shapes.py",
            "src/repro_torch/launch/dryrun.py",
            "examples/torch_quickstart.py", "examples/torch_serve_search.py",
            "examples/torch_curation_pipeline.py",
            "examples/torch_train_lm.py"} <= names
    archs = {p.stem for p in (ROOT / "src" / "repro" / "configs").glob(
        "*.py") if p.stem != "__init__"}
    assert {f"src/repro_torch/configs/{a}.py" for a in archs} <= names
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
            "import repro_torch.core.dist_search, repro_torch.index.sharded\n"
            "import repro_torch.runtime.chaos\n"
            "import repro_torch.runtime.fault_tolerance\n"
            "import repro_torch.models.transformer, repro_torch.configs\n"
            "import repro_torch.data.tokens, repro_torch.checkpoint.layout\n"
            "import repro_torch.training.step, repro_torch.training.compress\n"
            "import repro_torch.checkpoint, repro_torch.launch.train\n"
            "import repro_torch.runtime.sharding, repro_torch.launch.mesh\n"
            "import repro_torch.runtime.roofline\n"
            "import repro_torch.runtime.collectives\n"
            "import repro_torch.runtime.op_cost, repro_torch.configs.shapes\n"
            "import repro_torch.launch.dryrun\n"
            "from repro_torch import configs\n"
            "[configs.get(a) for a in configs.list_archs()]\n"
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


def test_mesh_entry_points_without_a_device_raise_when_cuda_is_absent(
        monkeypatch, tmp_path):
    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.launch.mesh import (make_parallelism,
                                         make_test_parallelism)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_test_parallelism(2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_parallelism()
    save_pytree({"a": torch.ones(3)}, tmp_path, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_pytree({"a": torch.empty(3)}, tmp_path, 1)
    got = restore_pytree({"a": torch.empty(3)}, tmp_path, 1, device="cpu")
    assert got["a"].device.type == "cpu"
    assert make_test_parallelism(2, 2, device="cpu").mesh.size == 4
    assert make_parallelism(device="meta").mesh.size == 256


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


def test_sharded_entry_points_without_a_device_raise_when_cuda_is_absent(
        monkeypatch):
    from repro_torch.core import dist_search
    from repro_torch.serve import SearchService, ServeConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = np.random.default_rng(0).standard_normal((64, 128))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist_search.make_data_mesh(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist_search.FailoverShards.from_series(db, 2, (8,), 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchService.from_series(db, ServeConfig(failover_shards=2))
    svc = SearchService.from_series(db, ServeConfig(failover_shards=2),
                                    device="cpu")
    assert svc.backend.backend == "torch"
    svc.backend.engine.close()


def test_lm_entry_point_raises_when_cuda_is_absent(monkeypatch, capsys):
    from repro_torch.launch import serve as launcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launcher.main(["--gen", "1"])
    res = launcher.main(["--device", "cpu", "--gen", "1", "--batch", "1",
                         "--prompt-len", "4"])
    assert res["logits"].device.type == "cpu"
    assert "[serve] arch=granite-3-2b-smoke" in capsys.readouterr().out
