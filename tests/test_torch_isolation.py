"""The port stands alone: no module of `src/repro_torch`,
`benchmarks_torch` or `examples_torch`, and not `chip_smoke.py`, imports
`jax` or the reference package `repro`; and without CUDA the port's GPU
entry points (the fleet engine, `launch.serve`, `launch.train`, the
examples `serve_cluster.py` and `train_small.py`, `chip_smoke.py`)
refuse to run rather than fall back to the CPU."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.sim import ExperimentConfig, run_experiment

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + sorted((REPO / "benchmarks_torch").glob("*.py")) \
    + sorted((REPO / "examples_torch").glob("*.py")) \
    + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(REPO)) for p in FILES])
def test_imports_neither_jax_nor_reference(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_leaves_reference_unloaded():
    code = ("import sys, repro_torch.sim, repro_torch.kernels;"
            "import repro_torch.kernels.aging_update.ops;"
            "import repro_torch.kernels.ssd_scan.ops, repro_torch.models.mamba2;"
            "import repro_torch.models, repro_torch.configs, repro_torch.core;"
            "import repro_torch.serving.engine, repro_torch.launch.serve;"
            "import repro_torch.telemetry, repro_torch.checkpoint.store;"
            "import repro_torch.launch.train, repro_torch.training.optimizer;"
            "import repro_torch.data.pipeline;"
            "import repro_torch.distributed.sharding;"
            "import repro_torch.distributed.hlo_analysis;"
            "import repro_torch.launch.mesh, repro_torch.launch.dryrun;"
            "import torch.distributed as dist;"
            "assert not dist.is_initialized();"
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'jax')])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(REPO / "src")))
    assert out.stdout.strip() == "[]"


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ExperimentConfig(duration_s=1.0).with_engine("fleet")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_experiment(cfg)


def test_serve_without_cuda_refuses():
    """`launch.serve` runs on the card unless `--device cpu`: with no
    CUDA it raises rather than falling back to the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama3-8b", "--smoke", "--requests", "1", "--new-tokens", "1"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "served" not in proc.stdout


def test_train_without_cuda_refuses():
    """`launch.train` runs on the card unless `--device cpu`: with no
    CUDA it raises rather than falling back to the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3-8b", "--smoke", "--steps", "1"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "loss" not in proc.stdout


@pytest.mark.parametrize("script,args,result", [
    ("serve_cluster.py", [], "requests x"),
    ("train_small.py", ["--steps", "1"], "loss"),
])
def test_example_without_cuda_refuses(script, args, result, tmp_path):
    """`examples_torch/serve_cluster.py` and `train_small.py` run on the
    card unless `--device cpu`: with no CUDA they raise before serving or
    training anything."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples_torch" / script), *args,
         *(["--ckpt-dir", str(tmp_path)] if script == "train_small.py"
           else [])],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert result not in proc.stdout
    assert not any(tmp_path.iterdir())


def _run_smoke(cwd: Path, **env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, **env))


def _prints_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except (ValueError, TypeError):
            continue
    return False


def test_chip_smoke_fails_without_cuda():
    proc = _run_smoke(REPO, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not _prints_result(proc.stdout)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert "no src/repro_torch" in proc.stderr
    assert not _prints_result(proc.stdout)
