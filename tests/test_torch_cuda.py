"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the fleet engine on CUDA against the same engine on the
CPU. Every test here needs an NVIDIA GPU and skips without one; this
file imports neither jax nor the reference, so it runs on a machine
that has only the port's dependencies:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.aging import DEFAULT_PARAMS
from repro_torch.kernels.aging_update import ops
from repro_torch.kernels.aging_update.ref import aging_update_ref
from repro_torch.sim import ExperimentConfig, run_experiment

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("n", [1, 7, 128, 1024, 5000, 8000, 1_280_000])
def test_aging_kernel_matches_plain_version(cuda_device, n):
    """The draws of the reference's TestAgingUpdateKernel; its bound."""
    rng = np.random.default_rng(n)
    args = [torch.tensor(a, dtype=torch.float32, device=cuda_device)
            for a in (rng.uniform(0, 0.05, n),
                      rng.choice([48.0, 51.08, 54.0], n),
                      rng.choice([0.0, 1.0], n),
                      rng.uniform(0, 1e5, n))]
    before = ops.KERNEL.launches
    out = ops.advance_fleet(*args, DEFAULT_PARAMS)
    assert ops.KERNEL.launches == before + 1
    ref = aging_update_ref(*args, DEFAULT_PARAMS)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-9)


def test_aging_kernel_rejects_mixed_devices(cuda_device):
    args = [torch.zeros(8, device=cuda_device) for _ in range(4)]
    args[2] = args[2].cpu()
    with pytest.raises(ValueError, match="is on cpu"):
        ops.advance_fleet(*args, DEFAULT_PARAMS)


def test_fleet_on_cuda_matches_cpu(cuda_device):
    """The torch backend through the CUDA kernel (two launches per
    idling period) agrees with the same backend on the CPU. Float32
    reductions run in another order on the card: 1e-5 relative."""
    cfg = ExperimentConfig(duration_s=60.0)
    ops.KERNEL.launches = 0
    on_gpu = run_experiment(cfg.with_engine("fleet", backend="torch"))
    assert ops.KERNEL.launches == 2 * 60
    on_cpu = run_experiment(cfg.with_engine("fleet", backend="torch",
                                            device="cpu"))
    assert on_gpu.completed == on_cpu.completed
    for a, b in ((on_gpu.mean_latency_s, on_cpu.mean_latency_s),
                 (on_gpu.fleet_yearly_kgco2eq, on_cpu.fleet_yearly_kgco2eq),
                 (on_gpu.mean_degradation_percentiles[50],
                  on_cpu.mean_degradation_percentiles[50])):
        assert _rel(a, b) < 1e-5
