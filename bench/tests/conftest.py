"""Shared fixtures of the benchmark's tests: the checkout's root on the
path, a card check made inside a fixture, and cells cut to a size the
CPU runs in seconds."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

def smoke_cell(name: str, dtype: str = "bfloat16", **traffic):
    """The cell `name` of BENCHMARK.json with its model cut to its
    family's smoke size (`SMOKE`: two layers, the published hidden size,
    so the logits keep the full model's scale) and its traffic to a few
    short requests (tests only)."""
    from bench.harness import load_cell
    cell = load_cell(name)
    conf = dict(cell.config, torch_dtype=dtype, **cell.family.SMOKE)
    mix = dict(cell.traffic, clients=3, slots=3, cache_len=96,
               prompt_len=[8, 64], requests_per_client=8, check_requests=3,
               trace_seconds=0.5)
    mix["output_len"] = [4, 24] if mix["output_len"][1] > 8 else [2, 4]
    mix.update(traffic)
    cell.config, cell.traffic = conf, mix
    return cell


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda")
