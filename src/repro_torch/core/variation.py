"""Process-variation model for initial core frequencies f0 (paper §3.2).

Chip area is a 10x10 grid; each cell gets a Gaussian random variable p_kl
with spatial correlation rho_{ij,kl} = exp(-alpha * dist(ij, kl))
[Raghunathan '13].  Critical paths live entirely inside cells, and

    f0(core) = K' * min_{k,l in core's cells} (1 / p_kl)

The mean of p is solved so that a variation-free chip hits the nominal
frequency: p == mu everywhere => f0 = K'/mu = f_nominal => mu = K'/f_nominal.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass(frozen=True)
class VariationParams:
    n_chip: int = 10          # grid is n_chip x n_chip
    k_prime: float = 1.0      # technology constant K'
    alpha: float = 0.5        # spatial correlation decay
    sigma_frac: float = 0.05  # sigma as a fraction of the mean
    f_nominal: float = 1.0


@functools.lru_cache(maxsize=8)
def _correlation_cholesky(n_chip: int, alpha: float) -> np.ndarray:
    """Cholesky factor of the grid correlation matrix (cached)."""
    coords = np.stack(
        np.meshgrid(np.arange(n_chip), np.arange(n_chip), indexing="ij"), -1
    ).reshape(-1, 2).astype(np.float64)
    d = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
    corr = np.exp(-alpha * d)
    # jitter for numerical PSD safety
    corr += 1e-10 * np.eye(corr.shape[0])
    return np.linalg.cholesky(corr)


def sample_grid(params: VariationParams, rng: np.random.Generator) -> np.ndarray:
    """Sample one chip's correlated p grid, shape (n_chip, n_chip)."""
    n = params.n_chip
    chol = _correlation_cholesky(n, params.alpha)
    z = rng.standard_normal(n * n)
    mu = params.k_prime / params.f_nominal
    sigma = params.sigma_frac * mu
    p = mu + sigma * (chol @ z)
    # p is a delay-like quantity; keep it strictly positive.
    p = np.clip(p, 0.2 * mu, None)
    return p.reshape(n, n)


def core_cell_partition(n_chip: int, num_cores: int) -> list[np.ndarray]:
    """Assign grid cells to cores contiguously in raster order.

    Every core owns >= 1 cell; when num_cores > cells, cores share cells
    round-robin (still deterministic).
    """
    cells = np.arange(n_chip * n_chip)
    if num_cores <= len(cells):
        return [np.asarray(chunk) for chunk in np.array_split(cells, num_cores)]
    return [np.asarray([cells[i % len(cells)]]) for i in range(num_cores)]


def sample_initial_frequencies(
    params: VariationParams, num_cores: int, rng: np.random.Generator
) -> np.ndarray:
    """Per-core f0 for one chip: K' * min over owned cells of 1/p."""
    grid = sample_grid(params, rng).reshape(-1)
    parts = core_cell_partition(params.n_chip, num_cores)
    f0 = np.array(
        [params.k_prime * np.min(1.0 / grid[cells]) for cells in parts],
        dtype=np.float64,
    )
    return f0
