"""Core workload abstractions: `Request`, the `WorkloadScenario` protocol,
and the two composable layers every synthetic scenario is built from —
an `ArrivalProcess` (when requests land) and a `TokenMix` (how big they
are).

The paper's evaluation (§6.1.2) replays Azure LLM inference traces, which
characterize each request by (arrival time, input tokens, output tokens).
`Request` is exactly that triple plus an id. A scenario is anything that
can turn (rate, duration, seed) into a deterministic `Request` list; the
built-in `Scenario` composition interleaves one arrival-gap draw with one
token-mix draw per request from a single seeded generator, so scenarios
are reproducible bit-for-bit across runs and platforms.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One LLM inference request (Azure LLM trace schema)."""

    req_id: int
    arrival_s: float
    input_tokens: int
    output_tokens: int


@runtime_checkable
class WorkloadScenario(Protocol):
    """Anything that deterministically produces a request stream.

    Implementations must be pure in (rate_rps, duration_s, seed): calling
    `generate` twice with the same arguments returns equal lists.
    """

    name: str

    def generate(self, rate_rps: float = 60.0, duration_s: float = 120.0,
                 seed: int = 0) -> list[Request]:
        ...


class ArrivalProcess(Protocol):
    """Stateful arrival-time layer: produces inter-arrival gaps.

    `next_gap(rng, t)` returns the gap from current time `t` to the next
    arrival, drawing only from `rng` (never from global state). Processes
    may keep per-run state (e.g. the MMPP regime), so a fresh instance is
    built for every `generate` call.
    """

    def next_gap(self, rng: np.random.Generator, t: float) -> float:
        ...


class TokenMix(Protocol):
    """Stateless token-size layer: samples one request's token counts."""

    def sample_one(self, rng: np.random.Generator) -> tuple[int, int]:
        ...


def request_stats(requests: list[Request]) -> dict:
    """Summary statistics of a request stream.

    An empty stream returns an explicit all-zero dict (no NaNs from
    zero-length medians) so callers can always read the same keys.
    """
    if not requests:
        return {"n_requests": 0, "input_median": 0.0, "input_mean": 0.0,
                "output_mean": 0.0, "output_median": 0.0,
                "duration_s": 0.0, "mean_rate_rps": 0.0}
    n_in = np.array([r.input_tokens for r in requests])
    n_out = np.array([r.output_tokens for r in requests])
    span = max(r.arrival_s for r in requests)
    return {
        "n_requests": len(requests),
        "input_median": float(np.median(n_in)),
        "input_mean": float(n_in.mean()),
        "output_mean": float(n_out.mean()),
        "output_median": float(np.median(n_out)),
        "duration_s": float(span),
        "mean_rate_rps": float(len(requests) / span) if span > 0 else 0.0,
    }
