"""`Scenario` — composition of an arrival process and a token mix —
plus the built-in scenario library.

A `Scenario` turns (rate_rps, duration_s, seed) into a `Request` list by
interleaving one arrival-gap draw with one token-mix draw per request
from a single `np.random.default_rng(seed)`. For the homogeneous-Poisson
conversation scenario this reproduces the pre-subsystem
`sim.trace.generate` draw sequence exactly, so `conversation-poisson`
is bit-identical to the legacy generator (golden-pinned in
tests/test_workloads.py).

Built-ins registered here (see `available_scenarios()`):

  conversation-poisson    — the paper's default Azure-conversation load
  conversation-constant   — same mix, deterministic fixed-gap arrivals
  conversation-diurnal    — day/night sinusoidal swing (EcoServe-style)
  conversation-mmpp       — two-state Markov-modulated bursts
  conversation-flashcrowd — rectangular traffic spike mid-trace
  code-poisson            — Splitwise code mix (long in / short out)
  longcontext-poisson     — document-scale prompts
  mixed-poisson           — 70/30 conversation/code blend
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.workloads import arrivals as arr
from repro_torch.workloads import mixes
from repro_torch.workloads.base import ArrivalProcess, Request, TokenMix
from repro_torch.workloads.registry import register_scenario


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named (arrival process x token mix) workload scenario.

    `arrival_factory(rate_rps, duration_s)` builds a fresh (possibly
    stateful) arrival process per generate call; `mix` is stateless and
    shared.
    """

    name: str
    mix: TokenMix
    arrival_factory: Callable[[float, float], ArrivalProcess]
    description: str = ""

    def generate(self, rate_rps: float = 60.0, duration_s: float = 120.0,
                 seed: int = 0) -> list[Request]:
        if rate_rps <= 0 or duration_s <= 0:
            raise ValueError("rate_rps and duration_s must be positive, "
                             f"got {rate_rps}/{duration_s}")
        rng = np.random.default_rng(seed)
        process = self.arrival_factory(rate_rps, duration_s)
        requests: list[Request] = []
        t = 0.0
        while True:
            t += process.next_gap(rng, t)
            if t >= duration_s:
                break
            n_in, n_out = self.mix.sample_one(rng)
            requests.append(Request(len(requests), t, n_in, n_out))
        return requests


# --------------------------- built-ins -------------------------------- #

@register_scenario("conversation-poisson")
def conversation_poisson() -> Scenario:
    return Scenario(
        "conversation-poisson", mixes.CONVERSATION,
        lambda rate, dur: arr.PoissonArrivals(rate),
        "Azure-conversation mix, homogeneous Poisson arrivals (the "
        "paper's default; bit-exact vs the legacy TraceConfig generator)")


@register_scenario("conversation-constant")
def conversation_constant() -> Scenario:
    return Scenario(
        "conversation-constant", mixes.CONVERSATION,
        lambda rate, dur: arr.ConstantArrivals(rate),
        "Azure-conversation mix, deterministic fixed-gap arrivals "
        "(closed-loop load generator)")


@register_scenario("conversation-diurnal")
def conversation_diurnal(amplitude: float = 0.6,
                         period_s: float | None = None,
                         phase: float = 0.0) -> Scenario:
    # By default one full diurnal cycle is time-compressed into the
    # trace (period = duration): a wall-clock 86400 s period would be
    # flat — indistinguishable from plain Poisson — over the 30-120 s
    # traces the benchmarks run. Pass period_s for wall-clock replay.
    return Scenario(
        "conversation-diurnal", mixes.CONVERSATION,
        lambda rate, dur: arr.DiurnalPoissonArrivals(
            rate, amplitude=amplitude,
            period_s=period_s if period_s is not None else dur,
            phase=phase),
        "Azure-conversation mix with a sinusoidal day/night rate swing "
        f"(peak:trough {(1 + amplitude) / (1 - amplitude):.1f}:1; one "
        "cycle per trace unless period_s is given)")


@register_scenario("conversation-mmpp")
def conversation_mmpp(burst_factor: float = 6.0,
                      quiet_sojourn_s: float = 20.0,
                      burst_sojourn_s: float = 4.0) -> Scenario:
    return Scenario(
        "conversation-mmpp", mixes.CONVERSATION,
        lambda rate, dur: arr.MMPPArrivals(
            rate, burst_factor=burst_factor,
            quiet_sojourn_s=quiet_sojourn_s,
            burst_sojourn_s=burst_sojourn_s),
        "Azure-conversation mix under two-state Markov-modulated bursts "
        f"({burst_factor:g}x burst regime)")


@register_scenario("conversation-flashcrowd")
def conversation_flashcrowd(spike_multiplier: float = 8.0,
                            spike_start_frac: float = 1 / 3,
                            spike_duration_frac: float = 1 / 6) -> Scenario:
    return Scenario(
        "conversation-flashcrowd", mixes.CONVERSATION,
        lambda rate, dur: arr.FlashCrowdArrivals(
            rate, spike_multiplier=spike_multiplier,
            spike_start_s=spike_start_frac * dur,
            spike_duration_s=spike_duration_frac * dur,
            norm_duration_s=dur),
        "Azure-conversation mix with a rectangular flash-crowd spike "
        f"({spike_multiplier:g}x for {spike_duration_frac:.0%} of the "
        "trace)")


@register_scenario("code-poisson")
def code_poisson() -> Scenario:
    return Scenario(
        "code-poisson", mixes.CODE,
        lambda rate, dur: arr.PoissonArrivals(rate),
        "Splitwise Azure-code mix (long prompts, short completions), "
        "Poisson arrivals")


@register_scenario("longcontext-poisson")
def longcontext_poisson() -> Scenario:
    return Scenario(
        "longcontext-poisson", mixes.LONG_CONTEXT,
        lambda rate, dur: arr.PoissonArrivals(rate),
        "Document-scale prompts with report-length outputs, Poisson "
        "arrivals")


@register_scenario("mixed-poisson")
def mixed_poisson(conversation_weight: float = 0.7) -> Scenario:
    mix = mixes.BlendedMix(components=(
        (conversation_weight, mixes.CONVERSATION),
        (1.0 - conversation_weight, mixes.CODE)))
    return Scenario(
        "mixed-poisson", mix,
        lambda rate, dur: arr.PoissonArrivals(rate),
        f"{conversation_weight:.0%} conversation / "
        f"{1 - conversation_weight:.0%} code blend, Poisson arrivals")
