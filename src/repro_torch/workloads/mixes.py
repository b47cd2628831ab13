"""Token mixes — the *how big* layer of a workload scenario.

Each mix samples (input_tokens, output_tokens) for one request. The
lognormal fits follow the Splitwise [26] characterization of the public
Azure LLM inference traces, the same source the paper replays:

  conversation — median input ~1020 / mean ~1155, mean output ~211
  code         — much longer prompts (median ~2k) and very short
                 completions (median ~15): the classic code-assist shape
  long-context — document-scale prompts (median ~6k) with report-length
                 outputs; stresses KV-transfer and prefill paths

`sample_one` draws input then output from the shared generator — the
exact draw order the pre-subsystem `sim.trace.generate` used, which is
what keeps the `conversation-poisson` scenario bit-identical to it.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LognormalMix:
    """Independent clipped-lognormal input/output token distributions."""

    input_logmean: float
    input_logstd: float
    output_logmean: float
    output_logstd: float
    input_min: int = 8
    input_max: int = 8192
    output_min: int = 1
    output_max: int = 2048

    def sample_one(self, rng: np.random.Generator) -> tuple[int, int]:
        n_in = int(np.clip(
            rng.lognormal(self.input_logmean, self.input_logstd),
            self.input_min, self.input_max))
        n_out = int(np.clip(
            rng.lognormal(self.output_logmean, self.output_logstd),
            self.output_min, self.output_max))
        return n_in, n_out


@dataclasses.dataclass(frozen=True)
class BlendedMix:
    """Probabilistic mixture of component mixes (heterogeneous traffic).

    `components` is ((weight, mix), ...); weights need not be normalized.
    One uniform draw selects the component, then the component samples —
    three draws per request, deterministic per seed.
    """

    components: tuple

    def __post_init__(self):
        total = sum(w for w, _ in self.components)
        if not self.components or total <= 0:
            raise ValueError("BlendedMix needs positively weighted "
                             "components")
        cum, acc = [], 0.0
        for w, _ in self.components:
            acc += w / total
            cum.append(acc)
        object.__setattr__(self, "_cum", tuple(cum))

    def sample_one(self, rng: np.random.Generator) -> tuple[int, int]:
        u = rng.random()
        for edge, (_, mix) in zip(self._cum, self.components):
            if u <= edge:
                return mix.sample_one(rng)
        return self.components[-1][1].sample_one(rng)


# Splitwise Azure-conversation fit — field-for-field the defaults the
# deprecated `sim.trace.TraceConfig` shipped (bit-exactness contract).
CONVERSATION = LognormalMix(
    input_logmean=6.93, input_logstd=0.85,      # median ~1020 tokens
    output_logmean=4.92, output_logstd=0.95,    # mean ~210 tokens
    input_max=8192, output_max=2048,
)

# Splitwise Azure-code fit: long prompts, short completions.
CODE = LognormalMix(
    input_logmean=7.57, input_logstd=0.9,       # median ~1940 tokens
    output_logmean=2.7, output_logstd=0.8,      # median ~15 tokens
    input_max=8192, output_max=256,
)

# Document-scale prompts with report-length outputs.
LONG_CONTEXT = LognormalMix(
    input_logmean=8.7, input_logstd=0.6,        # median ~6000 tokens
    output_logmean=5.7, output_logstd=0.8,      # median ~300 tokens
    input_max=16384, output_max=4096,
)

# Production-like blend: conversation-dominated with a code tail.
BLENDED = BlendedMix(components=((0.7, CONVERSATION), (0.3, CODE)))
