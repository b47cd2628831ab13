"""GPU timing constants of the Splitwise-style cluster model (copied
from `repro.sim.cluster`).

The fleet engine (`repro_torch.sim.fleetsim`) prices prefill, decode and
the KV-cache transfer with the same linear H100 model as the reference's
event engine, so it needs only these seven constants. The event engine
itself (`Cluster`, `Machine`, the prompt and token instances) joins this
module with ROADMAP queue A5.
"""
from __future__ import annotations

# ----------------------------- GPU model ------------------------------ #
PREFILL_BASE_S = 0.030          # fixed prefill overhead (H100, 70B-class)
PREFILL_PER_TOKEN_S = 1.2e-4    # prefill seconds per input token
DECODE_ITER_BASE_S = 0.025      # one batched decode forward pass
DECODE_ITER_PER_REQ_S = 4.0e-4  # marginal batch cost per active request
MAX_DECODE_BATCH = 64
KV_BYTES_PER_TOKEN = 320e3      # 70B-class fp16 KV per token (all layers)
IB_LINK_BW_BPS = 25e9           # 200 Gb/s InfiniBand
