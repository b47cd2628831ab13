"""The one traffic generator: a mix's parameters (a JSON file under
`bench/traffic/`) and a seed give every client's requests.

A closed loop of `clients` clients, each sending its next request as soon
as its last one is done. The lengths come from a table fixed by the mix's
`table_seed`: row r holds `requests_per_client` pairs of (prompt tokens,
output tokens), each drawn log-uniform between the mix's bounds. The run's
seed assigns the rows to the clients (a permutation) and draws every
prompt's tokens uniformly over the vocabulary, so two seeds send the same
sizes in another order and with other tokens, and the work of a window
does not change with the seed. Each client's first request is sent during
set-up and stands for a conversation already under way: its output is
the row's first length times (r + 0.5) / clients, so the clients do not
all finish together when the window opens.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

KEYS = {"loop", "clients", "slots", "cache_len", "prompt_len", "output_len",
        "table_seed", "requests_per_client", "policy",
        "host_cores", "check_requests", "check_live", "trace_seconds"}


def check(t: dict, name: str) -> None:
    """Raise ValueError unless `t` is a closed-loop mix that fits its
    cache."""
    missing, extra = KEYS - set(t), set(t) - KEYS - {"why"}
    if missing or extra:
        raise ValueError(f"traffic {name}: missing {sorted(missing)}, "
                         f"unknown {sorted(extra)}")
    if t["loop"] != "closed":
        raise ValueError(f"traffic {name}: only the closed loop is "
                         f"generated, not {t['loop']!r}")
    if t["prompt_len"][1] + t["output_len"][1] > t["cache_len"]:
        raise ValueError(f"traffic {name}: the longest request does not "
                         f"fit cache_len {t['cache_len']}")
    if t["clients"] > t["slots"]:
        raise ValueError(f"traffic {name}: more clients than slots")


def log_uniform(rng, lo: int, hi: int, size) -> np.ndarray:
    """Integers in [lo, hi], log-uniform."""
    x = np.exp(rng.uniform(math.log(lo), math.log(hi + 1), size))
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class Request:
    client: int
    index: int              # the client's k-th request
    prompt: list
    max_new_tokens: int


class Traffic:
    def __init__(self, t: dict, vocab: int, seed: int):
        self.t, self.vocab, self.seed = t, vocab, seed % 2**63
        rng = np.random.default_rng(t["table_seed"])
        shape = (t["clients"], t["requests_per_client"])
        self.prompt_len = log_uniform(rng, *t["prompt_len"], shape)
        self.output_len = log_uniform(rng, *t["output_len"], shape)
        self.row = np.random.default_rng(self.seed).permutation(
            t["clients"])

    def request(self, client: int, k: int) -> Request:
        r = int(self.row[client])
        j = k % self.t["requests_per_client"]
        out = int(self.output_len[r, j])
        if k == 0:
            out = max(1, math.ceil(out * (r + 0.5) / self.t["clients"]))
        rng = np.random.default_rng([self.seed, client, k])
        prompt = rng.integers(0, self.vocab, int(self.prompt_len[r, j]))
        return Request(client, k, prompt.tolist(), out)

    def longest_prompt(self) -> int:
        return int(self.prompt_len.max())
