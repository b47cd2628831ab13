"""Continuous-batching inference engine with aging-aware host-CPU core
management — the paper's technique as a first-class serving feature (the
counterpart of `repro.serving.engine`).

The engine owns a fixed pool of batch slots backed by one device-resident
KV cache (per-slot positions), performs ORCA-style iteration-level
scheduling, and routes every host-side operation through a `CoreManager`
(Table-2 task taxonomy): request submission -> `submit`, slot allocation
-> `alloc_memory`, each batched decode iteration -> `start_iteration`,
completion -> `finish_request`/`free_memory`. The manager's Selective
Core Idling runs on a wall-clock period, so an idle engine deep-idles its
host cores (age-halting) and a bursty one wakes them.

It serves the decoder-only families, as the reference's engine does:
dense and mixture-of-experts models with GQA or MLA attention (an MLA
cache holds the compressed latent per slot), the vision-frontend family
(InternVL2; text only: the engine passes no frontend embeddings, as the
reference's does) and Mamba2. Like the reference's, it refuses the
hybrid and encoder-decoder families: drive those through
`Model.prefill` and `Model.decode_step`. Differences from the
reference: the model (`repro_torch.models.Model`) carries its own
weights, so the engine takes no `params`; the cache is updated in
place. For the
ssm family the cache holds W-1 rows of conv history per slot, where the
reference's engine sizes it from a one-token prefill and holds one
(ROADMAP R6).

Tracing: set `engine.trace` to a `TelemetryHub` of its own (not the
core manager's `telemetry`, whose probes match the reference's) and the
engine records spans into it, on `time.perf_counter_ns`:

- `step` (its `n`: the slots active after admission), with children
  `periodic`, `admit`, `select`, `wait` (the host blocked on the
  device), `decode` (`n`: the active slots) and `retire`;
- `admit`, one per admitted request, with children `upload`, `prefill`
  (`n`: the prompt's tokens), `splice`, `select` and `wait`;
- `queued`, a root, from a request's `submit` to the start of its
  `admit` (`n`: the prompt's tokens);
- `cpu_task/<task>` around each Table-2 task, a child of the span open
  at the time.

Spans of one request carry its id (`req`). On CUDA `prefill` and
`decode` carry a pair of device events (`Span.device_ms()`, read once
the work is done; nothing synchronizes while serving). Counters:
`steps`, `admissions`, `prefill_tokens`, `decode_calls`,
`decode_tokens`, which `prometheus_text()` lists with `spans_dropped`.
With `trace` None each site costs one `is not None` test.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import CoreManager, CorePolicy
from repro_torch.models import Model
from repro_torch.sim.tasks import TaskIdAllocator
from repro_torch.telemetry import TelemetryHub, prometheus_text


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: list[int]
    max_new_tokens: int
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_ns: int | None = None     # stamped only while tracing


class InferenceEngine:
    """Serves requests on `model`'s device.

    `greedy=False` samples with a `torch.Generator` seeded from
    `sample_seed`: reproducible for a seed, but not the reference's
    `jax.random` draws.
    """

    def __init__(self, model: Model, max_batch: int = 8,
                 max_len: int = 256,
                 policy: CorePolicy | str = "proposed",
                 num_host_cores: int = 16,
                 eos_id: int | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 greedy: bool = True, temperature: float = 1.0,
                 sample_seed: int = 0, telemetry=None):
        cfg = model.cfg
        if cfg.family in ("hybrid", "audio") or cfg.is_encdec:
            raise NotImplementedError(
                "engine batching supports decoder-only families "
                "(dense/moe/vlm/ssm); use Model.decode_step directly")
        self.model = model
        self.device = model.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.greedy = greedy
        self.temperature = temperature
        self._sample_gen = torch.Generator(
            device=self.device).manual_seed(sample_seed)
        self.clock = clock
        self._t0 = clock()
        # Live serving shares the simulator's telemetry surface: the same
        # hub type, the same probes, exported via `prometheus_text()`.
        self.telemetry = telemetry
        self.trace: TelemetryHub | None = None   # the engine's own spans
        self.core_manager = CoreManager(num_host_cores, policy=policy,
                                        rng=np.random.default_rng(0),
                                        telemetry=telemetry)
        self._task_ids = TaskIdAllocator()   # per-engine CPU-task id stream
        self._last_idle_check = 0.0

        self.slots: list[Request | None] = [None] * max_batch
        self.pending: list[Request] = []
        self.cache = self._empty_cache()
        self.tokens = torch.zeros((max_batch, 1), dtype=torch.int32,
                                  device=self.device)
        self.active_mask = np.zeros(max_batch, bool)
        self._next_id = 0

    # ------------------------- device functions ------------------------ #
    def _empty_cache(self):
        """The model's cache for `max_batch` slots (`Model.empty_cache`:
        K and V, MLA's latent, or Mamba2's conv history and state) with a
        per-slot `pos`."""
        cache = self.model.empty_cache(self.max_batch, self.max_len)
        cache["pos"] = torch.zeros(self.max_batch, dtype=torch.int32,
                                   device=self.device)
        return cache

    def _prefill_fn(self, tokens):
        return self.model.prefill(tokens, max_len=self.max_len)

    def _decode_fn(self, cache, tokens, active):
        old_pos = cache["pos"]
        logits, new_cache = self.model.decode_step(cache, tokens)
        # inactive slots must not advance their position
        new_cache["pos"] = torch.where(active, new_cache["pos"], old_pos)
        return logits, new_cache

    # ----------------------------- host API ---------------------------- #
    def _now(self) -> float:
        return self.clock() - self._t0

    def _cpu_task(self, name: str, req_id: int = -1) -> None:
        """Account one Table-2 host task against the core manager."""
        tr = self.trace
        if tr is not None:
            sp = tr.begin(f"cpu_task/{name}", req_id)
        task = self._task_ids.new(name)
        t = self._now()
        self.core_manager.assign(task.task_id, t)
        self.core_manager.release(task.task_id, t + task.duration_s)
        if tr is not None:
            tr.end(sp)

    def _periodic(self) -> None:
        t = self._now()
        if t - self._last_idle_check >= self.core_manager.idling_period_s:
            tr = self.trace
            if tr is not None:
                sp = tr.begin("periodic")
            self.core_manager.periodic(t)
            if tr is not None:
                tr.end(sp)
            self._last_idle_check = t

    def _device_span(self, tr: TelemetryHub, name: str, req: int = -1,
                     n: int = 0):
        """Begin span `name`; on CUDA, record its first device event on
        the current stream (`_end_device_span` records the second)."""
        sp = tr.begin(name, req, n)
        if self.device.type == "cuda":
            sp.dev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            sp.dev[0].record(torch.cuda.current_stream(self.device))
        return sp

    def _end_device_span(self, tr: TelemetryHub, sp) -> None:
        if sp.dev is not None:
            sp.dev[1].record(torch.cuda.current_stream(self.device))
        tr.end(sp)

    def submit(self, prompt: list[int], max_new_tokens: int = 32) -> int:
        req = Request(self._next_id, list(prompt), max_new_tokens)
        if self.trace is not None:
            req.submitted_ns = time.perf_counter_ns()
        self._cpu_task("submit", req.req_id)
        self._next_id += 1
        self.pending.append(req)
        return req.req_id

    def _admit(self) -> None:
        tr = self.trace
        for i in range(self.max_batch):
            if self.slots[i] is not None or not self.pending:
                continue
            req = self.pending.pop(0)
            rid, n_prompt = req.req_id, len(req.prompt)
            if tr is not None:
                adm = tr.begin("admit", rid)
                if req.submitted_ns is not None:
                    tr.record("queued", req.submitted_ns, adm.start, rid,
                              n_prompt)
                tr.inc("admissions")
                tr.inc("prefill_tokens", n_prompt)
            self._cpu_task("alloc_memory", rid)
            if tr is not None:
                sp = tr.begin("upload", rid)
            toks = torch.tensor([req.prompt], dtype=torch.int32,
                                device=self.device)
            if tr is not None:
                tr.end(sp)
                sp = self._device_span(tr, "prefill", rid, n_prompt)
            logits, pcache = self._prefill_fn(toks)
            if tr is not None:
                self._end_device_span(tr, sp)
                sp = tr.begin("splice", rid)
            # splice the single-row prefill cache into slot i; this also
            # overwrites what the slot wrote while it was inactive
            for key, big in self.cache.items():
                if key != "pos":
                    big[:, i] = pcache[key][:, 0]
            self.cache["pos"][i] = n_prompt
            if tr is not None:
                sp = tr.switch(sp, "select")
            first = self._select_token(logits[:, -1])
            if tr is not None:
                sp = tr.switch(sp, "wait")
            req.output.append(int(first[0]))
            if tr is not None:
                tr.end(sp)
            self.tokens[i, 0] = first[0]
            self.slots[i] = req
            self.active_mask[i] = True
            if tr is not None:
                tr.end(adm)

    def _select_token(self, logits_row: torch.Tensor) -> torch.Tensor:
        v = self.model.cfg.vocab_size
        logits_row = logits_row[..., :v]
        if self.greedy:
            return torch.argmax(logits_row, -1).to(torch.int32)
        probs = torch.softmax(logits_row.float() / self.temperature, -1)
        return torch.multinomial(probs, 1, generator=self._sample_gen)[
            ..., 0].to(torch.int32)

    def step(self) -> list[tuple[int, int]]:
        """One engine iteration: admit pending, batched decode, retire
        finished. Returns [(req_id, new_token), ...]."""
        tr = self.trace
        if tr is not None:
            top = tr.begin("step")
            tr.inc("steps")
        self._periodic()
        self._admit()
        if not self.active_mask.any():
            if tr is not None:
                tr.end(top)
            return []
        if tr is not None:
            top.n = n_active = int(self.active_mask.sum())
            tr.inc("decode_calls")
            tr.inc("decode_tokens", n_active)
        self._cpu_task("start_iteration")
        active = torch.as_tensor(self.active_mask, device=self.device)
        if tr is not None:
            sp = self._device_span(tr, "decode", n=n_active)
        logits, self.cache = self._decode_fn(self.cache, self.tokens,
                                             active)
        if tr is not None:
            self._end_device_span(tr, sp)
            sp = tr.begin("select")
        new_tokens = self._select_token(logits[:, 0])
        # every occupied slot takes its new token (one device op)
        self.tokens = torch.where(active[:, None], new_tokens[:, None],
                                  self.tokens)
        if tr is not None:
            sp = tr.switch(sp, "wait")
        host_tokens = new_tokens.tolist()
        if tr is not None:
            sp = tr.switch(sp, "retire")
        out = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = host_tokens[i]
            req.output.append(tok)
            out.append((req.req_id, tok))
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if len(req.output) >= req.max_new_tokens or hit_eos:
                req.done = True
                self._cpu_task("finish_request", req.req_id)
                self._cpu_task("free_memory", req.req_id)
                self.slots[i] = None
                self.active_mask[i] = False
        if tr is not None:
            tr.end(sp)
            tr.end(top)
        return out

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.pending and not self.active_mask.any():
                return
            self.step()
        raise RuntimeError("engine did not drain")

    # -------------------------- observability -------------------------- #
    def host_cpu_report(self) -> dict:
        m = self.core_manager
        return {
            "policy": m.policy_name,
            "frequencies": m.frequencies(self._now()).tolist(),
            "cv": m.frequency_cv(),
            "mean_degradation": m.mean_frequency_degradation(),
            "active_cores": int((m.c_state == 0).sum()),
            "assigns": m.metrics.assigns,
        }

    def prometheus_text(self) -> str:
        """Prometheus-style text snapshot of the engine's host CPU —
        the telemetry hub's probes (when one is attached) plus live
        aging gauges, one metrics surface shared with the simulator's
        exports (`repro_torch.telemetry.prometheus_text`). Serve it with
        `repro_torch.telemetry.start_metrics_server(engine.prometheus_text)`.
        """
        hub = self.telemetry if self.telemetry is not None \
            else TelemetryHub()
        m = self.core_manager
        extra = {
            "host_freq_cv": m.frequency_cv(self._now()),
            "host_mean_degradation": m.mean_frequency_degradation(),
            "host_active_cores": float((m.c_state == 0).sum()),
            "host_assigns": float(m.metrics.assigns),
            "host_oversub_assigns": float(m.metrics.oversub_assigns),
        }
        text = prometheus_text(hub, extra_gauges=extra)
        tr = self.trace
        if tr is not None and tr.counters:
            # the engine's serving totals (steps, admissions, tokens) and
            # the spans its full ring dropped
            text += prometheus_text(
                tr, extra_gauges={"spans_dropped": float(tr.spans_dropped)})
        return text
