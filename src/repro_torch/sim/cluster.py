"""Splitwise-style LLM inference cluster model (paper §5, §6.1): the
event engine of the port, copied from `repro.sim.cluster`.

Topology matches the paper's experimental cluster: 22 GPU machines run a
phase-splitting deployment with 5 *prompt* instances and 17 *token*
instances (iso-throughput power-optimized design from Splitwise [26]).
Every serving step lands a Table-2 CPU task on the host CPU of the machine
executing it; each machine's CPU is governed by a `CoreManager` (proposed
technique or a baseline policy).

GPU execution times use a linear H100 performance model (prefill cost per
input token; ORCA-style iteration-level batched decode), and the KV-cache
transfer between prompt and token machines crosses an InfiniBand link and
fires `flow_completion` on the receiving host — the same structure
splitwise-sim models. The fleet engine (`repro_torch.sim.fleetsim`)
prices its GPU work with the same seven constants.

The event loop is host numpy float64, bit-identical to the reference,
its fault layer (`FaultCoordinator`: injection, health-aware dispatch,
retries with backoff, hedging, robustness accounting) included, and
so are its telemetry hooks (`repro_torch.telemetry`): the route counters
and events, the sampler's three `fleet/*` series, every machine's
`CoreManager` probes and the coordinator's four fault events.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Callable

import numpy as np

from repro_torch.core import OVERSUBSCRIBED, CoreManager
from repro_torch.faults import FaultView, get_fault_model
from repro_torch.hardware.inventory import resolve_fleet
from repro_torch.sim.config import ExperimentConfig
from repro_torch.sim.events import EventQueue
from repro_torch.sim.fleetstate import FleetAgingSettler, GroupedAgingSettler
from repro_torch.sim.latency import LatencyAggregate
from repro_torch.sim.routing import FleetView, get_router
from repro_torch.sim.tasks import TASK_DURATIONS_S, TaskIdAllocator
from repro_torch.workloads import Request

# ----------------------------- GPU model ------------------------------ #
PREFILL_BASE_S = 0.030          # fixed prefill overhead (H100, 70B-class)
PREFILL_PER_TOKEN_S = 1.2e-4    # prefill seconds per input token
DECODE_ITER_BASE_S = 0.025      # one batched decode forward pass
DECODE_ITER_PER_REQ_S = 4.0e-4  # marginal batch cost per active request
MAX_DECODE_BATCH = 64
KV_BYTES_PER_TOKEN = 320e3      # 70B-class fp16 KV per token (all layers)
IB_LINK_BW_BPS = 25e9           # 200 Gb/s InfiniBand
OVERSUB_SLOWDOWN = 2.0          # time-sharing penalty for oversubscribed tasks


@dataclasses.dataclass
class RequestState:
    req: Request
    remaining: int
    t_arrival: float
    t_first_token: float = -1.0
    t_done: float = -1.0
    # fault-layer bookkeeping (untouched when faults are off):
    # dispatch attempts so far, whether any machine ever admitted it,
    # and whether the retry budget was exhausted.
    attempts: int = 0
    admitted: bool = False
    failed: bool = False


class Machine:
    """One inference server: host CPU (CoreManager) + a GPU instance."""

    def __init__(self, machine_id: int, cfg: ExperimentConfig,
                 queue: EventQueue, task_ids: TaskIdAllocator | None = None,
                 telemetry=None, track_inflight: bool = False, hw=None):
        self.machine_id = machine_id
        self.queue = queue
        # Heterogeneous fleets (`repro_torch.hardware`): `hw` is this
        # machine's resolved `HardwareSKU`, or None on the uniform
        # default — which passes CoreManager exactly the historical
        # arguments (bit-exact).
        self.sku = hw
        hw_kwargs = {} if hw is None else {
            "aging_params": hw.aging_params(),
            "variation_params": hw.variation_params(),
        }
        # Cluster-shared id stream (falls back to a private one so a
        # Machine can still be built standalone in tests/examples).
        self.task_ids = task_ids if task_ids is not None else TaskIdAllocator()
        # Each machine instantiates its own policy from the registry name
        # (policies carry per-server state and cannot be shared).
        self.manager = CoreManager(
            cfg.num_cores if hw is None else hw.num_cores,
            policy=cfg.policy,
            policy_opts=cfg.policy_options,
            **hw_kwargs,
            rng=np.random.default_rng(cfg.seed * 1000 + machine_id),
            idling_period_s=cfg.idling_period_s,
            on_promote=self._on_promote,
            on_demote=self._on_demote,
            res_window_s=cfg.resolved_power_window_s,
            telemetry=telemetry,
            telemetry_id=machine_id,
        )
        self.running_cpu_tasks = 0
        self.task_count_samples: list[int] = []
        # Oversubscribed tasks still in flight, keyed by task id:
        # [work_left (nominal s), rate (work/s), t_progress, gen, on_done].
        # A promotion reschedules the completion event; `gen` marks the
        # superseded event stale (the EventQueue has no cancellation).
        self._oversub_inflight: dict[int, list] = {}
        # Fault layer: when faults are active EVERY task is tracked in
        # `_oversub_inflight` (not just oversubscribed ones) so in-flight
        # work can be rebanked on core failure / stall and cleanly killed
        # on machine crash. Off by default — the faultless hot path is
        # untouched.
        self._track_all = bool(track_inflight)
        self.up = True
        # Bumped on every crash: closures over GPU / flow completions
        # capture the epoch at schedule time and discard themselves when
        # the machine crashed in between.
        self.epoch = 0

    def run_cpu_task(self, name: str, on_done=None) -> None:
        """Spawn a Table-2 CPU task; completion latency reflects core
        aging (degraded frequency) and oversubscription time-sharing.

        An oversubscribed task progresses at the time-shared rate until
        the manager promotes it onto a freed core, at which point its
        remaining duration is recomputed from the promoted core's
        settled frequency (`_on_promote`)."""
        tid = self.task_ids.next_id()
        work = TASK_DURATIONS_S[name]
        now = self.queue.now
        speed = self.manager.assign(tid, now)
        rate = max(speed, 1e-6)
        dur = work / rate
        tracked = self.manager.core_of_task.get(tid) == OVERSUBSCRIBED
        if tracked:
            dur *= OVERSUB_SLOWDOWN
            self._oversub_inflight[tid] = [
                work, rate / OVERSUB_SLOWDOWN, now, 0, on_done]
        elif self._track_all:
            tracked = True
            self._oversub_inflight[tid] = [work, rate, now, 0, on_done]
        self.running_cpu_tasks += 1
        self._schedule_finish(tid, dur, 0, on_done, tracked)

    def _schedule_finish(self, tid: int, dur: float, gen: int,
                         on_done, tracked: bool) -> None:
        def _finish():
            if tracked:
                # Tracked (once-oversubscribed) tasks may have two finish
                # events in flight: a missing entry means the current-gen
                # event already completed the task, a gen mismatch means
                # a promotion superseded this event — either way, stale.
                st = self._oversub_inflight.get(tid)
                if st is None or st[3] != gen:
                    return
                del self._oversub_inflight[tid]
            self.manager.release(tid, self.queue.now)
            self.running_cpu_tasks -= 1
            if on_done is not None:
                on_done()

        self.queue.schedule_in(dur, _finish)

    def _on_promote(self, tid: int, core: int, now: float,
                    speed: float) -> None:
        """Manager moved `tid` from the oversubscription queue onto
        `core`: bank the progress made at the old time-shared rate and
        reschedule completion at the promoted core's settled speed."""
        st = self._oversub_inflight.get(tid)
        if st is None:
            return
        work_left, rate, t_progress, gen, on_done = st
        work_left = max(work_left - (now - t_progress) * rate, 0.0)
        rate = max(speed, 1e-6)
        st[:] = [work_left, rate, now, gen + 1, on_done]
        self._schedule_finish(tid, work_left / rate, gen + 1, on_done, True)

    def _on_demote(self, tid: int, now: float, speed: float) -> None:
        """Fault layer pushed `tid` off its (failed) core back into the
        oversubscription queue — the inverse of `_on_promote`: bank the
        progress made at the old rate and continue at the time-shared
        rate until a surviving core frees up."""
        st = self._oversub_inflight.get(tid)
        if st is None:
            return
        work_left, rate, t_progress, gen, on_done = st
        work_left = max(work_left - (now - t_progress) * rate, 0.0)
        rate = max(speed, 1e-6) / OVERSUB_SLOWDOWN
        st[:] = [work_left, rate, now, gen + 1, on_done]
        self._schedule_finish(tid, work_left / rate, gen + 1, on_done, True)

    def crash(self, now: float) -> None:
        """Power loss: every in-flight CPU task (and its pending finish
        event) dies — clearing `_oversub_inflight` marks all of them
        stale — and the manager powers the cores down. Request-level
        recovery is the cluster fault layer's job."""
        self.up = False
        self.epoch += 1
        self.manager.crash(now)
        self._oversub_inflight.clear()
        self.running_cpu_tasks = 0

    def reboot(self, now: float) -> None:
        """Power restored: surviving cores wake into a fresh working
        set; the instance starts empty (everything was re-dispatched)."""
        self.up = True
        self.manager.reboot(now)


class PromptInstance:
    """Prefill-phase worker: FIFO, one prefill in flight (Splitwise)."""

    def __init__(self, machine: Machine):
        self.machine = machine
        # FIFO of admitted-but-not-started prefills; popleft() is O(1)
        # where list.pop(0) was O(n) under queueing bursts.
        self.queue: collections.deque[tuple[RequestState, Callable]] = \
            collections.deque()
        self.busy = False

    def enqueue(self, rs: RequestState, on_prefill_done) -> None:
        m = self.machine
        # Executor.submit -> submit_chain -> Instance.alloc_memory chain.
        def after_submit():
            m.run_cpu_task("submit_chain", lambda: m.run_cpu_task(
                "alloc_memory", lambda: self._admit(rs, on_prefill_done)))
        m.run_cpu_task("submit", after_submit)

    def _admit(self, rs: RequestState, on_prefill_done) -> None:
        self.queue.append((rs, on_prefill_done))
        self._maybe_start()

    def _maybe_start(self) -> None:
        if self.busy or not self.queue:
            return
        self.busy = True
        rs, cb = self.queue.popleft()
        m = self.machine
        gpu_time = PREFILL_BASE_S + PREFILL_PER_TOKEN_S * rs.req.input_tokens
        epoch = m.epoch

        def gpu_done():
            if m.epoch != epoch:
                return  # machine crashed mid-prefill; request re-dispatched
            rs.t_first_token = m.queue.now
            # finish_task + submit_flow kick off the KV-cache transfer.
            m.run_cpu_task("finish_task")
            m.run_cpu_task("submit_flow", lambda: cb(rs))
            self.busy = False
            self._maybe_start()

        m.run_cpu_task("submit_task", lambda: m.queue.schedule_in(
            gpu_time, gpu_done))

    def reset(self) -> None:
        """Machine crashed: drop queued work (the fault layer re-dispatches
        every booked request) and clear the in-flight marker."""
        self.queue.clear()
        self.busy = False


class TokenInstance:
    """Decode-phase worker with ORCA iteration-level continuous batching.

    Completion detection is O(1) per iteration: instead of decrementing
    every batched request's token counter each pass, a request joining
    the batch is pushed onto a min-heap keyed by the absolute iteration
    number it finishes at (continuous batching never evicts, so that
    number is fixed on admission). Iterations that complete nothing —
    the overwhelming majority at ~200 output tokens per request — skip
    the batch scan entirely. Completion *order* matches the old per-pass
    scan exactly: ties pop in admission order.
    """

    def __init__(self, machine: Machine):
        self.machine = machine
        self.active: list[RequestState] = []
        self.pending: collections.deque[RequestState] = collections.deque()
        self.iterating = False
        self.on_request_done = None
        self._iter_count = 0
        self._finish_heap: list[tuple[int, int, RequestState]] = []
        self._admit_seq = 0
        self._gpu_time = 0.0

    @property
    def load(self) -> int:
        return len(self.active) + len(self.pending)

    def receive_kv(self, rs: RequestState) -> None:
        """KV-cache flow arrived: fire flow_completion + alloc, then join
        the continuous batch."""
        m = self.machine

        def joined():
            self.pending.append(rs)
            self._maybe_iterate()

        m.run_cpu_task("flow_completion", lambda: m.run_cpu_task(
            "alloc_memory", joined))

    def _maybe_iterate(self) -> None:
        if self.iterating:
            return
        # admit pending up to batch limit
        while self.pending and len(self.active) < MAX_DECODE_BATCH:
            rs = self.pending.popleft()
            self.active.append(rs)
            self._admit_seq += 1
            heapq.heappush(self._finish_heap,
                           (self._iter_count + rs.remaining,
                            self._admit_seq, rs))
        if not self.active:
            return
        self.iterating = True
        self._gpu_time = (DECODE_ITER_BASE_S
                          + DECODE_ITER_PER_REQ_S * len(self.active))
        # ORCAInstance.start_iteration on the host, then the GPU pass.
        self.machine.run_cpu_task("start_iteration", self._gpu_pass)

    def _gpu_pass(self) -> None:
        epoch = self.machine.epoch
        self.machine.queue.schedule_in(
            self._gpu_time, lambda: self._iteration_done(epoch))

    def _iteration_done(self, epoch: int) -> None:
        m = self.machine
        if epoch != m.epoch:
            return  # machine crashed mid-iteration; batch re-dispatched
        self._iter_count += 1
        fh = self._finish_heap
        if fh and fh[0][0] <= self._iter_count:
            done_now = []
            while fh and fh[0][0] <= self._iter_count:
                done_now.append(heapq.heappop(fh)[2])
            done_ids = {id(rs) for rs in done_now}
            self.active = [rs for rs in self.active
                           if id(rs) not in done_ids]
            for rs in done_now:
                rs.remaining = 0
                rs.t_done = m.queue.now
                m.run_cpu_task("free_memory")
                m.run_cpu_task("finish_request", (
                    (lambda r=rs: self.on_request_done(r))
                    if self.on_request_done else None))
        self.iterating = False
        self._maybe_iterate()

    def reset(self) -> None:
        """Machine crashed: the continuous batch and its finish schedule
        are lost (the fault layer re-dispatches every booked request)."""
        self.active = []
        self.pending.clear()
        self._finish_heap = []
        self.iterating = False


# -------------------- fault handling (retry/failover) ------------------- #
#: dispatch attempts per request before it is counted failed/rejected
MAX_RETRIES = 3
#: exponential-backoff base: attempt k retries after BASE * 2**(k-1) s
BACKOFF_BASE_S = 0.05
#: a dispatched-but-not-started prefill older than this is hedged
#: (pulled back and re-dispatched); started prefills are never stolen
HEDGE_TIMEOUT_S = 10.0


def _merge_intervals(
        spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merge overlapping [lo, hi) spans (degraded-window accounting)."""
    if not spans:
        return []
    spans = sorted(spans)
    out = [list(spans[0])]
    for lo, hi in spans[1:]:
        if lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


class FaultCoordinator:
    """Cluster-level fault orchestration: injection, degradation, recovery.

    Built only when `cfg.fault_model != "none"` — with faults off the
    cluster never touches this class and the hot path is bit-identical
    to the faultless build.

    Responsibilities:
      * run each machine's `FaultModel.periodic` once per idling period
        and apply its decisions (offline cores via
        `CoreManager.fail_core`, transient stalls, crash/reboot);
      * health-aware dispatch: route around down machines, re-dispatch
        crash victims with bounded retry + exponential backoff, hedge
        prefills stuck in queue past `HEDGE_TIMEOUT_S`;
      * robustness accounting: capacity-based availability, degraded
        windows, retry/failure counters, and the conservation invariant
        completed + failed + rejected + pending == submitted.
    """

    def __init__(self, cluster: "Cluster", cfg: ExperimentConfig):
        self.cluster = cluster
        self.cfg = cfg
        n = cfg.n_machines
        # Per-machine model instances (may carry state, e.g. a pre-drawn
        # next crash time) over per-machine fault RNG streams.
        # Sequence-seeding with a salt keeps these streams disjoint from
        # the manager (seed*1000+mid) and router (seed*1000+999) streams
        # AND identical across policies — failure-count comparisons
        # between policies reflect aging state, not RNG drift.
        self.models = [get_fault_model(cfg.fault_model, **cfg.fault_options)
                       for _ in range(n)]
        self.rngs = [np.random.default_rng([cfg.seed, 0xFA, mid])
                     for mid in range(n)]
        self.views = [FaultView(m, rng, cfg.idling_period_s)
                      for m, rng in zip(cluster.machines, self.rngs)]
        # robustness counters
        self.submitted = 0
        self.retries = 0
        self.hedges = 0
        self.failed_requests = 0
        self.rejected_requests = 0
        self.core_failures = 0
        self.machine_crashes = 0
        self.stalls = 0
        #: core-seconds of serving capacity lost to failures/reboots
        self.lost_core_s = 0.0
        self._degraded: list[tuple[float, float]] = []
        # machine_id -> {id(rs): rs} of requests currently owned by that
        # machine (prefilling or decoding there); a crash re-dispatches
        # exactly these.
        self.inflight: dict[int, dict[int, RequestState]] = {
            mid: {} for mid in range(n)}
        self.rs_loc: dict[int, int] = {}
        # (machine_id, core) -> expiry time of an active transient stall
        self._stall_until: dict[tuple[int, int], float] = {}

    # ------------------------- booking ------------------------------- #
    def _book(self, rs: RequestState, machine_id: int) -> None:
        self.inflight[machine_id][id(rs)] = rs
        self.rs_loc[id(rs)] = machine_id

    def _unbook(self, rs: RequestState) -> None:
        mid = self.rs_loc.pop(id(rs), None)
        if mid is not None:
            self.inflight[mid].pop(id(rs), None)

    # ------------------------- dispatch ------------------------------ #
    def submit(self, rs: RequestState) -> None:
        self.submitted += 1
        self._dispatch_prompt(rs)

    def _dispatch_prompt(self, rs: RequestState) -> None:
        c = self.cluster
        pis = c.prompt_instances
        up = [i for i, pi in enumerate(pis) if pi.machine.up]
        if not up:
            self._retry(rs, "no-prompt-machine-up")
            return
        c.pending_request = rs.req
        idx = c._route(c.router.select_prompt, len(pis), "prompt")
        if not pis[idx].machine.up:
            # Health-aware failover: the router chose a down machine;
            # redirect to the least-loaded live prompt instance.
            depths = c.fleet.prompt_depths()
            idx = min(up, key=lambda i: depths[i])
        pi = pis[idx]
        self._book(rs, pi.machine.machine_id)
        rs.admitted = True
        pi.enqueue(rs, c._prefill_done)
        att = rs.attempts
        c.queue.schedule_in(HEDGE_TIMEOUT_S,
                            lambda: self._hedge_check(rs, att, idx))

    def _hedge_check(self, rs: RequestState, att: int, idx: int) -> None:
        """Fires HEDGE_TIMEOUT_S after a dispatch: a prefill still sitting
        in the queue (never started) is pulled back and re-dispatched
        immediately. Started prefills are never stolen, so a request is
        never served twice."""
        if (rs.t_done >= 0.0 or rs.failed or rs.attempts != att
                or rs.t_first_token >= 0.0):
            return
        pi = self.cluster.prompt_instances[idx]
        for entry in pi.queue:
            if entry[0] is rs:
                pi.queue.remove(entry)
                self._unbook(rs)
                self.hedges += 1
                self._retry(rs, "hedge-timeout", immediate=True)
                return

    def _retry(self, rs: RequestState, cause: str,
               immediate: bool = False) -> None:
        rs.attempts += 1
        if rs.attempts > MAX_RETRIES:
            rs.failed = True
            if rs.admitted:
                self.failed_requests += 1
            else:
                self.rejected_requests += 1
            return
        self.retries += 1
        # A retry restarts from the prompt phase: decode progress on a
        # crashed machine is gone with its KV cache.
        rs.remaining = rs.req.output_tokens
        rs.t_first_token = -1.0
        delay = 0.0 if immediate else BACKOFF_BASE_S * 2.0 ** (rs.attempts - 1)
        self.cluster.queue.schedule_in(
            delay, lambda: self._dispatch_prompt(rs))
        tel = self.cluster.telemetry
        if tel is not None:
            tel.push({"kind": "fault_retry", "t": self.cluster.queue.now,
                      "cause": cause, "attempt": rs.attempts})

    def prefill_done(self, rs: RequestState) -> None:
        c = self.cluster
        self._unbook(rs)
        tis = c.token_instances
        up = [i for i, ti in enumerate(tis) if ti.machine.up]
        if not up:
            self._retry(rs, "no-token-machine-up")
            return
        c.pending_request = rs.req
        idx = c._route(c.router.select_token, len(tis), "token")
        if not tis[idx].machine.up:
            loads = c.fleet.token_loads()
            idx = min(up, key=lambda i: loads[i])
        ti = tis[idx]
        self._book(rs, ti.machine.machine_id)
        flow_s = rs.req.input_tokens * KV_BYTES_PER_TOKEN / IB_LINK_BW_BPS
        c.queue.schedule_in(flow_s, lambda: self._kv_arrive(ti, rs))

    def _kv_arrive(self, ti: TokenInstance, rs: RequestState) -> None:
        mid = ti.machine.machine_id
        if self.inflight[mid].get(id(rs)) is not rs:
            return  # destination crashed in transit; already re-dispatched
        if not ti.machine.up:
            self._unbook(rs)
            self._retry(rs, "token-machine-down")
            return
        ti.receive_kv(rs)

    def request_done(self, rs: RequestState) -> None:
        self._unbook(rs)

    # ------------------------- injection ----------------------------- #
    def tick(self, now: float) -> None:
        """Once per idling period: expire stalls, then let each machine's
        fault model decide what breaks."""
        if self._stall_until:
            for key in [k for k, t in self._stall_until.items()
                        if t <= now]:
                del self._stall_until[key]
                m = self.cluster.machines[key[0]]
                if m.up:
                    m.manager.clear_core_slowdown(key[1], now)
        for mid, model in enumerate(self.models):
            dec = model.periodic(self.views[mid])
            if not dec:
                continue
            machine = self.cluster.machines[mid]
            if dec.crash:
                if machine.up:
                    self._crash(machine, now, dec.reboot_s)
                continue
            for core in dec.fail_cores:
                self._fail_core(machine, int(core), now)
            for core in dec.stall_cores:
                self._stall(machine, int(core), now,
                            dec.stall_factor, dec.stall_s)

    def _fail_core(self, machine: Machine, core: int, now: float) -> None:
        mgr = machine.manager
        if not machine.up or mgr.failed.item(core):
            return
        mgr.fail_core(core, now)
        self.core_failures += 1
        dur = self.cfg.duration_s
        self.lost_core_s += max(dur - now, 0.0)
        self._degraded.append(
            (now, min(now + self.cfg.idling_period_s, dur)))
        tel = self.cluster.telemetry
        if tel is not None:
            tel.push({"kind": "core_failure", "t": now,
                      "machine": machine.machine_id, "core": core})

    def _crash(self, machine: Machine, now: float, reboot_s: float) -> None:
        mid = machine.machine_id
        victims = list(self.inflight[mid].values())
        for rs in victims:
            self.rs_loc.pop(id(rs), None)
        self.inflight[mid].clear()
        for key in [k for k in self._stall_until if k[0] == mid]:
            del self._stall_until[key]
        machine.crash(now)
        c = self.cluster
        n_p = self.cfg.n_prompt
        if mid < n_p:
            c.prompt_instances[mid].reset()
        else:
            c.token_instances[mid - n_p].reset()
        self.machine_crashes += 1
        dur = self.cfg.duration_s
        surviving = machine.manager.num_cores \
            - int(machine.manager.failed.sum())
        self.lost_core_s += surviving * min(reboot_s, max(dur - now, 0.0))
        self._degraded.append((now, min(now + reboot_s, dur)))
        c.queue.schedule_in(reboot_s, lambda: self._reboot(machine))
        for rs in victims:
            self._retry(rs, "machine-crash")
        tel = c.telemetry
        if tel is not None:
            tel.push({"kind": "machine_crash", "t": now, "machine": mid,
                      "reboot_s": reboot_s, "victims": len(victims)})

    def _reboot(self, machine: Machine) -> None:
        now = self.cluster.queue.now
        machine.reboot(now)
        tel = self.cluster.telemetry
        if tel is not None:
            tel.push({"kind": "machine_reboot", "t": now,
                      "machine": machine.machine_id})

    def _stall(self, machine: Machine, core: int, now: float,
               factor: float, stall_s: float) -> None:
        mgr = machine.manager
        if not machine.up or mgr.failed.item(core):
            return
        mgr.set_core_slowdown(core, now, factor)
        self.stalls += 1
        key = (machine.machine_id, core)
        self._stall_until[key] = max(
            self._stall_until.get(key, 0.0), now + stall_s)
        self._degraded.append(
            (now, min(now + stall_s, self.cfg.duration_s)))

    # ------------------------- accounting ---------------------------- #
    def robustness(self, elapsed_s: float) -> dict:
        """Robustness scalars for `ExperimentResult` (keys match field
        names; `pending_requests` is derived by the caller)."""
        cfg = self.cfg
        n_cores = (cfg.n_machines * cfg.num_cores
                   if self.cluster.inventory is None
                   else self.cluster.inventory.total_cores)
        total = n_cores * max(elapsed_s, 1e-9)
        widths = [hi - lo for lo, hi in _merge_intervals(self._degraded)]
        return {
            "availability": 1.0 - min(self.lost_core_s / total, 1.0),
            "core_failures": self.core_failures,
            "machine_crashes": self.machine_crashes,
            "stalls": self.stalls,
            "retries": self.retries,
            "failed_requests": self.failed_requests,
            "rejected_requests": self.rejected_requests,
            "submitted": self.submitted,
            "p99_degraded_window_s": (
                float(np.percentile(np.asarray(widths), 99))
                if widths else 0.0),
        }


class Cluster:
    """22-machine phase-splitting cluster + cluster-level scheduler."""

    def __init__(self, cfg: ExperimentConfig, telemetry=None):
        self.cfg = cfg
        self.queue = EventQueue()
        # Telemetry sink shared by every machine's CoreManager and the
        # routing/sampling paths below (None = zero-cost off; the hub is
        # owned by `run_experiment`, which exports it after the run).
        self.telemetry = telemetry if (
            telemetry is not None and getattr(telemetry, "enabled", True)
        ) else None
        # One id stream per simulation (not per process): concurrent
        # clusters can't interleave ids, while within this cluster ids
        # stay globally ordered by spawn time — the property the
        # manager's oversubscription FIFO relies on.
        self.task_ids = TaskIdAllocator()
        faults_on = cfg.fault_model != "none"
        # Heterogeneous fleets (`repro_torch.hardware`): None on the
        # uniform default — every machine then builds with the historical
        # homogeneous arguments, bit-exactly.
        self.inventory = resolve_fleet(cfg.fleet, cfg.fleet_options,
                                       cfg.n_machines)
        self.machines = [
            Machine(i, cfg, self.queue, self.task_ids,
                    telemetry=self.telemetry, track_inflight=faults_on,
                    hw=(None if self.inventory is None
                        else self.inventory.skus[i]))
            for i in range(cfg.n_machines)
        ]
        self.prompt_instances = [PromptInstance(m)
                                 for m in self.machines[:cfg.n_prompt]]
        self.token_instances = [TokenInstance(m)
                                for m in self.machines[cfg.n_prompt:]]
        self.completed: list[RequestState] = []
        # Streaming latency summary (ROADMAP 1d): metrics read this
        # instead of materializing a per-request latency array.
        self.completed_count = 0
        self.latency = LatencyAggregate()
        for ti in self.token_instances:
            ti.on_request_done = self._request_done
        # Cluster-level request routing (`repro_torch.sim.routing`): the
        # router only sees a read-only FleetView; RNG-driven routers draw
        # from a cluster-owned stream so seeded runs stay reproducible.
        self.router = get_router(cfg.router, **cfg.router_options)
        self.router_rng = np.random.default_rng(cfg.seed * 1000 + 999)
        self.fleet = FleetView(self)
        if self.telemetry is not None:
            tel = self.telemetry
            self._c_routes = {k: tel.counter(f"routes_{k}")
                              for k in ("prompt", "token")}
            self._s_prompt_depth = tel.get_series("fleet/prompt_queue_depth")
            self._s_decode_load = tel.get_series("fleet/decode_load")
            self._s_cpu_tasks = tel.get_series("fleet/cpu_tasks")
        # Pending-request hook for size-aware routers: set immediately
        # before every `_route` call so `FleetView` can expose the
        # routed request's token counts (None outside routing).
        self.pending_request = None
        # Periodic ticks settle all machines' cores through one stacked
        # advance (numpy backend: bit-identical to per-machine settle_all).
        # Mixed fleets group managers by (AgingParams, num_cores) and run
        # one stacked settler per homogeneous group.
        if self.inventory is None:
            self.fleet_settler = FleetAgingSettler(
                [m.manager for m in self.machines])
        else:
            self.fleet_settler = GroupedAgingSettler(
                [m.manager for m in self.machines])
        # Fault layer: None with the default "none" model — every
        # faultless code path below checks `self.faults is not None`
        # exactly once and otherwise runs the historical bit-exact logic.
        self.faults = FaultCoordinator(self, cfg) if faults_on else None

    # ----------------------- scheduling policy ------------------------ #
    def _route(self, select, n: int, kind: str) -> int:
        idx = int(select(self.fleet))
        if not 0 <= idx < n:
            raise ValueError(f"router {self.router.name!r} returned "
                             f"{kind} index {idx}, outside [0, {n})")
        tel = self.telemetry
        if tel is not None:
            # Record the FleetView the router judged against — queue
            # depths (prompt) or decode loads (token) — so placement
            # decisions are auditable after the run.
            view = (self.fleet.prompt_depths() if kind == "prompt"
                    else self.fleet.token_loads())
            machine = idx if kind == "prompt" else self.cfg.n_prompt + idx
            self._c_routes[kind].inc()
            tel.push({"kind": "route", "t": self.queue.now,
                      "machine": machine, "phase": kind, "chosen": idx,
                      "router": self.router.name,
                      "depths": [int(d) for d in view]})
        return idx

    def submit_request(self, req: Request) -> None:
        rs = RequestState(req, remaining=req.output_tokens,
                          t_arrival=self.queue.now)
        self.pending_request = req
        if self.faults is not None:
            self.faults.submit(rs)
            return
        pi = self.prompt_instances[self._route(
            self.router.select_prompt, len(self.prompt_instances), "prompt")]
        pi.enqueue(rs, self._prefill_done)

    def _prefill_done(self, rs: RequestState) -> None:
        self.pending_request = rs.req
        if self.faults is not None:
            self.faults.prefill_done(rs)
            return
        # KV-cache flow to the router-chosen token instance over IB.
        ti = self.token_instances[self._route(
            self.router.select_token, len(self.token_instances), "token")]
        flow_s = rs.req.input_tokens * KV_BYTES_PER_TOKEN / IB_LINK_BW_BPS
        self.queue.schedule_in(flow_s, lambda: ti.receive_kv(rs))

    def _request_done(self, rs: RequestState) -> None:
        self.completed_count += 1
        self.latency.observe(rs.t_done - rs.t_arrival)
        self.completed.append(rs)
        if self.faults is not None:
            self.faults.request_done(rs)

    # --------------------------- main loop ----------------------------- #
    def run(self, requests: list[Request], duration_s: float,
            sample_period_s: float = 0.1) -> None:
        for req in requests:
            self.queue.schedule(req.arrival_s,
                                lambda r=req: self.submit_request(r))

        period = self.machines[0].manager.idling_period_s

        def periodic(t=[0.0]):
            # One fleet-batched settlement instead of n_machines
            # sequential settle_all chains; each manager's periodic then
            # sees fully-settled state (its own settle_all early-outs).
            self.fleet_settler.settle(self.queue.now)
            for m in self.machines:
                m.manager.periodic(self.queue.now)
            if self.faults is not None:
                self.faults.tick(self.queue.now)
            t[0] += period
            if t[0] <= duration_s:
                self.queue.schedule_in(period, periodic)

        tel = self.telemetry

        def sampler(t=[0.0]):
            for m in self.machines:
                m.task_count_samples.append(m.running_cpu_tasks)
            if tel is not None:
                now = self.queue.now
                self._s_prompt_depth.observe(
                    now, float(sum(len(p.queue) + p.busy
                                   for p in self.prompt_instances)))
                self._s_decode_load.observe(
                    now, float(sum(ti.load
                                   for ti in self.token_instances)))
                self._s_cpu_tasks.observe(
                    now, float(sum(m.running_cpu_tasks
                                   for m in self.machines)))
            t[0] += sample_period_s
            if t[0] <= duration_s:
                self.queue.schedule_in(sample_period_s, sampler)

        self.queue.schedule(period, periodic)
        self.queue.schedule(sample_period_s, sampler)
        self.queue.run_until(duration_s)
        for m in self.machines:
            m.manager.settle_all(duration_s)
