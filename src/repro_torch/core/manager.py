"""CoreManager — the per-server aging-aware CPU core management runtime.

This is the paper's contribution as a deployable component (Fig. 3): it
owns the per-core aging state of one inference server's CPU, routes every
CPU inference task through a pluggable task-to-core policy
(`repro_torch.core.policies`), and applies the working-set corrections the
policy returns from its periodic hook (Selective Core Idling for the
proposed technique).

The manager is policy-agnostic: policies only see a read-only `CoreView`
(masks, dVth, f0, idle history, rng), while the manager keeps exclusive
write access to the NBTI bookkeeping. A core's dVth advances lazily with
the ADF of the (C-state, allocated) regime it was in, and every regime
change first settles the elapsed interval under the old ADF.

Copy of `repro.core.manager` with its import paths rewritten; the
telemetry hooks (`repro_torch.telemetry`) and the fault hooks are the
reference's numpy float64 code, unchanged.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core import aging, mapping, temperature, variation
from repro_torch.core.policies import CorePolicy, CoreView, get_policy
from repro_torch.core.temperature import CState
from repro_torch.power.residency import ResidencyAccumulator, StateResidency

OVERSUBSCRIBED = -1  # sentinel core id for tasks that didn't get a core

_ACTIVE = int(CState.ACTIVE)
_DEEP_IDLE = int(CState.DEEP_IDLE)


@dataclasses.dataclass
class ManagerMetrics:
    """Accumulated observability for one server's CPU."""

    oversub_task_seconds: float = 0.0   # integral of T_oversub (paper §3.3)
    idle_norm_samples: list = dataclasses.field(default_factory=list)
    active_count_samples: list = dataclasses.field(default_factory=list)
    task_count_samples: list = dataclasses.field(default_factory=list)
    assigns: int = 0
    oversub_assigns: int = 0


class CoreManager:
    def __init__(
        self,
        num_cores: int,
        policy: CorePolicy | str = "proposed",
        aging_params: aging.AgingParams = aging.DEFAULT_PARAMS,
        variation_params: variation.VariationParams | None = None,
        rng: np.random.Generator | None = None,
        idling_period_s: float = 1.0,
        policy_opts: dict | None = None,
        on_promote=None,
        on_demote=None,
        res_window_s: float = 1.0,
        telemetry=None,
        telemetry_id: int = 0,
    ):
        self.num_cores = num_cores
        # Called as on_promote(task_id, core, now, speed) whenever a task
        # leaves the oversubscription queue for a real core, where `speed`
        # is the promoted core's settled frequency factor — the caller can
        # recompute the task's remaining duration (the simulator reschedules
        # its completion event; see `Machine.run_cpu_task`).
        self.on_promote = on_promote
        # Called as on_demote(task_id, now, speed) when the fault layer
        # pushes a task OFF its core (core failure) back into the
        # oversubscription queue — the inverse of on_promote, reusing
        # the same rebanking machinery (`Machine._on_demote`).
        self.on_demote = on_demote
        self.params = aging_params
        self.idling_period_s = idling_period_s
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.policy = self._resolve_policy(policy, policy_opts)
        vp = variation_params or variation.VariationParams(
            f_nominal=aging_params.f_nominal)
        self.f0 = variation.sample_initial_frequencies(vp, num_cores, self.rng)

        n = num_cores
        self.dvth = np.zeros(n)
        self.c_state = np.full(n, CState.ACTIVE, dtype=np.int8)
        self.task_of_core = np.full(n, -1, dtype=np.int64)   # task id or -1
        self.idle_history = np.zeros((n, mapping.IDLE_HISTORY_LEN))
        # Per-core write cursor into the idle-history ring (plain ints:
        # this is pure event-loop bookkeeping, never consumed as an array).
        self.hist_pos = [0] * n
        self.idle_since = np.zeros(n)        # when core last became unassigned
        self.last_update = np.zeros(n)       # last dvth settlement time
        self.cum_work = np.zeros(n)          # least-aged baseline age proxy
        self.core_of_task: dict[int, int] = {}
        self.task_start: dict[int, float] = {}
        self.oversub_tasks: set[int] = set()
        # task -> sim time up to which its oversubscribed wait has been
        # added to `metrics.oversub_task_seconds` (each second of the
        # T_oversub integral is counted exactly once).
        self._oversub_accounted: dict[int, float] = {}
        self.metrics = ManagerMetrics()
        self.now = 0.0
        self._view = CoreView(self)

        # ---- event-loop fast-path state (see "incremental indices") ---- #
        # Per-core idle score kept in lockstep with `idle_history`
        # (bit-identical to `mapping.idle_scores`, see `_record_idle_end`).
        self.idle_score = np.zeros(n)
        # Lazy max-heap over free working-set cores: entries are
        # (-idle_score, core, stamp). `_stamp[core]` increments on every
        # eligibility transition (assign / release / gate / wake), so any
        # entry whose stamp is stale is garbage and is dropped at peek
        # time. Ordering matches `mapping.select_core` exactly: highest
        # score first, ties to the lowest core index.
        self._free_heap: list[tuple[float, int, int]] = \
            [(-0.0, i, 0) for i in range(n)]
        self._stamp: list[int] = [0] * n
        # Cores currently running a task (the oversubscribed-speed bound
        # only needs these; maintained O(1) per assign/release).
        self._busy_cores: set[int] = set()
        # Regime ADFs precomputed once per manager. `_adf_settle` mirrors
        # the scalar settle path (`K * adf_unscaled_cached`); the busy
        # constant mirrors the vectorized `aging.adf` the oversubscribed
        # bound historically flowed through — the two derivations differ
        # in multiplication order and may differ in the last ulp, so each
        # fast path keeps its own to stay bit-exact.
        p = self.params
        self._adf_settle = tuple(
            tuple(p.K * aging.adf_unscaled_cached(
                p, temperature.core_temperature_c(CState(cs), alloc),
                temperature.core_stress(CState(cs), alloc))
                for alloc in (False, True))
            for cs in (_ACTIVE, _DEEP_IDLE))
        self._adf_busy_vec = float(aging.adf(
            p, np.float64(temperature.TEMP_ACTIVE_ALLOCATED_C),
            np.float64(temperature.STRESS_ACTIVE)))
        self._inv_n = 1.0 / p.n
        self._n_exp = p.n
        self._headroom = p.headroom
        # C-state residency integrals for the power models. Pure additive
        # bookkeeping driven off the busy set + gated count: it never reads
        # or reorders the aging math, so the settle paths stay bit-exact.
        self.residency_acc = ResidencyAccumulator(n, window_s=res_window_s)
        self._n_gated = 0
        # task -> settled frequency factor it runs at (assign/promote
        # time); consumed on release for frequency-weighted busy time.
        self._task_speed: dict[int, float] = {}
        # ---- fault layer (repro.faults) ---- #
        # Permanently offlined cores (guardband failures). A failed core
        # is held in DEEP_IDLE (power-fenced: NBTI stress ends, so its
        # aging freezes — matching the frozen-ADF treatment of gated
        # cores) and never re-enters the free heap or wake candidates.
        self.failed = np.zeros(n, dtype=bool)
        # core -> transient slowdown factor; empty dict == zero cost on
        # the assign hot path (one falsy check per assign).
        self._stalls: dict[int, float] = {}
        # Telemetry sink (repro_torch.telemetry.TelemetryHub) or None. Hot
        # paths guard every emission with one `is not None` test so the
        # disabled cost is exactly that test — recording is pure
        # observation and never touches aging state or the RNG.
        self._tel = telemetry if (
            telemetry is not None and getattr(telemetry, "enabled", True)
        ) else None
        self._tel_id = int(telemetry_id)
        self._tel_tick = 0
        if self._tel is not None:
            # Cache the probe objects once (the hub idiom): emissions
            # become one bound-method call, not a name lookup per event.
            tel, mid = self._tel, self._tel_id
            self._c_assigns = tel.counter("assigns")
            self._c_oversub_assigns = tel.counter("oversub_assigns")
            self._c_promotions = tel.counter("promotions")
            self._c_gates = tel.counter("gates")
            self._c_wakes = tel.counter("wakes")
            self._c_deferrals = tel.counter("carbon_deferrals")
            self._s_active = tel.get_series(f"m{mid}/active_cores")
            self._s_oversub = tel.get_series(f"m{mid}/oversub_tasks")
            self._tl_freq = tel.timeline(f"m{mid}/freq")
            self._tl_dvth = tel.timeline(f"m{mid}/dvth")
            self._tl_cstate = tel.timeline(f"m{mid}/cstate")

    @staticmethod
    def _resolve_policy(policy, policy_opts) -> CorePolicy:
        if isinstance(policy, CorePolicy):
            if policy_opts:
                raise TypeError("policy_opts only applies when the policy "
                                "is given by name; pass the options to the "
                                "constructor of your CorePolicy instance "
                                "instead")
            return policy
        return get_policy(policy, **dict(policy_opts or {}))

    @property
    def policy_name(self) -> str:
        return self.policy.name

    @property
    def view(self) -> CoreView:
        """Read-only view of this manager's per-core state."""
        return self._view

    # ------------------------------------------------------------------ #
    # aging bookkeeping
    # ------------------------------------------------------------------ #
    def _settle(self, i: int, now: float) -> None:
        """Advance core i's dVth from last_update to `now` under its
        current regime. Must be called BEFORE any regime change.

        numpy-free scalar path: the regime ADF comes from the per-manager
        `_adf_settle` table (same value `K * adf_unscaled_cached` returned
        per call before, minus the enum + dict-hash round trips), and the
        recursive update is `aging.advance_dvth_scalar` inlined on plain
        floats (`.item()` reads skip numpy-scalar boxing)."""
        tau = now - self.last_update.item(i)
        if tau > 0.0:
            a = self._adf_settle[self.c_state.item(i)][
                1 if self.task_of_core.item(i) >= 0 else 0]
            if a > 0.0:
                d = self.dvth.item(i)
                self.dvth[i] = a * ((d / a) ** self._inv_n + tau) \
                    ** self._n_exp
            self.last_update[i] = now

    # ------------------------------------------------------------------ #
    # incremental indices (event-loop fast paths)
    # ------------------------------------------------------------------ #
    def _record_idle_end(self, core: int, idle_duration: float) -> None:
        """`mapping.record_idle_end` + incremental idle-score update."""
        h = self.idle_history
        pos = self.hist_pos[core]
        h[core, pos % mapping.IDLE_HISTORY_LEN] = idle_duration
        self.hist_pos[core] = pos + 1
        # Recompute the row's score with numpy's pairwise-summation tree
        # for 8 elements, so the cached score stays bit-identical to
        # `mapping.idle_scores` (a plain left-to-right sum would drift
        # by ulps and could flip argmax ties).
        if mapping.IDLE_HISTORY_LEN == 8:
            r0, r1, r2, r3, r4, r5, r6, r7 = h[core].tolist()
            self.idle_score[core] = (
                ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)))
        else:
            self.idle_score[core] = float(h[core].sum())

    def _peek_best_free(self) -> int:
        """Free working-set core with the highest idle score, or -1.

        Equivalent to `mapping.select_core(active, assigned,
        idle_history)` — including first-index tie-breaking — but served
        from the lazy heap in O(log n) amortized. Stale entries (stamp
        mismatch, or state flipped behind the manager's back) are
        discarded on the way; the returned core stays in the heap until
        an eligibility transition invalidates it."""
        h = self._free_heap
        stamp = self._stamp
        c_state = self.c_state
        task_of_core = self.task_of_core
        while h:
            _, core, st = h[0]
            if (st != stamp[core] or c_state.item(core) != _ACTIVE
                    or task_of_core.item(core) >= 0):
                heapq.heappop(h)
                continue
            return core
        return -1

    def _push_free(self, core: int) -> None:
        """Core just became eligible (free + working set): index it."""
        stamp = self._stamp[core] + 1
        self._stamp[core] = stamp
        heapq.heappush(self._free_heap,
                       (-self.idle_score.item(core), core, stamp))

    def _mark_busy(self, core: int, task_id: int, now: float) -> None:
        """Shared assign/promote tail: settle the ended idle window and
        hand the core to `task_id` (invalidates its free-heap entry)."""
        idle_dur = now - self.idle_since.item(core)
        self._record_idle_end(core, idle_dur if idle_dur > 0.0 else 0.0)
        self._settle(core, now)          # settle idle regime
        # Bank the interval's residency under the old counts before the
        # busy set grows (same settle-before-change rule as the aging).
        self.residency_acc.advance(now, len(self._busy_cores),
                                   self._n_gated)
        self.task_of_core[core] = task_id
        self.core_of_task[task_id] = core
        self.task_start[task_id] = now
        self._stamp[core] += 1
        self._busy_cores.add(core)

    def _busy_max_frequency(self, now: float) -> float:
        """Settled frequency of the fastest *busy* core at `now` — the
        oversubscribed-task speed bound — without building fleet-wide
        settled arrays. Bit-identical to masking
        `aging.frequency(params, f0, _settled_dvth(now))` to busy cores
        (pinned by tests/test_fastpath.py): busy cores all share the
        (C0, allocated) regime, so one vectorized-derivation ADF
        constant plus the same ufunc chain over just the busy *subset*
        reproduces the old full-fleet computation. (A pure-scalar loop
        would not: numpy's array `**` and libm's scalar `**` disagree by
        an ulp on some inputs, so the advance must stay a ufunc.)"""
        if not self._busy_cores:
            # Pure promotion race: nothing busy, fall back to the
            # fleet-wide settled maximum (rare; keep the vectorized path).
            freqs = aging.frequency(self.params, self.f0,
                                    self._settled_dvth(now))
            return float(np.max(freqs))
        idx = np.fromiter(self._busy_cores, dtype=np.intp,
                          count=len(self._busy_cores))
        a = self._adf_busy_vec
        tau = np.maximum(now - self.last_update[idx], 0.0)
        d = self.dvth[idx]
        new = a * ((d / a) ** self._inv_n + tau) ** self._n_exp
        settled = np.where(tau > 0.0, new, d)
        return float(np.max(self.f0[idx]
                            * (1.0 - settled / self._headroom)))

    def _settled_dvth(self, now: float) -> np.ndarray:
        """Every core's dVth advanced to `now` under its current regime,
        WITHOUT mutating state (pure; also backs `CoreView.dvth_now`)."""
        tau = np.maximum(now - self.last_update, 0.0)
        temps, stress = temperature.regime_arrays(self.c_state,
                                                  self.task_of_core >= 0)
        adf_vals = aging.adf(self.params, temps, stress)
        return aging.advance_dvth(self.params, self.dvth, adf_vals, tau)

    def settle_all(self, now: float) -> None:
        """Vectorized settlement of every core (used by the periodic path
        and by metric snapshots; mirrors the Pallas aging_update kernel)."""
        self.residency_acc.advance(now, len(self._busy_cores),
                                   self._n_gated)
        if not (now - self.last_update > 0).any():
            self.now = max(self.now, now)
            return
        self.dvth = self._settled_dvth(now)
        self.last_update = np.maximum(self.last_update, now)
        self.now = max(self.now, now)

    # ------------------------------------------------------------------ #
    # task lifecycle
    # ------------------------------------------------------------------ #
    def assign(self, task_id: int, now: float) -> float:
        """Route one CPU inference task to a core via the policy.

        Returns the execution speed factor (degraded f / nominal f) the
        simulator should apply to the task duration; oversubscribed tasks
        additionally share cores, handled by the caller via load factor.
        """
        if now > self.now:
            self.now = now
        self.metrics.assigns += 1
        core = self.policy.select_core(self._view)

        if core < 0:
            self.oversub_tasks.add(task_id)
            self.core_of_task[task_id] = OVERSUBSCRIBED
            self.task_start[task_id] = now
            self._oversub_accounted[task_id] = now
            self.metrics.oversub_assigns += 1
            tel = self._tel
            if tel is not None:
                self._c_oversub_assigns.inc()
                tel.push({"kind": "oversub", "t": now,
                          "machine": self._tel_id, "task": task_id,
                          "cause": "oversubscription",
                          "waiting": len(self.oversub_tasks)})
            # Oversubscribed tasks time-share already-busy cores, so the
            # settled frequency of the fastest *busy* core bounds their
            # speed — pristine idle (or power-gated) cores are not
            # executing anything and must not inflate the bound. Only
            # when no core is busy at all (pure promotion races) fall
            # back to the fleet-wide settled maximum.
            return self._busy_max_frequency(now)

        # End the core's idle period -> record idle duration (Alg. 1 input).
        self._mark_busy(core, task_id, now)
        # aging.frequency_scalar inlined (Eq. 1) on plain floats.
        speed = self.f0.item(core) * (1.0 - self.dvth.item(core)
                                      / self._headroom)
        if self._stalls:
            stall = self._stalls.get(core)
            if stall is not None:
                speed *= stall
        self._task_speed[task_id] = speed
        tel = self._tel
        if tel is not None:
            self._c_assigns.inc()
            tel.push({"kind": "assign", "t": now, "machine": self._tel_id,
                      "core": core, "task": task_id, "speed": speed})
        return speed

    def release(self, task_id: int, now: float) -> None:
        if now > self.now:
            self.now = now
        core = self.core_of_task.pop(task_id, None)
        start = self.task_start.pop(task_id, now)
        if core is None:
            return
        if core == OVERSUBSCRIBED:
            self.oversub_tasks.discard(task_id)
            self._task_speed.pop(task_id, None)
            self._account_oversub(task_id, now)
            if self._tel is not None:
                self._tel.push({"kind": "release", "t": now,
                                "machine": self._tel_id, "core": -1,
                                "task": task_id})
            if self.oversub_tasks:
                self._promote_oversubscribed(now)
            return
        self._settle(core, now)          # settle allocated regime
        self.cum_work[core] += now - start
        speed = self._task_speed.pop(task_id, None)
        if speed is not None:
            self.residency_acc.add_busy_frequency(speed, now - start)
        self.residency_acc.advance(now, len(self._busy_cores),
                                   self._n_gated)
        self.task_of_core[core] = -1
        self._busy_cores.discard(core)
        self.idle_since[core] = now
        self._push_free(core)
        if self._tel is not None:
            self._tel.push({"kind": "release", "t": now,
                            "machine": self._tel_id, "core": core,
                            "task": task_id})
        self.policy.on_release(self._view, core)
        if self.oversub_tasks:
            self._promote_oversubscribed(now)

    def _account_oversub(self, task_id: int, now: float,
                         final: bool = True) -> None:
        """Add `task_id`'s not-yet-counted oversubscribed wait to the
        T_oversub integral. `final=False` keeps the task in the books
        (periodic accrual for still-waiting tasks)."""
        since = (self._oversub_accounted.pop(task_id, now) if final
                 else self._oversub_accounted.get(task_id, now))
        self.metrics.oversub_task_seconds += max(now - since, 0.0)
        if not final:
            self._oversub_accounted[task_id] = now

    def _promote_oversubscribed(self, now: float) -> None:
        """When a core frees up, move a waiting oversubscribed task onto it.

        Promotion is manager-internal FIFO and always uses the Algorithm-1
        idle-score mapping (not the policy): a promoted task usually has
        exactly one candidate core — the one that just freed.
        """
        while self.oversub_tasks:
            core = self._peek_best_free()
            if core < 0:
                return
            task_id = min(self.oversub_tasks)  # FIFO by id (ids are ordered)
            self.oversub_tasks.discard(task_id)
            self._account_oversub(task_id, now)
            self._mark_busy(core, task_id, now)
            speed = aging.frequency_scalar(
                self.params, float(self.f0[core]), float(self.dvth[core]))
            if self._stalls:
                stall = self._stalls.get(core)
                if stall is not None:
                    speed *= stall
            self._task_speed[task_id] = speed
            if self._tel is not None:
                self._c_promotions.inc()
                self._tel.push({"kind": "promote", "t": now,
                                "machine": self._tel_id, "core": core,
                                "task": task_id, "speed": speed,
                                "cause": "promotion"})
            if self.on_promote is not None:
                self.on_promote(task_id, core, now, speed)

    # ------------------------------------------------------------------ #
    # fault layer (repro.faults — only called when faults are active)
    # ------------------------------------------------------------------ #
    def fail_core(self, core: int, now: float) -> None:
        """Permanently offline `core` (guardband violation): settle its
        aging, power-fence it (DEEP_IDLE — NBTI stress ends), and demote
        any in-flight task back into the oversubscription queue so the
        promotion machinery migrates it to a surviving core."""
        if self.failed.item(core):
            return
        self._settle(core, now)
        self.residency_acc.advance(now, len(self._busy_cores),
                                   self._n_gated)
        self.failed[core] = True
        self._stalls.pop(core, None)
        tid = int(self.task_of_core.item(core))
        self.c_state[core] = CState.DEEP_IDLE
        self._stamp[core] += 1           # drop any free-heap entry
        if tid >= 0:
            self.task_of_core[core] = -1
            self._busy_cores.discard(core)
            self.cum_work[core] += now - self.task_start.get(tid, now)
            self.core_of_task[tid] = OVERSUBSCRIBED
            self.oversub_tasks.add(tid)
            self._oversub_accounted[tid] = now
            self._task_speed.pop(tid, None)
            if self.on_demote is not None:
                # Same speed bound oversubscribed assigns get: the
                # fastest surviving busy core's settled frequency.
                self.on_demote(tid, now, self._busy_max_frequency(now))
        self._n_gated = int((self.c_state == CState.DEEP_IDLE).sum())
        if self.oversub_tasks:
            # Migration = demotion + immediate promotion when a free
            # core exists (the PR-4 rebanking path reschedules it).
            self._promote_oversubscribed(now)

    def crash(self, now: float) -> None:
        """Machine lost power: every in-flight task dies, all cores
        power down (DEEP_IDLE — aging freezes while the machine is
        dark). The caller (cluster fault layer) owns request retries and
        the eventual `reboot`."""
        self.settle_all(now)
        for tid in list(self.oversub_tasks):
            self._account_oversub(tid, now)
        self.oversub_tasks.clear()
        for tid, core in self.core_of_task.items():
            if core >= 0:
                self.cum_work[core] += now - self.task_start.get(tid, now)
        self.core_of_task.clear()
        self.task_start.clear()
        self._task_speed.clear()
        self._stalls.clear()
        self._oversub_accounted.clear()
        self.task_of_core[:] = -1
        self._busy_cores.clear()
        self.c_state[:] = CState.DEEP_IDLE
        for i in range(self.num_cores):
            self._stamp[i] += 1
        self._n_gated = self.num_cores

    def reboot(self, now: float) -> None:
        """Power restored after `crash`: wake every surviving core into
        a fresh-boot working set (the policy re-gates on its next
        periodic); failed cores stay fenced."""
        self.settle_all(now)
        up = np.flatnonzero(~self.failed)
        self.c_state[~self.failed] = CState.ACTIVE
        self.idle_since[:] = now
        for i in up:
            self._push_free(int(i))
        self._n_gated = int(self.failed.sum())

    def set_core_slowdown(self, core: int, now: float,
                          factor: float) -> None:
        """Transient stall: new assigns on `core` run at `factor` x its
        settled speed, and any in-flight task is re-rated through the
        promotion rebanking callback (bank progress, reschedule)."""
        self._stalls[core] = factor
        self._rerate_core(core, now, factor)

    def clear_core_slowdown(self, core: int, now: float) -> None:
        """Stall expired: restore full speed (re-rates in-flight work)."""
        if self._stalls.pop(core, None) is not None:
            self._rerate_core(core, now, 1.0)

    def _rerate_core(self, core: int, now: float, factor: float) -> None:
        tid = int(self.task_of_core.item(core))
        if tid < 0:
            return
        self._settle(core, now)
        speed = aging.frequency_scalar(
            self.params, float(self.f0[core]), float(self.dvth[core])) \
            * factor
        self._task_speed[tid] = speed
        if self.on_promote is not None:
            self.on_promote(tid, core, now, speed)

    # ------------------------------------------------------------------ #
    # periodic control + metrics
    # ------------------------------------------------------------------ #
    def periodic(self, now: float) -> None:
        """Run once per idling period: settle aging accurately, sample
        metrics, and apply the policy's working-set correction (Selective
        Core Idling for the proposed technique; baselines return None)."""
        self.settle_all(now)
        n = self.num_cores
        active = int((self.c_state == CState.ACTIVE).sum())
        assigned = int((self.task_of_core >= 0).sum())
        oversub = len(self.oversub_tasks)
        self.metrics.idle_norm_samples.append((active - assigned - oversub) / n)
        self.metrics.active_count_samples.append(active)
        self.metrics.task_count_samples.append(assigned + oversub)
        # Keep the T_oversub integral live for still-waiting tasks; the
        # remainder of each wait is added at release/promotion, so no
        # second is ever counted twice.
        for task_id in self.oversub_tasks:
            self._account_oversub(task_id, now, final=False)

        tel = self._tel
        if tel is not None:
            self._s_active.observe(now, active)
            self._s_oversub.observe(now, oversub)
            self._tel_tick += 1
            if self._tel_tick % tel.timeline_every == 0:
                # settle_all just ran, so dvth is settled to `now`;
                # frequency() here is a pure read of Eq. 1.
                self._record_timelines(now)

        corr = self.policy.periodic(self._view)
        if corr is None:
            return
        # Validate BEFORE mutating: a partial application would leave the
        # manager's bookkeeping corrupted, the exact failure mode the
        # read-only CoreView exists to prevent.
        busy = np.asarray(corr.to_idle)[
            self.task_of_core[corr.to_idle] >= 0] if len(corr.to_idle) else []
        if len(busy):
            raise ValueError(f"policy {self.policy.name!r} tried to idle "
                             f"cores {[int(i) for i in busy]} while they "
                             f"run tasks")
        cause = getattr(corr, "cause", "policy")
        deferred = getattr(corr, "deferred_wakes", 0)
        for i in corr.to_idle:
            # settle_all already brought core i to `now`; close its idle
            # window and power-gate.
            i = int(i)
            idle_dur = now - self.idle_since[i]
            self._record_idle_end(i, idle_dur if idle_dur > 0.0 else 0.0)
            self.c_state[i] = CState.DEEP_IDLE
            self._stamp[i] += 1          # no longer in the free-core heap
            if tel is not None:
                self._c_gates.inc()
                tel.push({"kind": "gate", "t": now,
                          "machine": self._tel_id, "core": i,
                          "cause": cause})
        for i in corr.to_wake:
            i = int(i)
            if self.failed.item(i):
                # Policies see `CoreView.failed_mask`, but a custom
                # policy that ignores it must still never resurrect a
                # failed core.
                continue
            self.c_state[i] = CState.ACTIVE
            self.idle_since[i] = now
            self._push_free(i)
            if tel is not None:
                self._c_wakes.inc()
                tel.push({"kind": "wake", "t": now,
                          "machine": self._tel_id, "core": i,
                          "cause": cause})
        if tel is not None and deferred:
            self._c_deferrals.inc(deferred)
            tel.push({"kind": "carbon_deferral", "t": now,
                      "machine": self._tel_id, "deferred": deferred,
                      "oversub": oversub,
                      "cause": "carbon-aware-deferral"})
        # settle_all already advanced the residency clock to `now`, so the
        # gated-count change takes effect from this instant. Recount from
        # c_state (not a +/- delta) so nonstandard corrections can't drift
        # the residency books.
        self._n_gated = int((self.c_state == CState.DEEP_IDLE).sum())
        if len(corr.to_wake):
            self._promote_oversubscribed(now)

    # ------------------------------------------------------------------ #
    # observability
    # ------------------------------------------------------------------ #
    def _record_timelines(self, now: float) -> None:
        """Per-core aging/frequency/regime snapshot into the cached
        hub timelines (called from `periodic` after `settle_all`, so
        `dvth` is already settled to `now`; pure reads, no mutation)."""
        freq = aging.frequency(self.params, self.f0, self.dvth)
        self._tl_freq.record(now, freq)
        self._tl_dvth.record(now, self.dvth)
        self._tl_cstate.record(now, self.c_state.astype(np.float64))

    def _frequencies_now(self, settle: bool = True) -> np.ndarray:
        if settle:
            self.settle_all(self.now)
        return aging.frequency(self.params, self.f0, self.dvth)

    def frequencies(self, now: float | None = None) -> np.ndarray:
        if now is not None:
            self.settle_all(now)
        return self._frequencies_now(settle=False)

    def frequency_cv(self, now: float | None = None) -> float:
        f = self.frequencies(now)
        return float(np.std(f) / np.mean(f))

    def mean_frequency_degradation(self, now: float | None = None) -> float:
        f = self.frequencies(now)
        return float(np.mean(self.f0 - f))

    def residency(self, now: float | None = None) -> StateResidency:
        """Frozen core-state residency record up to `now` (default: the
        manager's current time). Advances only the residency clock —
        the aging state is untouched."""
        t = self.now if now is None else now
        self.residency_acc.advance(t, len(self._busy_cores), self._n_gated)
        return self.residency_acc.snapshot()

    def snapshot(self) -> dict:
        f = self._frequencies_now(settle=False)
        return {
            "f0": self.f0.copy(),
            "f": f,
            "dvth": self.dvth.copy(),
            "active": (self.c_state == CState.ACTIVE).copy(),
            "cv": float(np.std(f) / np.mean(f)),
            "mean_degradation": float(np.mean(self.f0 - f)),
        }
