"""Vectorized time-stepped fleet engine (`ExperimentConfig.engine="fleet"`),
ported from `repro.sim.fleetsim`.

A mean-field / fluid surrogate of the event engine that advances the
whole stacked ``(n_machines, n_cores)`` fleet state with array ops, so
hundreds of machines x hours of simulated time run at interactive wall
times. The model (workload binning, prefill, decode, the CPU layer,
aging settled once per idling period, and Algorithm 2's reaction
function) is the reference's; see its module docstring.

Two backends share the same physics:

* ``backend="numpy"`` — float64 and deterministic: the reference's numpy
  backend copied unchanged, so it reproduces the reference's
  ``ExperimentResult`` exactly.
* ``backend="torch"`` — the counterpart of the reference's jax backend.
  The fleet state lives in float32 tensors on ``engine_opts["device"]``
  (default ``"cuda"``), the loops over idling periods and micro steps
  are Python loops that launch torch ops (no host sync inside them), and
  the aging settle runs through `repro_torch.kernels.aging_update`: the
  CUDA kernel on the GPU, its plain PyTorch version on the CPU. float32:
  close to, not bit-exact with, numpy.

``backend="auto"`` resolves to torch.

Not ported yet, and refused with NotImplementedError: fault injection
(`fault_model != "none"`), checkpoints (`checkpoint_dir`) and, on the
torch backend, mixed-SKU fleets (ROADMAP A4 and A6). The numpy backend
runs mixed fleets as the reference does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import aging, temperature, variation
from repro_torch.hardware.inventory import resolve_fleet
from repro_torch.kernels.aging_update.ops import advance_fleet
from repro_torch.power.residency import StateResidency
from repro_torch.sim import metrics as metrics_mod
from repro_torch.sim.cluster import (
    DECODE_ITER_BASE_S,
    DECODE_ITER_PER_REQ_S,
    IB_LINK_BW_BPS,
    KV_BYTES_PER_TOKEN,
    MAX_DECODE_BATCH,
    PREFILL_BASE_S,
    PREFILL_PER_TOKEN_S,
)
from repro_torch.sim.config import ExperimentConfig
from repro_torch.sim.results import ExperimentResult
from repro_torch.sim.tasks import TASK_DURATIONS_S

# ---------------------------------------------------------------------- #
# Per-request CPU work (nominal core-seconds), assembled from the same
# task table the event engine schedules discretely (see Machine.*).
# ---------------------------------------------------------------------- #
# prompt side, on arrival: submit -> submit_chain -> alloc_memory ->
# submit_task (the serial admission chain).
_W_PROMPT_ARRIVAL = (TASK_DURATIONS_S["submit"]
                     + TASK_DURATIONS_S["submit_chain"]
                     + TASK_DURATIONS_S["alloc_memory"]
                     + TASK_DURATIONS_S["submit_task"])
# prompt side, on prefill completion: finish_task || submit_flow.
_W_PROMPT_FINISH = (TASK_DURATIONS_S["finish_task"]
                    + TASK_DURATIONS_S["submit_flow"])
# token side, on flow arrival: flow_completion -> alloc_memory.
_W_TOKEN_ARRIVAL = (TASK_DURATIONS_S["flow_completion"]
                    + TASK_DURATIONS_S["alloc_memory"])
# token side, per decode iteration (serial with the GPU pass).
_W_TOKEN_ITER = TASK_DURATIONS_S["start_iteration"]
# token side, on request completion: free_memory + finish_request
# (after t_done — not on the latency critical path, but CPU load).
_W_TOKEN_FINISH = (TASK_DURATIONS_S["free_memory"]
                   + TASK_DURATIONS_S["finish_request"])
# serial CPU latency before prefill admission (excludes submit_task,
# which is folded into the prefill service time like the event loop).
_LAT_CPU_PROMPT = (TASK_DURATIONS_S["submit"]
                   + TASK_DURATIONS_S["submit_chain"]
                   + TASK_DURATIONS_S["alloc_memory"])
_MEAN_TASK_S = float(np.mean(list(TASK_DURATIONS_S.values())))
_KV_S_PER_TOKEN = KV_BYTES_PER_TOKEN / IB_LINK_BW_BPS

_IDLE_BINS = 512          # linear histogram over [-1, 1] for idle_norm
_EPS = 1e-12


def _resolve_backend(requested: str) -> str:
    """'auto' takes the torch backend, the port's counterpart of jax."""
    if requested in ("numpy", "torch"):
        return requested
    if requested == "auto":
        return "torch"
    raise ValueError(f"unknown fleet backend {requested!r}: expected "
                     f"'numpy', 'torch' or 'auto'")

@dataclasses.dataclass
class _Shape:
    """Static geometry + timing constants of one fleet run."""
    n_prompt: int
    n_token: int
    num_cores: int
    dt_s: float
    steps_per_period: int     # micro steps per idling period
    n_macro: int              # macro (idling-period) steps
    mwin_s: float             # metrics-window width
    n_mwin: int
    pwin_s: float             # residency-window width
    n_pwin: int
    duration_s: float
    mean_out_tokens: float    # trace-wide mean output tokens/request
    gating: bool              # policy gates cores (Algorithm 2)?
    # per-machine CPU-wait clip fed into the window means: inf (exact
    # no-op) when faultless; duration_s under fault injection, so one
    # dead machine's unbounded backlog/capacity ratio can't poison the
    # fleet-mean latency windows
    wait_cap_s: float = float("inf")
    # per-machine core counts for heterogeneous fleets
    # (`repro.hardware`): None = uniform legacy fleet (`num_cores`
    # everywhere, zero ragged bookkeeping); otherwise a fleet-order
    # tuple and `num_cores` is the padded max — lanes beyond a
    # machine's count are excluded everywhere via a pad mask.
    core_counts: tuple | None = None

    @property
    def n_machines(self) -> int:
        return self.n_prompt + self.n_token

    @property
    def total_cores(self) -> int:
        if self.core_counts is None:
            return self.n_machines * self.num_cores
        return int(sum(self.core_counts))


def _initial_state(shape: _Shape) -> dict[str, np.ndarray]:
    """Stacked fleet state; every mutable quantity of a run lives here
    (and therefore checkpoints/restores as one array dict)."""
    M, N = shape.n_machines, shape.num_cores
    P, K = shape.n_prompt, shape.n_token
    W, PW = shape.n_mwin, shape.n_pwin
    return {
        "macro": np.zeros((), dtype=np.int64),       # completed macro steps
        "dvth": np.zeros((M, N)),
        "gated": np.zeros((M, N), dtype=bool),
        # fluid queues
        "pq_s": np.zeros(P), "pq_n": np.zeros(P), "pq_out": np.zeros(P),
        "d_batch": np.zeros(K), "d_tokens": np.zeros(K),
        "d_pend": np.zeros(K), "d_pend_tok": np.zeros(K),
        "cpu_backlog": np.zeros(M),
        "busy_s": np.zeros((M, N)),     # busy core-seconds since settle
        "u_last": np.zeros(M), "ov_last": np.zeros(M),
        # metrics windows (streaming aggregates — bounded for any horizon)
        "mw_cnt": np.zeros(W), "mw_wait": np.zeros(W),
        "mw_iter": np.zeros(W), "mw_cpuw": np.zeros(W),
        "mw_sp": np.zeros(W), "mw_st": np.zeros(W),
        "mw_comps": np.zeros(W),
        # residency windows (per machine, for the power models)
        "res_busy": np.zeros((M, PW)), "res_idle": np.zeros((M, PW)),
        "res_gated": np.zeros((M, PW)), "res_fbusy": np.zeros((M, PW)),
        # sample statistics
        "idle_hist": np.zeros(_IDLE_BINS, dtype=np.int64),
        "task_sum": np.zeros(()), "task_cnt": np.zeros(()),
        "task_max": np.zeros(()),
        "completions": np.zeros(()),
    }


# ---------------------------------------------------------------------- #
# Functional fleet step of the numpy backend, copied from the reference
# (which runs it under numpy and jax.numpy through the namespace `xp`).
# ---------------------------------------------------------------------- #
def _micro_step(xp, shape: _Shape, dyn, q, arr_row):
    """One fluid micro step. `dyn` = per-period derived state
    (sp, st, sm, active counts); `q` = queue-state tuple; `arr_row` =
    (arrivals, input-token sum, output-token sum) for this step.
    Returns (q', observables)."""
    (pq_s, pq_n, pq_out, d_batch, d_tokens, d_pend, d_pend_tok,
     cpu_backlog) = q
    sp, st, sm, active = dyn          # (P,), (K,), (M,), (M,)
    P, K = shape.n_prompt, shape.n_token
    dt = shape.dt_s
    a, in_sum, out_sum = arr_row

    # Prefill wait seen by an arrival this step: GPU backlog ahead of it
    # (sampled before the arrival joins), fleet-mean across prompt
    # instances (even JSQ-limit split).
    wait_p = xp.mean(pq_s)

    # 1) arrivals -> prompt queues (even split) + prompt CPU work
    pq_n = pq_n + a / P
    pq_s = pq_s + (a * PREFILL_BASE_S + PREFILL_PER_TOKEN_S * in_sum
                   + a * TASK_DURATIONS_S["submit_task"] / sp) / P
    pq_out = pq_out + out_sum / P
    work_p = (a / P) * _W_PROMPT_ARRIVAL

    # 2) prefill drain (1 GPU-second per second)
    ds = xp.minimum(pq_s, dt)
    frac = ds / xp.maximum(pq_s, _EPS)
    done_n = pq_n * frac
    done_out = pq_out * frac
    pq_s = pq_s - ds
    pq_n = pq_n - done_n
    pq_out = pq_out - done_out
    work_p = work_p + done_n * _W_PROMPT_FINISH
    c_total = xp.sum(done_n)
    o_total = xp.sum(done_out)

    # 3) flow to token instances (even split) + decode admission
    d_pend = d_pend + c_total / K
    d_pend_tok = d_pend_tok + o_total / K
    work_t = (c_total / K) * _W_TOKEN_ARRIVAL
    room = xp.maximum(MAX_DECODE_BATCH - d_batch, 0.0)
    adm = xp.minimum(d_pend, room)
    tok_per_pend = d_pend_tok / xp.maximum(d_pend, _EPS)
    d_batch = d_batch + adm
    d_tokens = d_tokens + adm * tok_per_pend
    d_pend = d_pend - adm
    d_pend_tok = d_pend_tok - adm * tok_per_pend

    # 4) decode iterations: CPU start_iteration is serial with the GPU
    # pass, so aged (slower) CPUs stretch the iteration period — the
    # paper's aging -> service-quality coupling.
    iter_period = (_W_TOKEN_ITER / st + DECODE_ITER_BASE_S
                   + DECODE_ITER_PER_REQ_S
                   * xp.minimum(d_batch, MAX_DECODE_BATCH))
    busy_gpu = d_batch > _EPS
    iters = xp.where(busy_gpu, dt / iter_period, 0.0)
    tokens_out = xp.minimum(iters * d_batch, d_tokens)
    # completion rate = batch x token-rate / remaining mass (fluid drain
    # of the residual-token distribution; integrates to the full batch).
    comps = xp.minimum(
        d_batch * tokens_out / xp.maximum(d_tokens, _EPS), d_batch)
    d_tokens = xp.maximum(d_tokens - tokens_out, 0.0)
    drained = d_tokens <= _EPS
    comps = xp.where(drained, d_batch, comps)
    d_batch = xp.where(drained, 0.0, xp.maximum(d_batch - comps, 0.0))
    work_t = work_t + _W_TOKEN_ITER * iters + comps * _W_TOKEN_FINISH
    comps_total = xp.sum(comps)

    # 5) CPU layer (Little's law): nominal work executes at the settled
    # mean core speed; overflow carries as oversubscription backlog.
    work = xp.concatenate([work_p, work_t])
    todo = cpu_backlog + work
    cap = active * dt * sm
    done = xp.minimum(todo, cap)
    cpu_backlog = todo - done
    u = done / (dt * sm)                       # busy cores (fractional)
    ov = cpu_backlog / _MEAN_TASK_S            # oversubscribed tasks
    cpu_wait = xp.mean(xp.minimum(
        cpu_backlog / xp.maximum(active * sm, _EPS), shape.wait_cap_s))

    q2 = (pq_s, pq_n, pq_out, d_batch, d_tokens, d_pend, d_pend_tok,
          cpu_backlog)
    obs = {
        "u": u, "ov": ov, "done": done,
        "wait_p": wait_p,
        "iter_mean": xp.mean(iter_period),
        "cpu_wait": cpu_wait,
        "comps": comps_total,
        "sp_mean": xp.mean(sp), "st_mean": xp.mean(st),
    }
    return q2, obs


def _settle_aging(shape: _Shape, dvth, gated, busy_s, advance):
    """Settle one idling period of aging: every non-gated core spends
    its accumulated busy core-seconds at active-allocated stress and the
    remainder of the period at active-unallocated stress; gated cores
    are frozen (ADF = 0). Exact per regime — the NBTI recursion composes
    under a constant ADF."""
    period = shape.steps_per_period * shape.dt_s
    tau_busy = np.minimum(busy_s, period) if isinstance(busy_s, np.ndarray) \
        else busy_s
    tau_idle = period - tau_busy
    dvth = advance(dvth, gated, tau_busy,
                   temperature.TEMP_ACTIVE_ALLOCATED_C)
    dvth = advance(dvth, gated, tau_idle,
                   temperature.TEMP_ACTIVE_UNALLOCATED_C)
    return dvth


def _gate_correction(xp, shape: _Shape, active_n, u, ov, g_now, carbon,
                     n_vec=None):
    """Vectorized Algorithm 2 reaction (`idling.core_correction`), with
    the optional carbon-aware temporal reshaping. `n_vec` (ragged
    fleets) supplies per-machine core counts; None keeps the uniform
    scalar `shape.num_cores`."""
    N = shape.num_cores if n_vec is None else n_vec
    tasks = xp.minimum(N * 1.0, u + ov)
    e = (active_n - tasks) / N
    f = xp.where(e >= 0.0, xp.tan(0.785 * e), xp.arctan(1.55 * e))
    corr = xp.trunc(N * f)
    if carbon is not None:
        g_mean, dirty_frac, defer_frac, guard, gain = carbon
        dirty = g_now > dirty_frac * g_mean
        amplified = xp.trunc(corr * gain)
        deferred = corr + xp.trunc(-corr * defer_frac)
        corr = xp.where(
            dirty & (corr > 0), amplified,
            xp.where(dirty & (corr < 0) & (ov <= guard), deferred, corr))
    return corr


def _apply_gating(xp, corr, gated, busy_n, dvth, failed=None):
    """Vectorized `idling.apply_correction`: gate `corr` most-aged
    spare active cores (+) or wake `-corr` least-aged gated cores (-)
    per machine, by rank selection along the core axis. `failed`
    (fault layer) excludes permanently-offlined cores from both sides —
    they are never active and must never be woken; `None` leaves the
    selection identical to the pre-fault behavior."""
    active = ~gated if failed is None else ~gated & ~failed
    wakeable = gated if failed is None else gated & ~failed
    eligible = xp.sum(active, axis=1) - busy_n
    k_gate = xp.clip(corr, 0.0, xp.maximum(eligible, 0.0))
    key = xp.where(active, dvth, -np.inf)
    rank_g = xp.argsort(xp.argsort(-key, axis=1), axis=1)
    gate_new = rank_g < k_gate[:, None]
    k_wake = xp.clip(-corr, 0.0, xp.sum(wakeable, axis=1))
    keyw = xp.where(wakeable, dvth, np.inf)
    rank_w = xp.argsort(xp.argsort(keyw, axis=1), axis=1)
    wake = rank_w < k_wake[:, None]
    return (gated | gate_new) & ~wake


def _derived(xp, shape: _Shape, f0, dvth, gated, headroom):
    """Per-period derived quantities: settled per-core speeds and the
    per-machine active-core mean speed used by the fluid layers."""
    f = f0 * (1.0 - dvth / headroom)
    active = ~gated
    active_n = xp.sum(active, axis=1)
    sm = xp.sum(xp.where(active, f, 0.0), axis=1) / xp.maximum(
        active_n, 1.0)
    sp = sm[:shape.n_prompt]
    st = sm[shape.n_prompt:]
    return f, sp, st, sm, active_n


# ---------------------------------------------------------------------- #
# Torch step — the same physics as `_micro_step`, `_gate_correction` and
# `_apply_gating` above, written against float32 tensors on one device.
# Mirrors the reference's jax backend (`repro.sim.fleetsim._run_jax`).
# ---------------------------------------------------------------------- #
def _micro_step_torch(shape: _Shape, dyn, q, arr_row):
    """`_micro_step` on tensors. `arr_row` holds three 0-dim tensors."""
    (pq_s, pq_n, pq_out, d_batch, d_tokens, d_pend, d_pend_tok,
     cpu_backlog) = q
    sp, st, sm, active = dyn
    P, K = shape.n_prompt, shape.n_token
    dt = shape.dt_s
    a, in_sum, out_sum = arr_row

    wait_p = pq_s.mean()

    # 1) arrivals -> prompt queues (even split) + prompt CPU work
    pq_n = pq_n + a / P
    pq_s = pq_s + (a * PREFILL_BASE_S + PREFILL_PER_TOKEN_S * in_sum
                   + a * TASK_DURATIONS_S["submit_task"] / sp) / P
    pq_out = pq_out + out_sum / P
    work_p = (a / P) * _W_PROMPT_ARRIVAL

    # 2) prefill drain (1 GPU-second per second)
    ds = torch.clamp(pq_s, max=dt)
    frac = ds / torch.clamp(pq_s, min=_EPS)
    done_n = pq_n * frac
    done_out = pq_out * frac
    pq_s = pq_s - ds
    pq_n = pq_n - done_n
    pq_out = pq_out - done_out
    work_p = work_p + done_n * _W_PROMPT_FINISH
    c_total = done_n.sum()
    o_total = done_out.sum()

    # 3) flow to token instances (even split) + decode admission
    d_pend = d_pend + c_total / K
    d_pend_tok = d_pend_tok + o_total / K
    work_t = (c_total / K) * _W_TOKEN_ARRIVAL
    room = torch.clamp(MAX_DECODE_BATCH - d_batch, min=0.0)
    adm = torch.minimum(d_pend, room)
    tok_per_pend = d_pend_tok / torch.clamp(d_pend, min=_EPS)
    d_batch = d_batch + adm
    d_tokens = d_tokens + adm * tok_per_pend
    d_pend = d_pend - adm
    d_pend_tok = d_pend_tok - adm * tok_per_pend

    # 4) decode iterations, serial with the CPU's start_iteration
    iter_period = (_W_TOKEN_ITER / st + DECODE_ITER_BASE_S
                   + DECODE_ITER_PER_REQ_S
                   * torch.clamp(d_batch, max=MAX_DECODE_BATCH))
    busy_gpu = d_batch > _EPS
    iters = torch.where(busy_gpu, dt / iter_period, 0.0)
    tokens_out = torch.minimum(iters * d_batch, d_tokens)
    comps = torch.minimum(
        d_batch * tokens_out / torch.clamp(d_tokens, min=_EPS), d_batch)
    d_tokens = torch.clamp(d_tokens - tokens_out, min=0.0)
    drained = d_tokens <= _EPS
    comps = torch.where(drained, d_batch, comps)
    d_batch = torch.where(drained, 0.0,
                          torch.clamp(d_batch - comps, min=0.0))
    work_t = work_t + _W_TOKEN_ITER * iters + comps * _W_TOKEN_FINISH
    comps_total = comps.sum()

    # 5) CPU layer (Little's law)
    work = torch.cat([work_p, work_t])
    todo = cpu_backlog + work
    cap = active * dt * sm
    done = torch.minimum(todo, cap)
    cpu_backlog = todo - done
    u = done / (dt * sm)
    ov = cpu_backlog / _MEAN_TASK_S
    cpu_wait = torch.clamp(
        cpu_backlog / torch.clamp(active * sm, min=_EPS),
        max=shape.wait_cap_s).mean()

    q2 = (pq_s, pq_n, pq_out, d_batch, d_tokens, d_pend, d_pend_tok,
          cpu_backlog)
    obs = {
        "u": u, "ov": ov, "done": done,
        "wait_p": wait_p,
        "iter_mean": iter_period.mean(),
        "cpu_wait": cpu_wait,
        "comps": comps_total,
        "sp_mean": sp.mean(), "st_mean": st.mean(),
    }
    return q2, obs


def _gate_correction_torch(shape: _Shape, active_n, u, ov, dirty: bool,
                           carbon):
    """`_gate_correction` on tensors (uniform fleets). `dirty` is the
    carbon gate's verdict for this period, decided on the host from the
    same float32 values the jax backend compares."""
    N = shape.num_cores
    tasks = torch.clamp(u + ov, max=N * 1.0)
    e = (active_n - tasks) / N
    f = torch.where(e >= 0.0, torch.tan(0.785 * e), torch.atan(1.55 * e))
    corr = torch.trunc(N * f)
    if carbon is not None and dirty:
        _, _, defer_frac, guard, gain = carbon
        amplified = torch.trunc(corr * gain)
        deferred = corr + torch.trunc(-corr * defer_frac)
        corr = torch.where(
            corr > 0, amplified,
            torch.where((corr < 0) & (ov <= guard), deferred, corr))
    return corr


def _apply_gating_torch(corr, gated, busy_n, dvth):
    """`_apply_gating` on tensors (no failed cores). The ranks use stable
    sorts: at t = 0 every dVth is 0 and every key ties, and jax's argsort
    is stable too."""
    active = ~gated
    eligible = active.sum(dim=1) - busy_n
    k_gate = torch.minimum(torch.clamp(corr, min=0.0),
                           torch.clamp(eligible, min=0.0))
    key = torch.where(active, dvth, -np.inf)
    rank_g = torch.argsort(torch.argsort(-key, dim=1, stable=True), dim=1,
                           stable=True)
    gate_new = rank_g < k_gate[:, None]
    k_wake = torch.minimum(torch.clamp(-corr, min=0.0), gated.sum(dim=1))
    keyw = torch.where(gated, dvth, np.inf)
    rank_w = torch.argsort(torch.argsort(keyw, dim=1, stable=True), dim=1,
                           stable=True)
    wake = rank_w < k_wake[:, None]
    return (gated | gate_new) & ~wake


# Layout of the torch state. The float columns of `_initial_state` are
# float32 tensors; the seven metric-window and four residency columns
# are stacked into `mw` (7, W) and `res` (4, M, PW) for one add each per
# micro step, as the jax backend stacks them.
_F32_KEYS = ("dvth", "pq_s", "pq_n", "pq_out", "d_batch", "d_tokens",
             "d_pend", "d_pend_tok", "cpu_backlog", "busy_s", "u_last",
             "ov_last", "task_sum", "task_cnt", "task_max", "completions")
_MW_KEYS = ("mw_cnt", "mw_wait", "mw_iter", "mw_cpuw", "mw_sp", "mw_st",
            "mw_comps")
_RES_KEYS = ("res_busy", "res_idle", "res_gated", "res_fbusy")
_QUEUE_KEYS = ("pq_s", "pq_n", "pq_out", "d_batch", "d_tokens", "d_pend",
               "d_pend_tok", "cpu_backlog")


def state_from_numpy(state: dict, device="cpu") -> dict:
    """A `FleetEngine.state` (numpy arrays, the reference's layout too)
    as the torch backend's state on `device`: float32 tensors, `mw` and
    `res` stacked, `macro` a Python int. Copies; never aliases `state`."""
    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32,
                            device=device)

    out = {k: f32(state[k]) for k in _F32_KEYS}
    out["mw"] = f32(np.stack([state[k] for k in _MW_KEYS]))
    out["res"] = f32(np.stack([state[k] for k in _RES_KEYS]))
    out["gated"] = torch.tensor(np.asarray(state["gated"]),
                                dtype=torch.bool, device=device)
    out["idle_hist"] = torch.tensor(np.asarray(state["idle_hist"]),
                                    dtype=torch.int64, device=device)
    out["macro"] = int(state["macro"])
    return out


def state_to_numpy(tstate: dict) -> dict:
    """The inverse of `state_from_numpy`: float64 / bool / int64 numpy
    arrays in `FleetEngine.state`'s layout (as `_unpack_jax` gives)."""
    def host(t, dtype):
        return t.detach().cpu().numpy().astype(dtype)

    s = {k: host(tstate[k], np.float64) for k in _F32_KEYS}
    s.update(zip(_MW_KEYS, host(tstate["mw"], np.float64)))
    s.update(zip(_RES_KEYS, host(tstate["res"], np.float64)))
    s["gated"] = host(tstate["gated"], bool)
    s["idle_hist"] = host(tstate["idle_hist"], np.int64)
    s["macro"] = np.asarray(tstate["macro"], dtype=np.int64)
    return s


# ---------------------------------------------------------------------- #
# Engine
# ---------------------------------------------------------------------- #
class FleetEngine:
    """Time-stepped vectorized fleet simulator (see module docstring).

    ``engine_opts`` (via ``ExperimentConfig.engine_opts``):

    * ``dt_s`` (default 0.25) — fluid micro-step width, seconds.
    * ``backend`` — "numpy" | "torch" | "auto" (default "auto" = torch).
    * ``device`` (default "cuda") — where the torch backend runs. It
      raises if CUDA is asked for and absent: pass ``device="cpu"`` to
      run on the CPU.
    * ``checkpoint_dir``, ``checkpoint_every_s``, ``resume`` — not
      ported yet: each raises NotImplementedError.
    """

    def __init__(self, cfg: ExperimentConfig):
        opts = cfg.engine_options
        ckpt = sorted(set(opts) & {"checkpoint_dir", "checkpoint_every_s",
                                   "resume"})
        if ckpt:
            raise NotImplementedError(
                f"fleet checkpoints (engine_opts {ckpt}) are not ported "
                f"yet: ROADMAP A6 (checkpoint store)")
        unknown = set(opts) - {"dt_s", "backend", "device"}
        if unknown:
            raise ValueError(f"unknown engine_opts {sorted(unknown)}")
        if cfg.fault_model != "none":
            raise NotImplementedError(
                f"fault injection (fault_model={cfg.fault_model!r}) is not "
                f"ported yet: ROADMAP A4 (faults)")
        self.cfg = cfg
        self.backend = _resolve_backend(str(opts.get("backend", "auto")))
        self.device = None
        if self.backend == "torch":
            self.device = torch.device(opts.get("device", "cuda"))
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    "the torch fleet backend runs on device "
                    f"{str(self.device)!r} but CUDA is not available; pass "
                    "engine_opts device='cpu' to run it on the CPU")

        dt = float(opts.get("dt_s", 0.25))
        if dt <= 0:
            raise ValueError(f"dt_s must be > 0, got {dt}")
        dt = min(dt, cfg.idling_period_s)
        spp = max(1, round(cfg.idling_period_s / dt))
        dt = cfg.idling_period_s / spp          # align to the period
        n_macro = max(1, int(round(cfg.duration_s / cfg.idling_period_s)))
        mwin = max(dt, cfg.duration_s / 512.0)
        pwin = cfg.resolved_power_window_s
        # Heterogeneous fleet (`repro_torch.hardware`): None for the uniform
        # default, in which case every branch below runs the legacy
        # bit-exact path with zero ragged bookkeeping. Mixed fleets pad
        # the core axis to the widest SKU and mask the extra lanes.
        self.inventory = resolve_fleet(cfg.fleet, cfg.fleet_options,
                                       cfg.n_machines)
        inv = self.inventory
        if inv is not None and self.backend == "torch":
            raise NotImplementedError(
                f"mixed fleets (fleet={cfg.fleet!r}) on the torch backend "
                f"are not ported yet: ROADMAP A6 (ragged fleets); "
                f"backend='numpy' runs them")
        if inv is None:
            self.params = aging.DEFAULT_PARAMS
            num_cores, core_counts = cfg.num_cores, None
        else:
            # one shared NBTI operating point (raises for mixed Vdd/Vth
            # fleets — those need the per-machine event engine)
            self.params = inv.shared_dynamics_params()
            num_cores, core_counts = inv.max_cores, tuple(inv.num_cores)
        self.shape = _Shape(
            n_prompt=cfg.n_prompt, n_token=cfg.n_token,
            num_cores=num_cores, dt_s=dt, steps_per_period=spp,
            n_macro=n_macro,
            mwin_s=mwin, n_mwin=int(np.ceil(cfg.duration_s / mwin)) + 1,
            pwin_s=pwin, n_pwin=int(np.ceil(cfg.duration_s / pwin)) + 1,
            duration_s=cfg.duration_s,
            mean_out_tokens=0.0,        # set from the trace in run()
            gating=cfg.policy == "proposed",
            core_counts=core_counts,
        )
        # Same per-machine initial-frequency draw as the event engine's
        # CoreManager (seeded rng per machine), so both engines simulate
        # literally the same silicon — on mixed fleets each machine
        # draws its own SKU's variation parameters and core count.
        if inv is None:
            vp = variation.VariationParams(f_nominal=self.params.f_nominal)
            self.f0 = np.stack([
                variation.sample_initial_frequencies(
                    vp, cfg.num_cores,
                    np.random.default_rng(cfg.seed * 1000 + i))
                for i in range(self.shape.n_machines)])
            self._pad = None
            self._n_vec = None
        else:
            self.f0 = np.ones((self.shape.n_machines, num_cores))
            for i, n in enumerate(core_counts):
                self.f0[i, :n] = variation.sample_initial_frequencies(
                    inv.variation_params[i], n,
                    np.random.default_rng(cfg.seed * 1000 + i))
            self._pad = (np.arange(num_cores)[None, :]
                         >= np.asarray(core_counts)[:, None])
            self._n_vec = np.asarray(core_counts, dtype=np.float64)
        self._carbon_gate = self._resolve_carbon_gate(cfg)
        self.state = _initial_state(self.shape)

    @staticmethod
    def _resolve_carbon_gate(cfg: ExperimentConfig):
        """(intensity_fn, params) for carbon-aware proposed configs."""
        popts = cfg.policy_options
        if cfg.policy != "proposed" or not popts.get("carbon_aware"):
            return None
        from repro_torch.carbon.intensity import get_intensity
        intensity = get_intensity(popts.get("intensity", "diurnal"),
                                  **dict(popts.get("intensity_opts") or {}))
        return (intensity,
                (intensity.mean_g_per_kwh(),
                 float(popts.get("dirty_frac", 1.05)),
                 float(popts.get("defer_frac", 0.5)),
                 float(popts.get("guard_tasks", 2)),
                 float(popts.get("gate_gain", 2.0))))

    # ------------------------------------------------------------------ #
    # trace binning
    # ------------------------------------------------------------------ #
    def _bin_trace(self, requests) -> np.ndarray:
        """(T_micro, 3) per-step [arrival count, input-token sum,
        output-token sum] from the scenario's request trace."""
        sh = self.shape
        n_steps = sh.n_macro * sh.steps_per_period
        out = np.zeros((n_steps, 3))
        if not requests:
            return out
        t_arr = np.fromiter((r.arrival_s for r in requests), float,
                            count=len(requests))
        n_in = np.fromiter((r.input_tokens for r in requests), float,
                           count=len(requests))
        n_out = np.fromiter((r.output_tokens for r in requests), float,
                            count=len(requests))
        idx = np.clip((t_arr / sh.dt_s).astype(np.int64), 0, n_steps - 1)
        out[:, 0] = np.bincount(idx, minlength=n_steps)
        out[:, 1] = np.bincount(idx, weights=n_in, minlength=n_steps)
        out[:, 2] = np.bincount(idx, weights=n_out, minlength=n_steps)
        return out

    # ------------------------------------------------------------------ #
    # run
    # ------------------------------------------------------------------ #
    def run(self, requests) -> None:
        sh = self.shape
        sh.mean_out_tokens = (float(np.mean([r.output_tokens
                                             for r in requests]))
                              if requests else 1.0)
        arr = self._bin_trace(requests)
        self._requests = requests
        if self.backend == "torch":
            self._run_torch(arr, 0)
        else:
            self._run_numpy(arr, 0)

    # -- numpy driver --------------------------------------------------- #
    def _advance_numpy(self, dvth, gated, tau, temp_c):
        a = aging.adf(self.params, temp_c, 1.0)
        tau = np.where(gated, 0.0, np.broadcast_to(tau, dvth.shape))
        return aging.advance_dvth(self.params, dvth, a, tau)

    def _run_numpy(self, arr: np.ndarray, start_macro: int) -> None:
        sh, st = self.shape, self.state
        xp = np
        spp = sh.steps_per_period
        g_fn = self._carbon_gate[0].g_per_kwh if self._carbon_gate else None
        pad = self._pad
        # per-machine core counts: the scalar num_cores on uniform
        # fleets (identical arithmetic to the pre-hardware engine), a
        # (M,) vector on ragged ones
        n_vec = sh.num_cores if pad is None else self._n_vec
        for k in range(start_macro, sh.n_macro):
            gated_eff = st["gated"] if pad is None else st["gated"] | pad
            f, sp, spd_t, sm, active_n = _derived(
                xp, sh, self.f0, st["dvth"], gated_eff,
                self.params.headroom)
            dyn = (sp, spd_t, sm, active_n)
            q = (st["pq_s"], st["pq_n"], st["pq_out"], st["d_batch"],
                 st["d_tokens"], st["d_pend"], st["d_pend_tok"],
                 st["cpu_backlog"])
            for j in range(spp):
                step = k * spp + j
                t = step * sh.dt_s
                q, obs = _micro_step(xp, sh, dyn, q, arr[step])
                u, ov, done = obs["u"], obs["ov"], obs["done"]
                # streaming window aggregates (in place: bounded memory)
                w = min(int(t / sh.mwin_s), sh.n_mwin - 1)
                st["mw_cnt"][w] += 1.0
                st["mw_wait"][w] += obs["wait_p"]
                st["mw_iter"][w] += obs["iter_mean"]
                st["mw_cpuw"][w] += obs["cpu_wait"]
                st["mw_sp"][w] += obs["sp_mean"]
                st["mw_st"][w] += obs["st_mean"]
                st["mw_comps"][w] += obs["comps"]
                pw = min(int(t / sh.pwin_s), sh.n_pwin - 1)
                busy_cs = done / sm
                st["res_busy"][:, pw] += busy_cs
                st["res_idle"][:, pw] += active_n * sh.dt_s - busy_cs
                st["res_gated"][:, pw] += (n_vec - active_n) * sh.dt_s
                st["res_fbusy"][:, pw] += done
                tasks = u + ov
                st["task_sum"] += tasks.sum()
                st["task_cnt"] += tasks.size
                st["task_max"] = np.maximum(st["task_max"], tasks.max())
                st["completions"] += obs["comps"]
                # spread busy time evenly over this period's active set
                st["busy_s"] += np.where(
                    gated_eff, 0.0,
                    (busy_cs / np.maximum(active_n, 1.0))[:, None])
            (st["pq_s"], st["pq_n"], st["pq_out"], st["d_batch"],
             st["d_tokens"], st["d_pend"], st["d_pend_tok"],
             st["cpu_backlog"]) = q
            st["u_last"], st["ov_last"] = u, ov

            # macro boundary: settle aging, sample, gate (same order as
            # the event engine's periodic tick).
            st["dvth"] = _settle_aging(sh, st["dvth"], gated_eff,
                                       st["busy_s"], self._advance_numpy)
            st["busy_s"][:] = 0.0
            idle_norm = (active_n - u - ov) / n_vec
            bins = np.clip(((idle_norm + 1.0) * 0.5
                            * (_IDLE_BINS - 1)).astype(np.int64),
                           0, _IDLE_BINS - 1)
            st["idle_hist"] += np.bincount(bins, minlength=_IDLE_BINS)
            if sh.gating:
                t_now = (k + 1) * spp * sh.dt_s
                g_now = g_fn(t_now) if g_fn else 0.0
                carbon = self._carbon_gate[1] if self._carbon_gate else None
                corr = _gate_correction(xp, sh, active_n, u, ov, g_now,
                                        carbon, n_vec=self._n_vec)
                # padded lanes behave like permanently failed cores:
                # never gateable, never wakeable
                fail_eff = pad
                st["gated"] = _apply_gating(xp, corr, st["gated"],
                                            np.ceil(np.minimum(u,
                                                               active_n)),
                                            st["dvth"],
                                            failed=fail_eff)
            st["macro"] = np.asarray(k + 1, dtype=np.int64)

    # -- torch driver --------------------------------------------------- #
    def _run_torch(self, arr: np.ndarray, start_macro: int) -> None:
        """The reference's `_run_jax` with its two nested `lax.scan`s as
        Python loops of torch ops on `self.device`. Everything a step
        needs from the host (trace rows, window indices, the carbon
        gate's verdict) is prepared before the loops, so they never wait
        for the device."""
        sh, dev = self.shape, self.device
        params = self.params
        spp = sh.steps_per_period
        P = sh.n_prompt
        carbon = self._carbon_gate[1] if self._carbon_gate else None
        f0 = torch.tensor(self.f0, dtype=torch.float32, device=dev)

        # Window indices from the float32 step times the jax backend
        # uses, in float32 arithmetic, computed once on the host.
        ts = (np.arange(sh.n_macro * spp) * sh.dt_s).astype(np.float32)
        w_idx = np.minimum((ts / np.float32(sh.mwin_s)).astype(np.int32),
                           sh.n_mwin - 1).tolist()
        pw_idx = np.minimum((ts / np.float32(sh.pwin_s)).astype(np.int32),
                            sh.n_pwin - 1).tolist()
        rows = torch.tensor(arr, dtype=torch.float32, device=dev)
        if carbon is not None:
            # dirty = g_now > dirty_frac * g_mean, compared in float32
            g_fn = self._carbon_gate[0].g_per_kwh
            g_mean, dirty_frac = carbon[0], carbon[1]
            dirty = [bool(np.float32(g_fn((k + 1) * spp * sh.dt_s))
                          > np.float32(dirty_frac * g_mean))
                     for k in range(sh.n_macro)]
        else:
            dirty = [False] * sh.n_macro

        def advance(dvth, gated, tau, temp_c):
            flat = dvth.reshape(-1)
            stress = torch.where(gated, 0.0, 1.0).reshape(-1)
            tau_f = torch.broadcast_to(tau, dvth.shape).reshape(-1)
            temp = torch.full_like(flat, temp_c)
            out = advance_fleet(flat, temp, stress, tau_f.contiguous(),
                                params)
            return out.reshape(dvth.shape)

        st = state_from_numpy(self.state, dev)
        mw, res = st["mw"], st["res"]
        one = torch.ones((), dtype=torch.float32, device=dev)
        hist_one = torch.ones(sh.n_machines, dtype=torch.int64, device=dev)
        n_vec = sh.num_cores
        for k in range(start_macro, sh.n_macro):
            gated_eff = st["gated"]
            f = f0 * (1.0 - st["dvth"] / params.headroom)
            active = ~gated_eff
            active_n = active.sum(dim=1).to(torch.float32)
            sm = (torch.where(active, f, 0.0).sum(dim=1)
                  / torch.clamp(active_n, min=1.0))
            dyn = (sm[:P], sm[P:], sm, active_n)
            q = tuple(st[key] for key in _QUEUE_KEYS)
            for step in range(k * spp, (k + 1) * spp):
                q, obs = _micro_step_torch(sh, dyn, q, rows[step])
                u, ov, done = obs["u"], obs["ov"], obs["done"]
                mw[:, w_idx[step]] += torch.stack([
                    one, obs["wait_p"], obs["iter_mean"], obs["cpu_wait"],
                    obs["sp_mean"], obs["st_mean"], obs["comps"]])
                busy_cs = done / sm
                res[:, :, pw_idx[step]] += torch.stack([
                    busy_cs, active_n * sh.dt_s - busy_cs,
                    (n_vec - active_n) * sh.dt_s, done])
                tasks = u + ov
                st["task_sum"] += tasks.sum()
                st["task_cnt"] += tasks.numel()
                st["task_max"] = torch.maximum(st["task_max"], tasks.max())
                st["completions"] += obs["comps"]
                st["busy_s"] += torch.where(
                    gated_eff, 0.0,
                    (busy_cs / torch.clamp(active_n, min=1.0))[:, None])
            for key, v in zip(_QUEUE_KEYS, q):
                st[key] = v
            st["u_last"], st["ov_last"] = u, ov

            # macro boundary: settle aging, sample, gate
            st["dvth"] = _settle_aging(sh, st["dvth"], gated_eff,
                                       st["busy_s"], advance)
            st["busy_s"].zero_()
            idle_norm = (active_n - u - ov) / n_vec
            bins = torch.clamp(((idle_norm + 1.0) * 0.5
                                * (_IDLE_BINS - 1)).to(torch.int32),
                               0, _IDLE_BINS - 1).long()
            # index_add_, not bincount: CUDA bincount reads the largest
            # bin back to the host, a sync in every period
            st["idle_hist"].index_add_(0, bins, hist_one)
            if sh.gating:
                corr = _gate_correction_torch(sh, active_n, u, ov,
                                              dirty[k], carbon)
                st["gated"] = _apply_gating_torch(
                    corr, st["gated"],
                    torch.ceil(torch.minimum(u, active_n)), st["dvth"])
            st["macro"] = k + 1
        self.state = state_to_numpy(st)

    # ------------------------------------------------------------------ #
    # collection
    # ------------------------------------------------------------------ #
    def _window_means(self):
        st = self.state
        cnt = np.maximum(st["mw_cnt"], 1.0)
        means = {k: st[k] / cnt
                 for k in ("mw_wait", "mw_iter", "mw_cpuw", "mw_sp",
                           "mw_st")}
        # empty windows fall back to the run-wide mean
        have = st["mw_cnt"] > 0
        for k, v in means.items():
            overall = float(v[have].mean()) if have.any() else \
                (1.0 if k in ("mw_sp", "mw_st") else 0.0)
            means[k] = np.where(have, v, overall)
        return means

    def _latency_postpass(self):
        """Per-request latency estimates from the windowed aggregates —
        a transient vectorized pass over the trace (no per-request state
        is held by the engine)."""
        sh = self.shape
        requests = self._requests
        if not requests:
            return float("nan"), float("nan"), 0
        mw = self._window_means()
        t_arr = np.fromiter((r.arrival_s for r in requests), float,
                            count=len(requests))
        n_in = np.fromiter((r.input_tokens for r in requests), float,
                           count=len(requests))
        n_out = np.fromiter((r.output_tokens for r in requests), float,
                            count=len(requests))
        w = np.clip((t_arr / sh.mwin_s).astype(np.int64), 0,
                    sh.n_mwin - 1)
        sp = mw["mw_sp"][w]
        wait = mw["mw_wait"][w] + mw["mw_cpuw"][w]
        prefill = (TASK_DURATIONS_S["submit_task"] / sp
                   + PREFILL_BASE_S + PREFILL_PER_TOKEN_S * n_in)
        w2 = np.clip(((t_arr + wait + prefill) / sh.mwin_s)
                     .astype(np.int64), 0, sh.n_mwin - 1)
        itp = mw["mw_iter"][w2]
        lat = (_LAT_CPU_PROMPT / sp + wait + prefill
               + n_in * _KV_S_PER_TOKEN
               + _W_TOKEN_ARRIVAL / mw["mw_st"][w2]
               + 0.5 * itp + n_out * itp)
        done = t_arr + lat <= sh.duration_s
        if not done.any():
            return float("nan"), float("nan"), 0
        lat_done = lat[done]
        return (float(lat_done.mean()),
                float(np.percentile(lat_done, 99)),
                int(done.sum()))

    def _idle_percentiles(self):
        hist = self.state["idle_hist"].astype(np.float64)
        total = hist.sum()
        if total <= 0:
            zeros = {p: 0.0 for p in metrics_mod.PERCENTILES}
            return zeros, 0.0
        edges = np.linspace(-1.0, 1.0, _IDLE_BINS + 1)
        cdf = np.cumsum(hist) / total
        pcts = {}
        for p in metrics_mod.PERCENTILES:
            i = int(np.searchsorted(cdf, p / 100.0))
            i = min(i, _IDLE_BINS - 1)
            c0 = cdf[i - 1] if i > 0 else 0.0
            span = cdf[i] - c0
            frac = ((p / 100.0 - c0) / span) if span > 0 else 0.5
            pcts[p] = float(edges[i] + frac * (edges[i + 1] - edges[i]))
        below = float(hist[:int((1.0 - 0.1) * 0.5
                                * (_IDLE_BINS - 1))].sum() / total)
        return pcts, below

    def residencies(self) -> tuple[StateResidency, ...]:
        sh, st = self.shape, self.state
        out = []
        for m in range(sh.n_machines):
            out.append(StateResidency(
                num_cores=(sh.num_cores if sh.core_counts is None
                           else sh.core_counts[m]),
                duration_s=sh.duration_s,
                busy_core_s=float(st["res_busy"][m].sum()),
                idle_core_s=float(st["res_idle"][m].sum()),
                gated_core_s=float(st["res_gated"][m].sum()),
                freq_busy_core_s=float(st["res_fbusy"][m].sum()),
                window_s=sh.pwin_s,
                window_busy_s=tuple(st["res_busy"][m]),
                window_idle_s=tuple(st["res_idle"][m]),
                window_gated_s=tuple(st["res_gated"][m]),
            ))
        return tuple(out)

    def collect(self, carbon_model=None,
                power_model=None) -> ExperimentResult:
        sh, st = self.shape, self.state
        f = self.f0 * (1.0 - st["dvth"] / self.params.headroom)
        if self._pad is None:
            cvs = f.std(axis=1) / f.mean(axis=1)
            degs = (self.f0 - f).mean(axis=1)
        else:
            # masked per-machine stats: padded lanes carry no silicon
            w = ~self._pad
            n = self._n_vec
            fm = (f * w).sum(axis=1) / n
            var = (((f - fm[:, None]) ** 2) * w).sum(axis=1) / n
            cvs = np.sqrt(var) / fm
            degs = ((self.f0 - f) * w).sum(axis=1) / n
        idle_pcts, below = self._idle_percentiles()
        mean_lat, p99_lat, completed = self._latency_postpass()
        task_cnt = max(float(st["task_cnt"]), 1.0)
        result = metrics_mod.price_and_build(
            self.cfg,
            cvs=cvs, degs=degs,
            idle_norm_percentiles=idle_pcts,
            oversub_frac_below=below,
            task_count_mean=float(st["task_sum"]) / task_cnt,
            task_count_max=int(round(float(st["task_max"]))),
            mean_latency_s=mean_lat, p99_latency_s=p99_lat,
            completed=completed,
            aging_params=self.params,
            elapsed=sh.duration_s,
            residencies=self.residencies(),
            engine="fleet",
            carbon_model=carbon_model, power_model=power_model,
            fleet_inventory=self.inventory,
        )
        return result


# ---------------------------------------------------------------------- #
# runner entry point
# ---------------------------------------------------------------------- #
def run_fleet_experiment(cfg: ExperimentConfig, *, carbon_model=None,
                         power_model=None, scenario=None,
                         requests=None) -> ExperimentResult:
    """Generate the trace, run the fleet engine, collect the result.
    `requests` short-circuits trace generation when the caller already
    has it. The engine is built first, so a configuration the port
    refuses fails before the trace is generated."""
    engine = FleetEngine(cfg)
    if requests is None:
        if scenario is None:
            from repro_torch.workloads import get_scenario
            scenario = get_scenario(cfg.scenario, **cfg.scenario_options)
        requests = scenario.generate(rate_rps=cfg.rate_rps,
                                     duration_s=cfg.duration_s,
                                     seed=cfg.seed)
    engine.run(requests)
    return engine.collect(carbon_model=carbon_model,
                          power_model=power_model)


__all__: list[str] = ["FleetEngine", "run_fleet_experiment",
                      "state_from_numpy", "state_to_numpy"]
