"""Cluster-level request routing — the paper's *second* allocation
layer. Copied from `repro.sim.routing`: the registry's error wordings,
the seven routers and their draws from the router RNG are the
reference's.

The technique allocates at two levels: per-core task mapping inside one
server (Algorithm 1, `repro_torch.core.policies`) and "aging-aware inference
task allocation" across the fleet (paper §5). This module makes the
fleet-level decision pluggable the same way `repro_torch.core.policies` and
`repro_torch.workloads` made the per-core and workload axes pluggable: a
string-keyed registry of `ClusterRouter` strategies that decide

  * which *prompt* instance admits an arriving request, and
  * which *token* instance receives its KV-cache flow,

given a read-only `FleetView` (per-instance queue depths / decode loads
plus per-machine CPU aging snapshots: mean frequency degradation,
frequency CV, active-core count).

Built-ins:

  jsq            — join-shortest-queue / least-loaded (bit-exact with the
                   previously hard-coded `Cluster` behaviour)
  round-robin    — cyclic placement strawman
  power-of-two   — sample two instances, take the less loaded (Mitzenmacher)
  least-aged-cpu — among load-feasible instances, route toward the
                   machine with the freshest host CPU (evens fleet aging)
  carbon-greedy  — EcoServe-style: among load-feasible instances, pick the
                   placement minimizing projected fleet yearly embodied
                   carbon under a pluggable `repro_torch.carbon` model
                   (default `linear-extension`); NBTI aging is concave
                   in time, so the marginal carbon of one more task is
                   smallest on the *most* aged machine — old servers
                   soak up load while fresh ones amortize slowly.
  footprint-greedy — carbon-greedy plus the task's *operational* grams
                   under a `repro_torch.power` model and a time-varying grid
                   intensity: full-footprint marginal scoring that
                   re-weights the embodied/operational trade hour by
                   hour.
  generation-aware — GreenLLM-style placement over mixed fleets
                   (`repro_torch.hardware`): pin latency-tolerant decode on
                   the oldest-generation / most-aged feasible machines
                   and steer prompt bursts toward the newest SKUs,
                   sized by the pending request's prompt/decode token
                   counts. Degrades to load-feasible jsq tie-breaking
                   on the uniform default fleet.

Routers are per-cluster objects (they may carry cursors or RNG-driven
state) and must route through the `FleetView` only — they never see the
`Cluster` or mutate machine state.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np

from repro_torch.carbon import get_carbon_model, reference_degradation
from repro_torch.carbon.base import BASELINE_LIFESPAN_YEARS, CarbonModel
from repro_torch.carbon.intensity import ConstantIntensity, get_intensity
from repro_torch.core import aging, temperature
from repro_torch.power import get_power_model
from repro_torch.power.base import PowerModel
from repro_torch.registry import Registry, canonical_name


# --------------------------------------------------------------------- #
# read-only fleet state
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MachineAging:
    """Point-in-time aging snapshot of one machine's host CPU (the data a
    fleet scheduler would read from per-server aging sensors, paper §5)."""

    machine_id: int
    mean_degradation: float   # mean(f0 - f) over cores, settled to `now`
    freq_cv: float            # std(f)/mean(f) over cores
    active_cores: int         # cores not power-gated (C6)
    mean_dvth: float          # mean threshold-voltage shift [V]
    mean_f0: float            # mean process-variation initial frequency


class FleetView:
    """Read-only window onto a `Cluster` for routing decisions.

    Mirrors `repro_torch.core.policies.CoreView` one level up: routers get
    load and aging observability but no mutable handles. Aging
    snapshots are settled to `now` *without* mutating manager state
    (`CoreManager._settled_dvth` is pure), so a router that never reads
    them — e.g. `jsq` — leaves the simulation bit-exact.
    """

    __slots__ = ("_c",)

    def __init__(self, cluster):
        self._c = cluster

    # -- shape / clock ------------------------------------------------- #
    @property
    def now(self) -> float:
        return self._c.queue.now

    @property
    def n_prompt(self) -> int:
        return len(self._c.prompt_instances)

    @property
    def n_token(self) -> int:
        return len(self._c.token_instances)

    @property
    def rng(self) -> np.random.Generator:
        """Cluster-owned router RNG (seeded from the experiment seed)."""
        return self._c.router_rng

    @property
    def aging_params(self) -> aging.AgingParams:
        return self._c.machines[0].manager.params

    @property
    def num_cores(self) -> int:
        """Host-CPU core count per machine (homogeneous fleet)."""
        return self._c.machines[0].manager.num_cores

    # -- hardware (heterogeneous-fleet layer) -------------------------- #
    # Per-machine SKU columns in fleet order (prompt machines first,
    # then token machines — the order `Cluster` builds them). On the
    # uniform default fleet (`cluster.inventory is None`) these return
    # constants, so reading them never breaks bit-exactness.
    def generations(self) -> np.ndarray:
        """(n_machines,) int — hardware generation per machine (0 on
        the uniform default fleet)."""
        inv = self._c.inventory
        if inv is None:
            return np.zeros(len(self._c.machines), dtype=np.int64)
        return np.asarray(inv.generations, dtype=np.int64)

    def core_counts(self) -> np.ndarray:
        """(n_machines,) int — host-CPU core count per machine."""
        inv = self._c.inventory
        if inv is None:
            return np.full(len(self._c.machines),
                           self._c.machines[0].manager.num_cores,
                           dtype=np.int64)
        return np.asarray(inv.num_cores, dtype=np.int64)

    def sku_names(self) -> tuple:
        """Per-machine SKU registry names, fleet order (`None` per
        machine on the uniform default fleet)."""
        inv = self._c.inventory
        if inv is None:
            return (None,) * len(self._c.machines)
        return inv.sku_names

    def prompt_generations(self) -> np.ndarray:
        """(n_prompt,) int — generation of each prompt instance's host."""
        return self.generations()[: self.n_prompt]

    def token_generations(self) -> np.ndarray:
        """(n_token,) int — generation of each token instance's host."""
        g = self.generations()
        return g[self.n_prompt: self.n_prompt + self.n_token]

    # -- pending request (size-aware routing hook) --------------------- #
    # The cluster stamps the request being placed just before each
    # routing call, so routers can weigh request *size* (e.g. steer
    # prompt bursts to fast new SKUs). 0.0 outside a routing call.
    @property
    def pending_prompt_tokens(self) -> float:
        """Prompt length [tokens] of the request being routed."""
        req = self._c.pending_request
        return 0.0 if req is None else float(req.input_tokens)

    @property
    def pending_decode_tokens(self) -> float:
        """Decode length [tokens] of the request being routed."""
        req = self._c.pending_request
        return 0.0 if req is None else float(req.output_tokens)

    # -- load ---------------------------------------------------------- #
    def prompt_depths(self) -> np.ndarray:
        """(n_prompt,) int — queued + in-flight prefills per instance."""
        return np.asarray([len(p.queue) + p.busy
                           for p in self._c.prompt_instances])

    def token_loads(self) -> np.ndarray:
        """(n_token,) int — active + pending decode requests per instance."""
        return np.asarray([t.load for t in self._c.token_instances])

    # -- health (fault layer) ------------------------------------------ #
    # All-True / all-zero with the default "none" fault model; a
    # health-aware router can weight these without breaking bit-exactness
    # of faultless runs (it just reads constants).
    def prompt_up(self) -> np.ndarray:
        """(n_prompt,) bool — prompt machine is powered (not rebooting)."""
        return np.asarray([getattr(p.machine, "up", True)
                           for p in self._c.prompt_instances])

    def token_up(self) -> np.ndarray:
        """(n_token,) bool — token machine is powered (not rebooting)."""
        return np.asarray([getattr(t.machine, "up", True)
                           for t in self._c.token_instances])

    def machine_up(self) -> np.ndarray:
        """(n_machines,) bool — per-machine power state, fleet order."""
        return np.asarray([getattr(m, "up", True)
                           for m in self._c.machines])

    def offline_cores(self) -> np.ndarray:
        """(n_machines,) int — permanently failed cores per machine."""
        return np.asarray([int(m.manager.failed.sum())
                           for m in self._c.machines])

    # -- aging --------------------------------------------------------- #
    def _snapshot(self, machine) -> MachineAging:
        m = machine.manager
        dvth = m._settled_dvth(self.now)
        f = aging.frequency(m.params, m.f0, dvth)
        return MachineAging(
            machine_id=machine.machine_id,
            mean_degradation=float(np.mean(m.f0 - f)),
            freq_cv=float(np.std(f) / np.mean(f)),
            active_cores=int((m.c_state == temperature.CState.ACTIVE).sum()),
            mean_dvth=float(np.mean(dvth)),
            mean_f0=float(np.mean(m.f0)),
        )

    def prompt_aging(self, indices=None) -> tuple[MachineAging, ...]:
        """Snapshots of the prompt machines' CPUs; pass `indices` to
        snapshot only candidate instances (each snapshot settles every
        core of its machine — skipping non-candidates matters on the
        per-request hot path)."""
        inst = self._c.prompt_instances
        if indices is None:
            indices = range(len(inst))
        return tuple(self._snapshot(inst[i].machine) for i in indices)

    def token_aging(self, indices=None) -> tuple[MachineAging, ...]:
        """Snapshots of the token machines' CPUs (see `prompt_aging`)."""
        inst = self._c.token_instances
        if indices is None:
            indices = range(len(inst))
        return tuple(self._snapshot(inst[i].machine) for i in indices)


# --------------------------------------------------------------------- #
# protocol + registry
# --------------------------------------------------------------------- #
class ClusterRouter:
    """Base class for cluster-level request-routing strategies.

    Subclasses register under a string key with `@register_router(name)`
    and are instantiated per-cluster via `get_router(name, **opts)`.
    Both hooks return an *index* (into the prompt / token instance
    lists), not a machine id.
    """

    #: canonical registry key, set by @register_router
    name: ClassVar[str] = "?"

    def select_prompt(self, fleet: FleetView) -> int:
        """Pick the prompt instance that admits the next request."""
        raise NotImplementedError

    def select_token(self, fleet: FleetView) -> int:
        """Pick the token instance that receives a finished prefill's
        KV-cache flow."""
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"


# Shared registry mechanics (`repro_torch.registry.Registry`) — one
# implementation for the policy / scenario / router axes.
_ROUTERS = Registry(
    noun="router", kind="cluster router", decorator="register_router",
    expects="ClusterRouter subclass",
    check=lambda cls: isinstance(cls, type) and issubclass(cls,
                                                           ClusterRouter),
)
#: historical module-level alias (tests clean up through it)
_REGISTRY = _ROUTERS.store


def canonical_router_name(name: str) -> str:
    """Normalize a user-supplied router key ("Power_Of_Two" style)."""
    return canonical_name(name)


def register_router(name: str):
    """Class decorator: register a `ClusterRouter` subclass under `name`."""
    return _ROUTERS.register(name)


def get_router(name: str, **opts) -> ClusterRouter:
    """Instantiate the router registered under `name` with `opts`."""
    return _ROUTERS.get(name, **opts)


def available_routers() -> tuple[str, ...]:
    """Sorted canonical names of every registered router."""
    return _ROUTERS.available()


# --------------------------------------------------------------------- #
# built-ins
# --------------------------------------------------------------------- #
@register_router("jsq")
class JSQRouter(ClusterRouter):
    """Join-shortest-queue prompts + least-loaded tokens.

    Bit-exact with the behaviour `Cluster` hard-coded before routing
    became pluggable (golden-pinned in tests): first minimum wins ties,
    and no aging state or RNG is read.
    """

    def select_prompt(self, fleet: FleetView) -> int:
        return int(np.argmin(fleet.prompt_depths()))

    def select_token(self, fleet: FleetView) -> int:
        return int(np.argmin(fleet.token_loads()))


@register_router("round-robin")
class RoundRobinRouter(ClusterRouter):
    """Cyclic placement, load- and aging-oblivious."""

    def __init__(self):
        self._p = 0
        self._t = 0

    def select_prompt(self, fleet: FleetView) -> int:
        i = self._p % fleet.n_prompt
        self._p += 1
        return i

    def select_token(self, fleet: FleetView) -> int:
        i = self._t % fleet.n_token
        self._t += 1
        return i


@register_router("power-of-two")
class PowerOfTwoRouter(ClusterRouter):
    """Sample two instances uniformly, route to the less loaded one
    (the power-of-two-choices load balancer). Uses the cluster's
    seeded router RNG, so runs stay reproducible."""

    @staticmethod
    def _pick(rng: np.random.Generator, loads: np.ndarray) -> int:
        n = len(loads)
        if n == 1:
            return 0
        i, j = rng.choice(n, size=2, replace=False)
        return int(i if loads[i] <= loads[j] else j)

    def select_prompt(self, fleet: FleetView) -> int:
        return self._pick(fleet.rng, fleet.prompt_depths())

    def select_token(self, fleet: FleetView) -> int:
        return self._pick(fleet.rng, fleet.token_loads())


def _feasible(loads: np.ndarray, slack: int) -> np.ndarray:
    """Indices whose load is within `slack` of the minimum — the
    candidates an aging/carbon-aware router may choose among without
    sacrificing service quality."""
    return np.flatnonzero(loads <= loads.min() + slack)


@register_router("least-aged-cpu")
class LeastAgedCPURouter(ClusterRouter):
    """Route toward the machines with the freshest host CPUs.

    Among instances whose load is within `slack` of the fleet minimum,
    pick the one whose host CPU shows the smallest settled mean
    frequency degradation. The default `slack=0` strictly refines jsq:
    load placement quality is untouched and only ties — which jsq breaks
    by a fixed index bias — are broken toward the freshest machine,
    evening out cross-machine aging (lower fleet degradation CV).
    Raising `slack` trades queue evenness for stronger wear-leveling;
    NBTI's concave time dependence makes large slacks overshoot.
    """

    def __init__(self, slack: int = 0):
        if slack < 0:
            raise ValueError(f"slack must be >= 0, got {slack}")
        self.slack = slack

    def _select(self, loads, snapshot) -> int:
        cand = _feasible(loads, self.slack)
        if len(cand) == 1:
            return int(cand[0])
        deg = [s.mean_degradation for s in snapshot(cand)]
        return int(cand[int(np.argmin(deg))])

    def select_prompt(self, fleet: FleetView) -> int:
        return self._select(fleet.prompt_depths(), fleet.prompt_aging)

    def select_token(self, fleet: FleetView) -> int:
        return self._select(fleet.token_loads(), fleet.token_aging)


@register_router("carbon-greedy")
class CarbonGreedyRouter(ClusterRouter):
    """Minimize projected fleet yearly embodied carbon (EcoServe-style).

    For each load-feasible candidate, project the machine's mean
    degradation after absorbing one more task interval (`tau_s` of
    active-allocated NBTI stress on its mean dVth) and price the whole
    fleet with a pluggable `repro_torch.carbon` model against a worst-case
    linear-aging reference at the same horizon. NBTI is concave in
    accumulated stress time, so the marginal carbon of a task is
    smallest on the most-aged machine: carbon-greedy concentrates load
    on old CPUs and shelters fresh ones — the opposite of
    `least-aged-cpu`, and the trade EcoServe exploits.

    `carbon_model` is a registry name (or `CarbonModel` instance) with
    `carbon_opts` for its constructor; the default `linear-extension`
    is bit-exact with the pre-subsystem hard-coded scoring, and
    `reliability-threshold` sharpens the concavity (steeper marginal
    differences between fresh and aged machines).
    """

    def __init__(self, slack: int = 2, tau_s: float = 0.01,
                 carbon_model="linear-extension", carbon_opts=None):
        if slack < 0:
            raise ValueError(f"slack must be >= 0, got {slack}")
        if tau_s <= 0.0:
            raise ValueError(f"tau_s must be > 0, got {tau_s}")
        self.slack = slack
        self.tau_s = tau_s
        if isinstance(carbon_model, CarbonModel):
            if carbon_opts:
                raise TypeError("carbon_opts only apply when carbon_model "
                                "is a registry name, got an instance")
            self.carbon_model = carbon_model
        else:
            self.carbon_model = get_carbon_model(carbon_model,
                                                 **dict(carbon_opts or {}))

    def _select(self, fleet: FleetView, loads, snapshot) -> int:
        cand = _feasible(loads, self.slack)
        if len(cand) == 1:
            return int(cand[0])
        params = fleet.aging_params
        deg_ref = reference_degradation(params, fleet.now)
        adf_active = params.K * aging.adf_unscaled_cached(
            params, temperature.TEMP_ACTIVE_ALLOCATED_C,
            temperature.STRESS_ACTIVE)
        lifetime = self.carbon_model.lifetime
        # Fleet totals across candidates share every j != i term, so the
        # argmin over projected fleet carbon reduces to the candidate's
        # own marginal increase.
        best, best_delta = int(cand[0]), np.inf
        for i, s in zip(cand, snapshot(cand)):
            dvth_next = aging.advance_dvth_scalar(
                params, s.mean_dvth, adf_active, self.tau_s)
            deg_next = s.mean_degradation \
                + s.mean_f0 * (dvth_next - s.mean_dvth) / params.headroom
            delta = (lifetime(deg_ref, max(deg_next, 0.0)).yearly_kgco2eq
                     - lifetime(deg_ref, max(s.mean_degradation, 0.0))
                     .yearly_kgco2eq)
            if delta < best_delta:
                best, best_delta = int(i), delta
        return best

    def select_prompt(self, fleet: FleetView) -> int:
        return self._select(fleet, fleet.prompt_depths(),
                            fleet.prompt_aging)

    def select_token(self, fleet: FleetView) -> int:
        return self._select(fleet, fleet.token_loads(), fleet.token_aging)


@register_router("footprint-greedy")
class FootprintGreedyRouter(CarbonGreedyRouter):
    """Minimize the task's full footprint: embodied AND operational.

    Extends `carbon-greedy`'s marginal scoring with the task's
    operational grams under a `repro_torch.power` model and a time-varying
    grid intensity:

      embodied_g    = delta yearly embodied [kg/yr] * 1000
                        * embodied_horizon_years
      operational_g = marginal_task_w(f_i) * (tau_s / f_i) / 3.6e6
                        * intensity(now)

    where `f_i` is the candidate machine's settled mean frequency. The
    two terms genuinely pull apart: NBTI concavity makes embodied
    cheapest on the *most*-aged machine, while an `ondemand`-governor
    power model makes a task's energy `tau * (min_w / f + (max_w -
    min_w))` — *highest* there (slower core, longer on-time). The
    intensity term re-weights that trade hour by hour, so placement
    leans operational during dirty-grid hours and embodied during clean
    ones. Under `flat-tdp` the marginal watts are zero and the router
    degenerates to `carbon-greedy`.

    `intensity=None` (default) borrows the carbon model's own
    `.intensity` when it has one (e.g. `operational-embodied`), so one
    diurnal spec can drive pricing, policy, and routing coherently.
    """

    def __init__(self, slack: int = 2, tau_s: float = 0.01,
                 carbon_model="linear-extension", carbon_opts=None,
                 power_model="minmax-linear", power_opts=None,
                 intensity=None, intensity_opts=None,
                 embodied_horizon_years: float = BASELINE_LIFESPAN_YEARS):
        super().__init__(slack=slack, tau_s=tau_s,
                         carbon_model=carbon_model,
                         carbon_opts=carbon_opts)
        if embodied_horizon_years <= 0.0:
            raise ValueError(f"embodied_horizon_years must be > 0, got "
                             f"{embodied_horizon_years}")
        if isinstance(power_model, PowerModel):
            if power_opts:
                raise TypeError("power_opts only apply when power_model "
                                "is a registry name, got an instance")
            self.power_model = power_model
        else:
            self.power_model = get_power_model(power_model,
                                               **dict(power_opts or {}))
        if intensity is not None:
            self.intensity = get_intensity(intensity,
                                           **dict(intensity_opts or {}))
        else:
            self.intensity = getattr(self.carbon_model, "intensity", None)
            if self.intensity is None:
                self.intensity = ConstantIntensity()
        self.embodied_horizon_years = embodied_horizon_years

    def _select(self, fleet: FleetView, loads, snapshot) -> int:
        cand = _feasible(loads, self.slack)
        if len(cand) == 1:
            return int(cand[0])
        params = fleet.aging_params
        deg_ref = reference_degradation(params, fleet.now)
        adf_active = params.K * aging.adf_unscaled_cached(
            params, temperature.TEMP_ACTIVE_ALLOCATED_C,
            temperature.STRESS_ACTIVE)
        lifetime = self.carbon_model.lifetime
        i_now = self.intensity.g_per_kwh(fleet.now)
        n_cores = fleet.num_cores
        best, best_score = int(cand[0]), np.inf
        for i, s in zip(cand, snapshot(cand)):
            dvth_next = aging.advance_dvth_scalar(
                params, s.mean_dvth, adf_active, self.tau_s)
            deg_next = s.mean_degradation \
                + s.mean_f0 * (dvth_next - s.mean_dvth) / params.headroom
            emb_g = (lifetime(deg_ref, max(deg_next, 0.0)).yearly_kgco2eq
                     - lifetime(deg_ref, max(s.mean_degradation, 0.0))
                     .yearly_kgco2eq) \
                * 1000.0 * self.embodied_horizon_years
            f = max(s.mean_f0 - s.mean_degradation, 1e-6)
            op_g = (self.power_model.marginal_task_w(f, n_cores)
                    * (self.tau_s / f) / 3.6e6 * i_now)
            score = emb_g + op_g
            if score < best_score:
                best, best_score = int(i), score
        return best


@register_router("generation-aware")
class GenerationAwareRouter(ClusterRouter):
    """Generation-aware placement over mixed hardware fleets
    (GreenLLM-style hardware/workload matching, `repro_torch.hardware`).

    Decode is latency-tolerant — per-token service dominates and a few
    percent of frequency loss is absorbed by batching — so
    `select_token` pins it on the *oldest-generation* load-feasible
    machine (ties broken toward the most-aged CPU via per-machine
    settled snapshots): old silicon soaks up the steady decode stream
    and its embodied carbon keeps amortizing, while new SKUs stay fresh
    and fast. Prefill is the latency-critical burst, so
    `select_prompt` steers it to the *newest-generation* feasible
    machine (ties broken jsq-style toward the least-loaded, then the
    lowest index).

    Size-awareness (the `FleetView.pending_*_tokens` hook): a request
    whose prompt is at least `long_prompt_tokens` — or whose decode is
    at least `long_decode_tokens` — widens the respective feasibility
    slack by `burst_extra_slack`, letting big compute-heavy prompts
    reach a new SKU (and long throughput-bound decodes reach an old
    one) even when it is not currently the least loaded.

    Reads per-machine aging through snapshots only (never
    `fleet.aging_params`), so mixed-SKU fleets with per-machine NBTI
    operating points route correctly. On the uniform default fleet all
    generations are 0 and the router degrades to load-feasible jsq
    tie-breaking.
    """

    def __init__(self, prompt_slack: int = 0, token_slack: int = 2,
                 long_prompt_tokens: float = 256.0,
                 long_decode_tokens: float = 64.0,
                 burst_extra_slack: int = 2):
        for label, v in (("prompt_slack", prompt_slack),
                         ("token_slack", token_slack),
                         ("burst_extra_slack", burst_extra_slack)):
            if v < 0:
                raise ValueError(f"{label} must be >= 0, got {v}")
        if long_prompt_tokens <= 0.0:
            raise ValueError(f"long_prompt_tokens must be > 0, got "
                             f"{long_prompt_tokens}")
        if long_decode_tokens <= 0.0:
            raise ValueError(f"long_decode_tokens must be > 0, got "
                             f"{long_decode_tokens}")
        self.prompt_slack = prompt_slack
        self.token_slack = token_slack
        self.long_prompt_tokens = long_prompt_tokens
        self.long_decode_tokens = long_decode_tokens
        self.burst_extra_slack = burst_extra_slack

    def select_prompt(self, fleet: FleetView) -> int:
        loads = fleet.prompt_depths()
        slack = self.prompt_slack
        if fleet.pending_prompt_tokens >= self.long_prompt_tokens:
            slack += self.burst_extra_slack
        cand = _feasible(loads, slack)
        if len(cand) == 1:
            return int(cand[0])
        gens = fleet.prompt_generations()[cand]
        new = cand[gens == gens.max()]
        if len(new) == 1:
            return int(new[0])
        return int(new[int(np.argmin(loads[new]))])

    def select_token(self, fleet: FleetView) -> int:
        loads = fleet.token_loads()
        slack = self.token_slack
        if fleet.pending_decode_tokens >= self.long_decode_tokens:
            slack += self.burst_extra_slack
        cand = _feasible(loads, slack)
        if len(cand) == 1:
            return int(cand[0])
        gens = fleet.token_generations()[cand]
        old = cand[gens == gens.min()]
        if len(old) == 1:
            return int(old[0])
        deg = [s.mean_degradation for s in fleet.token_aging(old)]
        return int(old[int(np.argmax(deg))])
