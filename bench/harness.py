"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, and the metrics.

Everything that belongs to a configuration, a traffic mix or a metric is
found by name from the cell's entry in `BENCHMARK.json`:

- `bench/configs/<config>.json`: the model's published sizes as run, its
  `family` and the CUDA kernels its path builds (`kernels`);
- `bench/reference/<family>.py`: the family's parameters, work counts
  and plain float32 forward pass;
- `bench/traffic/<traffic>.json`: the mix, read by `bench/traffic.py`;
- `bench/metrics/<metric>.py`: one reader per metric, `read(rec)`;
- `bench/roofline/<kernel>.py`: one kernel's bytes and operations;
- `bench/limits/<cell>.json`: the limits of the comparison.

The window drives `InferenceEngine.submit` and `step` as a client would:
bfloat16, greedy, no EOS, the "proposed" core policy on the mix's host
cores. A traced run wraps the calls into the model and the core manager
with the benchmark's own spans (and CUDA events around the model calls,
each followed by a synchronize), and profiles the device over the
window's last `trace_seconds`; an untraced run does neither.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bench import weights
from bench.reference.common import GEMMS
from bench.traffic import Traffic, check as check_traffic

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ------------------------------ the cell ----------------------------- #
@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    family: object
    chips: int
    end_to_end: dict        # name -> unit
    per_layer: dict         # name -> unit
    limits: dict


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def family_module(name: str):
    return importlib.import_module(f"bench.reference.{name}")


def _by_path(kind: str, name: str):
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return _by_path("metrics", name)


def roofline(name: str):
    return _by_path("roofline", name)


def _metrics_of(entries, cell: str, reported=None) -> dict:
    """name -> unit of the metrics `entries` gives this cell: those whose
    `workloads` name it, or, without the key, every end-to-end metric
    (`reported` None) or every per-layer metric whose `moves` the cell
    reports."""
    out = {}
    for m in entries:
        if "workloads" in m:
            mine = cell in m["workloads"]
        else:
            mine = reported is None or m["moves"] in reported
        if mine:
            out[m["name"]] = m["unit"]
    return out


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_json(BENCH.parent / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(BENCH.parent / conf["file"])
    traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    check_traffic(traffic, entry["traffic"])
    e2e = _metrics_of(bench["end_to_end"], name)
    return Cell(name=name, config=config, traffic=traffic,
                family=family_module(config["family"]),
                chips=entry["chips"], end_to_end=e2e,
                per_layer=_metrics_of(bench["per_layer"], name, set(e2e)),
                limits=load_json(BENCH / "limits" / f"{name}.json"))


# --------------------------- what a run keeps ------------------------ #
@dataclasses.dataclass
class ReqLog:
    client: int
    prompt: list
    max_new: int
    sent: float
    primed: bool
    handle: object = None           # the engine's Request
    first: float | None = None
    arrivals: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class TraceLog:
    step_s: float = 0.0
    model_s: float = 0.0
    cm_in_step_s: float = 0.0
    cm_s: float = 0.0
    occupancy: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)
    calls: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)
    prefill_ms: list = dataclasses.field(default_factory=list)
    decode_ms: list = dataclasses.field(default_factory=list)
    stretch: object = None
    in_step: bool = False
    stop_s: float = 0.0             # the profiler's stop, after the window


@dataclasses.dataclass
class Record:
    """What the metric readers read."""
    cell: Cell
    peaks: dict
    setup_s: float = 0.0
    build_s: float = 0.0            # nvcc's build, on a checkout's first run
    phases: dict = dataclasses.field(default_factory=dict)
    t_start: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    extra_steps: int = 0            # after the window, for a live slot
    requests: list = dataclasses.field(default_factory=list)
    trace: TraceLog | None = None

    def window_requests(self):
        return [r for r in self.requests if not r.primed]

    def flops(self, calls) -> float:
        """Model FLOPs of `calls` (kind, info, t): a prefill of S tokens
        passes S tokens through the layers, token t at t + 1 visible
        positions, and one through the head; a decode step passes each
        active slot's token through the layers at its visible rows and
        through the head. `mixing_flops` is affine in the positions, so
        a prefill's mixing is S times that at the mean, (S + 1) / 2."""
        fam, c = self.cell.family, self.cell.config
        layers, head = fam.layer_weight_flops(c), fam.head_flops(c)
        total = 0.0
        for kind, info, _ in calls:
            if kind == "prefill":
                total += info * (layers + fam.mixing_flops(c, (info + 1) / 2))
                total += head
            else:
                total += sum(layers + head + fam.mixing_flops(c, v)
                             for v in info)
        return total

    @property
    def stretch(self):
        return self.trace.stretch if self.trace is not None else None

    def mfu(self) -> float | None:
        """Model FLOPs of the calls in the traced stretch over the
        stretch's length times the bf16 peak, in %."""
        st = self.stretch
        if st is None or not st.calls or st.window_s <= 0:
            return None
        return 100.0 * self.flops(st.calls) / (
            st.window_s * self.peaks["bf16_flop_per_s"])

    def roofline_share(self, kernel: str) -> float | None:
        """A kernel's least time over the stretch (each launch bound by
        its bytes at the HBM rate or its operations at the bf16 peak,
        whichever is longer) over its device time there, in %; None
        where it did not run."""
        st = self.stretch
        if st is None:
            return None
        mod = roofline(kernel)
        launches = [w for kind, info, _ in st.calls
                    for w in mod.work(self.cell, kind, info)]
        seconds = st.kernel_s(mod.NAMES)
        if not launches or seconds <= 0:
            return None
        least = sum(max(b / self.peaks["hbm_bytes_per_s"],
                        o / self.peaks["bf16_flop_per_s"])
                    for b, o in launches)
        return 100.0 * least / seconds

    def idle_share(self) -> float | None:
        """1 - the union of the device's operations over the stretch, in
        %."""
        st = self.stretch
        if st is None or st.busy_s <= 0:
            return None
        return 100.0 * (1.0 - st.busy_s / st.window_s)


# ------------------------------ tracing ------------------------------ #
def _instrument(engine, model, log: TraceLog, cuda: bool) -> None:
    """Wrap the engine's calls into the model and the core manager with
    spans (and CUDA events and a synchronize after each model call)."""
    def model_call(method, kind):
        fn = getattr(model, method)

        def call(*args, **kwargs):
            if kind == "prefill":
                info = int(args[0].shape[1])
            else:
                info = [len(r.prompt) + len(r.output) for r in engine.slots
                        if r is not None]
                log.occupancy.append(int(engine.active_mask.sum()))
            ev = None
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t0 = time.perf_counter_ns()
            out = fn(*args, **kwargs)
            t1 = time.perf_counter_ns()
            if cuda:
                ev[1].record()
                torch.cuda.synchronize()
            t2 = time.perf_counter_ns()
            log.spans += [(f"model_{kind}_issue", t0, t1),
                          (f"model_{kind}_wait", t1, t2)]
            log.calls.append((kind, info, t0))
            log.events.append((kind, info, ev))
            log.model_s += (t2 - t0) / 1e9
            return out
        setattr(model, method, call)

    def cm_call(name):
        fn = getattr(engine.core_manager, name)

        def call(*args, **kwargs):
            t0 = time.perf_counter_ns()
            out = fn(*args, **kwargs)
            t1 = time.perf_counter_ns()
            log.spans.append(("core_manager", t0, t1))
            log.cm_s += (t1 - t0) / 1e9
            if log.in_step:
                log.cm_in_step_s += (t1 - t0) / 1e9
            return out
        setattr(engine.core_manager, name, call)

    model_call("prefill", "prefill")
    model_call("decode_step", "decode")
    for name in ("assign", "release", "periodic"):
        cm_call(name)


# ------------------------------- the run ----------------------------- #
def _now() -> float:
    return time.perf_counter()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def build_kernels(names) -> bool:
    """Build (first run in a checkout) or load the CUDA kernels the
    cell's path launches, from the checkout's `build/kernels/`; True
    where some library had to be built."""
    if not names:
        return False
    from repro_torch.kernels._build import build_all
    kernels = [importlib.import_module(
        f"repro_torch.kernels.{n}.ops").KERNEL for n in names]
    built = any(not k.library_path().exists() for k in kernels)
    build_all(kernels)
    return built


class Loop:
    """The closed loop of a cell's clients around one engine: each client
    with no request in flight sends its next one before a step, and the
    tokens each step returned are stamped with the instant it returned."""

    def __init__(self, engine, traffic: Traffic, clients: int, rec: Record):
        self.engine, self.traffic, self.rec = engine, traffic, rec
        self.sent = [0] * clients
        self.live: list[ReqLog | None] = [None] * clients

    def send(self, client: int, primed: bool) -> None:
        r = self.traffic.request(client, self.sent[client])
        self.sent[client] += 1
        sent = _now()
        self.engine.submit(r.prompt, max_new_tokens=r.max_new_tokens)
        log = ReqLog(client, r.prompt, r.max_new_tokens, sent, primed,
                     handle=self.engine.pending[-1])
        self.rec.requests.append(log)
        self.live[client] = log

    def refill(self, primed: bool = False) -> None:
        for client, log in enumerate(self.live):
            if log is None:
                self.send(client, primed)

    def collect(self, t_ret: float) -> None:
        for client, log in enumerate(self.live):
            if log is None:
                continue
            new = len(log.handle.output) - len(log.arrivals)
            if new and log.first is None:
                log.first = t_ret
            log.arrivals += [t_ret] * new
            if log.handle.done:
                log.done = True
                self.live[client] = None


def _setup(cell: Cell, seed: int, device, rec: Record, hook):
    """The model with the seed's weights, the engine, the longest prompt's
    prefill, and every client's first request admitted. `rec.phases`
    keeps the seconds each part took, `rec.build_s` nvcc's build where
    the kernels had to be built."""
    t = _now()

    def phase(name):
        nonlocal t
        _sync(device)
        now = _now()
        rec.phases[name] = now - t
        t = now
    from repro_torch.models import Model
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.engine import InferenceEngine
    t_mix, fam, conf = cell.traffic, cell.family, cell.config
    phase("program_imports")
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
        phase("cuda_context")
        built = build_kernels(conf.get("kernels", ()))
        phase("kernels")
        if built:
            rec.build_s = rec.phases["kernels"]
    cfg = ModelConfig(**fam.port_config(conf))
    model = Model(cfg, device="meta")
    model.load_state_dict(
        weights.make(fam.param_specs(conf, cfg.padded_vocab), seed, device),
        strict=True, assign=True)
    engine = InferenceEngine(model, max_batch=t_mix["slots"],
                             max_len=t_mix["cache_len"],
                             policy=t_mix["policy"],
                             num_host_cores=t_mix["host_cores"],
                             eos_id=None, greedy=True)
    if hook is not None:
        hook(engine, model)
    phase("weights_and_engine")
    traffic = Traffic(t_mix, conf["vocab_size"], seed)
    longest = np.random.default_rng([seed % 2**63, 2**31]).integers(
        0, conf["vocab_size"], traffic.longest_prompt())
    model.prefill(torch.tensor(longest[None], device=device),
                  max_len=t_mix["cache_len"])
    phase("warm_prefill")
    loop = Loop(engine, traffic, t_mix["clients"], rec)
    loop.refill(primed=True)
    engine.step()
    loop.collect(_now())
    phase("primed_requests")
    return model, engine, loop, cfg.padded_vocab


def _window(cell: Cell, seconds: float, device, rec: Record, engine,
            loop: Loop, tlog: TraceLog | None) -> None:
    """Drive the loop until `seconds` have passed (the last step begun
    before then closes the window). A traced run profiles the device over
    the window's last `trace_seconds`; the profiler stops, and its trace
    is reduced, after the window has closed."""
    prof = None
    rec.t_start = t_start = _now()
    while True:
        t = _now()
        if t >= t_start + seconds:
            break
        if tlog is not None and prof is None and \
                t >= t_start + seconds - cell.traffic["trace_seconds"]:
            prof, pt0, sync = _start_profile(device)
        loop.refill()
        s0 = time.perf_counter_ns()
        if tlog is not None:
            tlog.in_step = True
        engine.step()
        s1 = time.perf_counter_ns()
        if tlog is not None:
            tlog.in_step = False
            tlog.spans.append(("engine_step", s0, s1))
            tlog.step_s += (s1 - s0) / 1e9
        rec.steps += 1
        loop.collect(s1 / 1e9)
    _sync(device)
    rec.window_s = _now() - t_start
    if prof is not None:
        from bench.trace import reduce
        pt1 = time.perf_counter_ns()
        prof.stop()
        tlog.stop_s = (time.perf_counter_ns() - pt1) / 1e9
        tlog.stretch = reduce(prof, pt0, pt1, sync, tlog.spans, tlog.calls)


def _device_times(tlog: TraceLog) -> None:
    """The CUDA events around the model calls, read after the window."""
    for kind, info, ev in tlog.events:
        if ev is None:
            continue
        ms = ev[0].elapsed_time(ev[1])
        if kind == "prefill":
            tlog.prefill_ms.append((info, ms))
        else:
            tlog.decode_ms.append(ms)
    tlog.events = []


def _refuse_forbidden() -> None:
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_process: float | None = None, hook=None,
             control: bool = False) -> dict:
    """Run `cell` once; returns the result (the printed line's keys and
    a `checks` dict of number and limit). `hook(engine, model)` runs
    after the engine is made (the faults); `control` adds the FP8
    control's gaps on the same requests ("control") and whether they
    pass the cell's limits ("control_correct")."""
    t_process = _now() if t_process is None else t_process
    device = torch.device(device)
    cuda = device.type == "cuda"
    rec = Record(cell=cell, peaks=load_json(BENCH / "roofline" /
                                            "peaks.json"))
    rec.phases["imports"] = _now() - t_process
    model, engine, loop, padded_vocab = _setup(cell, seed, device, rec,
                                               hook)
    rec.setup_s = _now() - t_process - rec.build_s
    if trace:
        rec.trace = TraceLog()
        _instrument(engine, model, rec.trace, cuda)
    _window(cell, seconds, device, rec, engine, loop, rec.trace)
    _refuse_forbidden()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        _device_times(rec.trace)
    samples = _sample(rec, seed, cell.traffic["check_requests"])
    samples += _live_states(rec, engine, loop, seed,
                            cell.traffic["check_live"])
    del model, engine, loop
    for r in rec.requests:
        r.handle = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = compare(cell, seed, device, samples, padded_vocab, control)

    names = cell.per_layer if trace else cell.end_to_end
    values = {name: {"value": v, "unit": unit}
              for name, unit in names.items()
              if (v := metric_reader(name).read(rec)) is not None}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    window = rec.window_requests()
    control_checks = checks.pop("control", None)
    result = {"correct": all(v["value"] <= v["limit"]
                             for v in checks.values() if "limit" in v),
              "attempted": len(window),
              "failed": sum(r.first is None for r in window),
              "metrics": values, "device": dev}
    stretch = rec.stretch
    if stretch is not None:
        dev["busy_s"] = stretch.busy_s
        dev["window_s"] = stretch.window_s
        result["breakdown"] = stretch.breakdown()
        result["trace"] = {"anchor": stretch.anchor,
                           "stop_s": rec.trace.stop_s}
    result["setup"] = {"setup_s": rec.setup_s, "build_s": rec.build_s,
                       **rec.phases, "window_s": rec.window_s,
                       "steps": rec.steps, "extra_steps": rec.extra_steps}
    if control_checks is not None:
        result["control"] = control_checks
        result["control_correct"] = all(v["value"] <= v["limit"]
                                        for v in control_checks.values())
    result["checks"] = checks
    _refuse_forbidden()
    return result


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" \
        else [ProfilerActivity.CPU]
    _sync(device)
    prof = profile(activities=acts)
    prof.start()
    a = time.perf_counter_ns()
    _sync(device)
    b = time.perf_counter_ns()
    return prof, a, (a, b)


# ---------------------------- correctness ---------------------------- #
@dataclasses.dataclass
class Sample:
    """A request to compare: its prompt and served tokens, and for one
    that held a slot when the window closed, the slot's cache as the
    program left it (`state`, without `pos`) and its `pos`."""
    prompt: list
    served: list
    state: dict | None = None
    pos: int | None = None


def _sample(rec: Record, seed: int, k: int) -> list:
    """A sample, drawn from the seed, of the requests the run finished,
    the longest among them."""
    done = [r for r in rec.requests if r.done]
    if not done:
        return []
    rng = np.random.default_rng([seed % 2**63, 7])
    longest = max(range(len(done)),
                  key=lambda i: len(done[i].prompt) + done[i].max_new)
    rest = [i for i in range(len(done)) if i != longest]
    pick = [longest] + list(rng.permutation(rest)[:max(k - 1, 0)])
    return [Sample(list(done[i].prompt), list(done[i].handle.output))
            for i in pick]


def _live_states(rec: Record, engine, loop: Loop, seed: int,
                 k: int) -> list:
    """`k` requests, drawn from the seed, that hold a slot when the
    window has closed, each with its slot's cache: every such request has
    had its prefill and at least one decode step. Where none holds one
    (all finished in the last step), the loop steps on, its requests kept
    apart from the run's, until some do."""
    if k <= 0:
        return []
    extra = 0
    while not any(r is not None for r in engine.slots):
        if extra == 32:
            return []
        kept, rec.requests = rec.requests, []
        loop.refill()
        engine.step()
        loop.collect(_now())
        rec.requests = kept
        extra += 1
    rec.extra_steps = extra
    slots = [i for i, r in enumerate(engine.slots) if r is not None]
    rng = np.random.default_rng([seed % 2**63, 11])
    out = []
    for i in sorted(rng.permutation(slots)[:k].tolist()):
        req = engine.slots[i]
        state = {key: v[:, i].clone() for key, v in engine.cache.items()
                 if key != "pos"}
        out.append(Sample(list(req.prompt), list(req.output), state,
                          int(engine.cache["pos"][i])))
    return out


def compare(cell: Cell, seed: int, device, samples, padded_vocab: int,
            control: bool) -> dict:
    """`served_gap`: the widest gap, over every served token of the
    sample (the first, which the prefill produced, and the decoded
    ones), by which its logit lies below the reference's best at its
    position. `state_gap`: the family's widest relative gap of a live
    slot's cache against the reference's after the same tokens (the
    prefill's rows or state and every decode step's), and `state_pos`:
    how far its `pos` lies from the tokens the slot has taken in (exact:
    0). Each against the cell's limit. The reference makes the weights
    from the seed itself (`padded_vocab`, the rows of the program's
    embedding tables, only places them) and runs in float32 with TF32
    off. With `control`, "control" holds the same gaps of the FP8
    forward put in the program's place: at each position of the same
    sequences the token it puts first, and its cache."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fam, conf = cell.family, cell.config
    w = weights.make(fam.param_specs(conf, padded_vocab), seed, device)
    first, decoded, ctrl, states, ctrl_states, pos_off = \
        [], [], [], [], [], []
    t = _now()
    for smp in samples:
        prompt, served = smp.prompt, smp.served
        seq = torch.tensor(prompt + served[:-1], device=device)
        live = smp.state is not None
        ref, ref_state = fam.forward(w, conf, seq, len(prompt) - 1,
                                     GEMMS["float32"], state=live)
        best = ref.max(-1).values
        idx = torch.tensor(served, device=device)[:, None]
        gap = (best - ref.gather(1, idx)[:, 0]).tolist()
        first.append(gap[0])
        decoded += gap[1:]
        if live:
            rows = len(seq)
            states.append(fam.state_gap(smp.state, ref_state, len(prompt),
                                        rows))
            pos_off.append(abs(smp.pos - rows))
            smp.state = None
        if control:
            low, low_state = fam.forward(w, conf, seq, len(prompt) - 1,
                                         GEMMS["fp8"], state=live)
            pick = low.argmax(-1)[:, None]
            ctrl += (best - ref.gather(1, pick)[:, 0]).tolist()
            if live:
                ctrl_states.append(fam.state_gap(low_state, ref_state,
                                                 len(prompt), len(seq)))
            del low, low_state
        del ref, ref_state
    del w
    lim = cell.limits
    widest = max(first + decoded) if first else math.inf
    out = {"served_gap": {"value": widest, "limit": lim["served_gap"]},
           "state_gap": {"value": max(states, default=math.inf),
                         "limit": lim["state_gap"]},
           "state_pos": {"value": max(pos_off, default=math.inf),
                         "limit": 0}}
    if control:
        out["control"] = {
            "served_gap": {"value": max(ctrl, default=math.inf),
                           "limit": lim["served_gap"]},
            "state_gap": {"value": max(ctrl_states, default=math.inf),
                          "limit": lim["state_gap"]}}
    out["compared"] = {"value": len(first) + len(decoded),
                       "requests": len(samples), "live": len(states),
                       "first_token_gap": max(first, default=math.inf),
                       "decoded_gap": max(decoded, default=0.0),
                       "seconds": _now() - t}
    return out
