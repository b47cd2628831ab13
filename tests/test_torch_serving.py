"""Serving engine of the port (`repro_torch.serving.engine`) against the
reference, on the CPU, on the float32 smoke configs of llama3-8b,
mamba2-2.7b, granite-moe-3b-a800m (mixture of experts), minicpm3-4b
(MLA: a latent cache per slot) and internvl2-2b (the vision frontend,
served text only, as the reference's engine serves it) with the
reference's parameters
(`params_from_jax`) and a fake clock.

- The port engine's greedy tokens equal the reference model's sequential
  prefill and decode (in this process: `repro.models` imports on Python
  3.12) and the reference `InferenceEngine`'s tokens, which runs in a
  child interpreter (`torch_harness`: `repro.serving` imports
  `repro.core`, which does not import here).
- `host_cpu_report` equals the reference engine's exactly: both route
  the same Table-2 tasks at the same fake times through equal core
  managers.
- `TestTrace` (Llama and Mamba2): the engine's own spans and counters
  (`engine.trace`) leave the tokens as they were, nest as documented,
  carry each request's id and counts, and equal what was served; with
  `trace` off nothing is recorded and no clock read.
At float32 the two models' logits differ by about 1e-6, so greedy
tokens agree unless two logits tie that closely.

The reference engine cannot serve Mamba2 as it stands (ROADMAP R6): it
sizes the conv history of its empty cache from a one-token prefill, so
splicing a longer prompt's history raises. The child runs it with that
one line set right (`_SsmEngine`), and the prompts here are longer than
the conv window, which the reference's model needs.
"""
from __future__ import annotations

import dataclasses
import json
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_harness import run_reference

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve
from repro_torch.models import Model, params_from_jax
from repro_torch.serving.engine import InferenceEngine
from repro_torch.telemetry import TelemetryHub

SEED = 0
# (max_batch, max_len, policy, host cores, prompts, new tokens each)
_rng = np.random.default_rng(1)
CASES = {
    # tests/test_substrate.py::TestEngine::test_engine_matches_sequential_decode
    "sequential": (4, 32, "linux", 4,
                   [_rng.integers(0, 999, 8).tolist() for _ in range(3)],
                   [4, 4, 4]),
    # more requests than slots, of several lengths: slots are reused and
    # inactive slots keep writing at their frozen positions
    "refill": (2, 48, "proposed", 8,
               [_rng.integers(0, 999, n).tolist() for n in (5, 12, 7, 9, 6)],
               [3, 6, 4, 5, 3]),
}

ARCHS = ("llama3-8b", "mamba2-2.7b", "granite-moe-3b-a800m", "minicpm3-4b",
         "internvl2-2b")
MOE_MLA = ("granite-moe-3b-a800m", "minicpm3-4b")

_CHILD = r'''
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models import Model
from repro.serving.engine import InferenceEngine


class _SsmEngine(InferenceEngine):
    """R6: W-1 rows of conv history per slot, not the one row of a
    one-token prefill."""

    def _empty_cache(self):
        cache = super()._empty_cache()
        conv = cache["conv"]
        w = self.model.cfg.ssm_conv_width
        cache["conv"] = jnp.zeros(conv.shape[:2] + (w - 1,) + conv.shape[3:],
                                  conv.dtype)
        return cache


out = {}
for arch in job["archs"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = Model(cfg)
    params = model.init(jax.random.key(job["seed"]))
    engine = _SsmEngine if cfg.family == "ssm" else InferenceEngine
    out[arch] = {}
    for name, (batch, max_len, policy, cores, prompts, news) in \
            job["cases"].items():
        fake = [0.0]
        eng = engine(model, params, max_batch=batch, max_len=max_len,
                     policy=policy, num_host_cores=cores,
                     clock=lambda: fake[0])
        reqs = []
        for p, n in zip(prompts, news):
            eng.submit(p, n)
            reqs.append(eng.pending[-1])
        for _ in range(200):
            if not eng.pending and not eng.active_mask.any():
                break
            eng.step()
            fake[0] += 0.1
        out[arch][name] = {"outputs": [r.output for r in reqs],
                           "report": eng.host_cpu_report()}
json.dump(out, sys.stdout)
'''


def _cfg(dtype="float32", arch="llama3-8b"):
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype)


def _ref_pair(arch):
    cfg = dataclasses.replace(ref_smoke_config(arch), dtype="float32")
    return RefModel(cfg), RefModel(cfg).init(jax.random.key(SEED))


def _port(arch, params):
    cfg = _cfg(arch=arch)
    m = Model(cfg, device="cpu")
    m.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, params)))
    return m


@pytest.fixture(scope="module")
def ref_params():
    return _ref_pair("llama3-8b")


@pytest.fixture(scope="module")
def model(ref_params):
    return _port("llama3-8b", ref_params[1])


@pytest.fixture(scope="module")
def ssm_ref_params():
    return _ref_pair("mamba2-2.7b")


@pytest.fixture(scope="module")
def ssm_model(ssm_ref_params):
    return _port("mamba2-2.7b", ssm_ref_params[1])


@pytest.fixture(scope="module")
def reference():
    return run_reference(_CHILD, {"seed": SEED, "cases": CASES,
                                  "archs": ARCHS}, timeout=300)


def _serve(model, batch, max_len, policy, cores, prompts, news):
    fake = [0.0]
    eng = InferenceEngine(model, max_batch=batch, max_len=max_len,
                          policy=policy, num_host_cores=cores,
                          clock=lambda: fake[0])
    reqs = []
    for p, n in zip(prompts, news):
        eng.submit(p, n)
        reqs.append(eng.pending[-1])
    for _ in range(200):
        if not eng.pending and not eng.active_mask.any():
            break
        eng.step()
        fake[0] += 0.1
    return eng, [r.output for r in reqs]


def _sequential(model, ref_params):
    """The port engine's tokens on the "sequential" case, and the
    reference model's own prefill and greedy decode of each prompt."""
    ref_model, params = ref_params
    vocab = model.cfg.vocab_size
    _, outputs = _serve(model, *CASES["sequential"])
    wants = []
    for prompt in CASES["sequential"][4]:
        logits, cache = ref_model.prefill(
            params, jnp.asarray(prompt, jnp.int32)[None, :], None,
            max_len=32)
        want = [int(jnp.argmax(logits[0, -1, :vocab]))]
        for _ in range(3):
            logits, cache = ref_model.decode_step(
                params, cache, jnp.asarray([[want[-1]]], jnp.int32))
            want.append(int(jnp.argmax(logits[0, 0, :vocab])))
        wants.append(want)
    return outputs, wants


def test_tokens_equal_reference_sequential_decode(model, ref_params):
    outputs, wants = _sequential(model, ref_params)
    assert outputs == wants


@pytest.mark.parametrize("case", sorted(CASES))
def test_tokens_equal_reference_engine(model, reference, case):
    _, outputs = _serve(model, *CASES[case])
    assert outputs == reference["llama3-8b"][case]["outputs"]
    assert [len(o) for o in outputs] == CASES[case][5]


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_cpu_report_equals_reference(model, reference, case):
    eng, _ = _serve(model, *CASES[case])
    report = json.loads(json.dumps(eng.host_cpu_report()))
    assert report == reference["llama3-8b"][case]["report"]


class TestMamba2:
    """The same engine serving the float32 Mamba2 smoke model."""

    def test_tokens_equal_reference_sequential_decode(self, ssm_model,
                                                      ssm_ref_params):
        outputs, wants = _sequential(ssm_model, ssm_ref_params)
        assert outputs == wants

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_tokens_equal_reference_engine(self, ssm_model, reference,
                                           case):
        _, outputs = _serve(ssm_model, *CASES[case])
        assert outputs == reference["mamba2-2.7b"][case]["outputs"]
        assert [len(o) for o in outputs] == CASES[case][5]

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_host_cpu_report_equals_reference(self, ssm_model, reference,
                                              case):
        eng, _ = _serve(ssm_model, *CASES[case])
        report = json.loads(json.dumps(eng.host_cpu_report()))
        assert report == reference["mamba2-2.7b"][case]["report"]

    def test_cache_shapes_and_no_kernel_on_cpu(self, ssm_model):
        cfg = ssm_model.cfg
        eng = InferenceEngine(ssm_model, max_batch=3, max_len=20)
        assert set(eng.cache) == {"conv", "state", "pos"}
        assert eng.cache["conv"].shape == (cfg.num_layers, 3,
                                           cfg.ssm_conv_width - 1,
                                           cfg.d_inner + 2 * cfg.ssm_state)
        assert eng.cache["state"].shape == (cfg.num_layers, 3,
                                            cfg.ssm_heads, cfg.ssm_head_dim,
                                            cfg.ssm_state)
        assert eng.cache["state"].dtype == torch.float32
        before = ssd_ops.KERNEL.launches
        _serve(ssm_model, *CASES["refill"])
        assert ssd_ops.KERNEL.launches == before

    def test_short_prompts_are_served(self, ssm_model):
        """Prompts of 1 and 2 tokens (ROADMAP R6): each slot's tokens
        equal the model's own prefill and greedy decode of its prompt."""
        vocab = ssm_model.cfg.vocab_size
        prompts = [[7], [3, 9], [5, 1, 4, 2]]
        _, outputs = _serve(ssm_model, 2, 16, "proposed", 4, prompts,
                            [4, 4, 4])
        for prompt, got in zip(prompts, outputs):
            logits, cache = ssm_model.prefill(torch.tensor([prompt]))
            want = [int(logits[0, -1, :vocab].argmax())]
            for _ in range(3):
                logits, cache = ssm_model.decode_step(
                    cache, torch.tensor([[want[-1]]]))
                want.append(int(logits[0, 0, :vocab].argmax()))
            assert got == want

    def test_serve_cli_on_cpu(self, capsys):
        serve.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
                    "--requests", "3", "--new-tokens", "3"])
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[0].startswith("served 3 requests / 9 tokens")
        assert lines[1].startswith("host CPU [proposed]: cores_active=")


@pytest.fixture(scope="module")
def moe_mla_models():
    """{arch: (port model, (reference model, params))} for MOE_MLA."""
    out = {}
    for arch in MOE_MLA:
        ref = _ref_pair(arch)
        out[arch] = (_port(arch, ref[1]), ref)
    return out


class TestMoeAndMla:
    """The same engine serving granite-moe-3b-a800m and minicpm3-4b."""

    @pytest.mark.parametrize("arch", MOE_MLA)
    def test_tokens_equal_reference_sequential_decode(self, moe_mla_models,
                                                      arch):
        model, ref = moe_mla_models[arch]
        outputs, wants = _sequential(model, ref)
        assert outputs == wants

    @pytest.mark.parametrize("case", sorted(CASES))
    @pytest.mark.parametrize("arch", MOE_MLA)
    def test_tokens_equal_reference_engine(self, moe_mla_models, reference,
                                           arch, case):
        _, outputs = _serve(moe_mla_models[arch][0], *CASES[case])
        assert outputs == reference[arch][case]["outputs"]
        assert [len(o) for o in outputs] == CASES[case][5]

    @pytest.mark.parametrize("case", sorted(CASES))
    @pytest.mark.parametrize("arch", MOE_MLA)
    def test_host_cpu_report_equals_reference(self, moe_mla_models,
                                              reference, arch, case):
        eng, _ = _serve(moe_mla_models[arch][0], *CASES[case])
        report = json.loads(json.dumps(eng.host_cpu_report()))
        assert report == reference[arch][case]["report"]

    def test_mla_cache_is_the_latent(self, moe_mla_models):
        model = moe_mla_models["minicpm3-4b"][0]
        cfg = model.cfg
        eng = InferenceEngine(model, max_batch=3, max_len=20)
        assert set(eng.cache) == {"latent", "pos"}
        assert eng.cache["latent"].shape == (
            cfg.num_layers, 3, 20, cfg.kv_lora_rank + cfg.qk_rope_dim)
        assert eng.cache["latent"].dtype == model.dtype

    def test_moe_cache_is_k_and_v(self, moe_mla_models):
        model = moe_mla_models["granite-moe-3b-a800m"][0]
        eng = InferenceEngine(model, max_batch=3, max_len=20)
        assert set(eng.cache) == {"k", "v", "pos"}
        assert eng.cache["k"].shape == (2, 3, 20, 2, 32)

    @pytest.mark.parametrize("arch", MOE_MLA)
    def test_serve_cli_on_cpu(self, capsys, arch):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--requests", "3", "--new-tokens", "3"])
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[0].startswith("served 3 requests / 9 tokens")
        assert lines[1].startswith("host CPU [proposed]: cores_active=")


@pytest.fixture(scope="module")
def vlm_models():
    """(port model, (reference model, params)) of internvl2-2b."""
    ref = _ref_pair("internvl2-2b")
    return _port("internvl2-2b", ref[1]), ref


class TestVisionFrontend:
    """The same engine serving internvl2-2b: text only, no patch
    embeddings, as the reference's engine prefills it."""

    def test_tokens_equal_reference_sequential_decode(self, vlm_models):
        outputs, wants = _sequential(*vlm_models)
        assert outputs == wants

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_tokens_equal_reference_engine(self, vlm_models, reference,
                                           case):
        _, outputs = _serve(vlm_models[0], *CASES[case])
        assert outputs == reference["internvl2-2b"][case]["outputs"]

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_host_cpu_report_equals_reference(self, vlm_models, reference,
                                              case):
        eng, _ = _serve(vlm_models[0], *CASES[case])
        report = json.loads(json.dumps(eng.host_cpu_report()))
        assert report == reference["internvl2-2b"][case]["report"]

    def test_serve_cli_on_cpu(self, capsys):
        serve.main(["--arch", "internvl2-2b", "--smoke", "--device", "cpu",
                    "--requests", "3", "--new-tokens", "3"])
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[0].startswith("served 3 requests / 9 tokens")
        assert lines[1].startswith("host CPU [proposed]: cores_active=")


def test_cpu_tensors_launch_no_kernel(model):
    before = (fa_ops.KERNEL.launches, dec_ops.KERNEL.launches)
    _serve(model, *CASES["refill"])
    assert (fa_ops.KERNEL.launches, dec_ops.KERNEL.launches) == before


def test_serves_batched_requests():
    """`tests/test_substrate.py::TestEngine::test_serves_batched_requests`
    on the port (its own random bfloat16 weights)."""
    model = Model(get_smoke_config("llama3-8b"), device="cpu", seed=0)
    fake = [0.0]
    eng = InferenceEngine(model, max_batch=4, max_len=48,
                          policy="proposed", num_host_cores=8,
                          clock=lambda: fake[0])
    rng = np.random.default_rng(0)
    for _ in range(6):
        eng.submit(rng.integers(0, 999, 8).tolist(), 5)
    for _ in range(100):
        if not eng.pending and not eng.active_mask.any():
            break
        eng.step()
        fake[0] += 0.1
    reqs = [x for x in eng.slots if x] + eng.pending
    assert not reqs  # drained
    assert eng.host_cpu_report()["assigns"] >= 6 * 3


def test_sampling_is_reproducible_per_seed(model):
    def run(seed):
        eng = InferenceEngine(model, max_batch=2, max_len=24, greedy=False,
                              sample_seed=seed, clock=lambda: 0.0)
        reqs = []
        for p in ([1, 2, 3, 4], [5, 6, 7]):
            eng.submit(p, 6)
            reqs.append(eng.pending[-1])
        eng.run_until_drained()
        return [r.output for r in reqs]

    first = run(7)
    assert run(7) == first
    assert all(0 <= t < model.cfg.vocab_size for o in first for t in o)


def test_prometheus_text_with_and_without_a_hub(model):
    """Without a hub the snapshot holds the host gauges alone; a hub
    adds the core manager's probes and leaves the tokens as they were."""
    def serve(hub):
        eng = InferenceEngine(model, max_batch=2, max_len=16,
                              clock=lambda: 0.0, telemetry=hub)
        eng.submit([1, 2, 3], 3)
        eng.run_until_drained()
        return eng

    bare = serve(None)
    lines = bare.prometheus_text().splitlines()
    assert f"repro_host_assigns {bare.core_manager.metrics.assigns}" in lines
    assert not any(line.endswith("_total 0") or "_total " in line
                   for line in lines)
    hub = TelemetryHub()
    eng = serve(hub)
    assert eng.host_cpu_report() == bare.host_cpu_report()
    text = eng.prometheus_text()
    assert f"repro_assigns_total {eng.core_manager.metrics.assigns}" in \
        text.splitlines()
    assert "repro_m0_active_cores_count" in text


def test_serve_cli_on_cpu(capsys):
    serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                "--requests", "3", "--new-tokens", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("served 3 requests / 9 tokens")
    assert lines[1].startswith("host CPU [proposed]: cores_active=")
    assert "cpu_tasks=" in lines[1]


def test_cache_dtype_and_device(model):
    eng = InferenceEngine(model, max_batch=3, max_len=20)
    assert eng.cache["k"].shape == (2, 3, 20, 2, 32)
    assert eng.cache["k"].dtype == torch.float32
    assert eng.cache["pos"].dtype == torch.int32
    assert eng.tokens.device == model.device


# ------------------------------ tracing ------------------------------ #
TASKS = ("submit", "alloc_memory", "start_iteration", "finish_request",
         "free_memory")
# each span's parent, by name (cpu_task/submit is a root: `submit` runs
# outside `step`)
PARENTS = {"admit": ("step",), "upload": ("admit",), "prefill": ("admit",),
           "splice": ("admit",), "select": ("admit", "step"),
           "wait": ("admit", "step"), "decode": ("step",),
           "retire": ("step",), "periodic": ("step",),
           "cpu_task/alloc_memory": ("admit",),
           "cpu_task/start_iteration": ("step",),
           "cpu_task/finish_request": ("retire",),
           "cpu_task/free_memory": ("retire",)}


def _trace_serve(model, trace):
    """The "refill" case with `engine.trace = trace`, a fake clock that
    passes the idling period every third step, and what each step
    returned."""
    batch, max_len, policy, cores, prompts, news = CASES["refill"]
    fake = [0.0]
    eng = InferenceEngine(model, max_batch=batch, max_len=max_len,
                          policy=policy, num_host_cores=cores,
                          clock=lambda: fake[0])
    eng.trace = trace
    reqs = []
    for p, n in zip(prompts, news):
        eng.submit(p, n)
        reqs.append(eng.pending[-1])
    returned = []
    while eng.pending or eng.active_mask.any():
        returned.append(eng.step())
        fake[0] += 0.4
    return eng, reqs, returned


@pytest.fixture(scope="module", params=["llama3-8b", "mamba2-2.7b"])
def traced(request):
    m = request.getfixturevalue(
        "model" if request.param == "llama3-8b" else "ssm_model")
    hub = TelemetryHub()
    eng, reqs, returned = _trace_serve(m, hub)
    return types.SimpleNamespace(model=m, hub=hub, eng=eng, reqs=reqs,
                                 returned=returned,
                                 spans={s.id: s for s in hub.spans})


class TestTrace:
    def test_tokens_equal_without_trace(self, traced):
        eng, reqs, returned = _trace_serve(traced.model, None)
        assert [r.output for r in reqs] == \
            [r.output for r in traced.reqs]
        assert returned == traced.returned
        assert eng.host_cpu_report() == traced.eng.host_cpu_report()

    def test_children_lie_within_their_parents(self, traced):
        spans = traced.spans
        for s in spans.values():
            assert s.start <= s.end
            if s.name in ("step", "queued", "cpu_task/submit"):
                assert s.parent == -1, s
                continue
            parent = spans[s.parent]
            assert parent.name in PARENTS[s.name], (s, parent)
            assert parent.start <= s.start and s.end <= parent.end

    def test_each_admission_has_its_queue_admit_and_prefill(self, traced):
        by_req = {}
        for s in traced.spans.values():
            if s.req >= 0:
                by_req.setdefault(s.req, []).append(s)
        assert sorted(by_req) == [r.req_id for r in traced.reqs]
        for r in traced.reqs:
            named = {}
            for s in by_req[r.req_id]:
                named.setdefault(s.name, []).append(s)
            (queued,), (admit,), (prefill,) = (
                named["queued"], named["admit"], named["prefill"])
            assert queued.n == prefill.n == len(r.prompt)
            assert queued.end == admit.start and queued.start < admit.start
            assert r.submitted_ns == queued.start
            for name in ("upload", "splice", "cpu_task/submit",
                         "cpu_task/alloc_memory", "cpu_task/finish_request",
                         "cpu_task/free_memory"):
                assert len(named[name]) == 1, name
            assert prefill.dev is None      # no device events on the CPU

    def test_decode_counts_the_active_slots(self, traced):
        steps = sorted((s for s in traced.spans.values()
                        if s.name == "step"), key=lambda s: s.start)
        assert len(steps) == len(traced.returned)
        for step, out in zip(steps, traced.returned):
            decodes = [s for s in traced.spans.values()
                       if s.name == "decode" and s.parent == step.id]
            assert step.n == len(out)
            assert [d.n for d in decodes] == ([len(out)] if out else [])

    def test_counters_equal_what_was_served(self, traced):
        c = {n: k.value for n, k in traced.hub.counters.items()}
        prompts = CASES["refill"][4]
        decoded = [len(out) for out in traced.returned if out]
        assert c == {"steps": len(traced.returned),
                     "admissions": len(prompts),
                     "prefill_tokens": sum(map(len, prompts)),
                     "decode_calls": len(decoded),
                     "decode_tokens": sum(decoded)}
        # every token is the prefill's first or a decoded one
        assert sum(len(r.output) for r in traced.reqs) == \
            len(prompts) + sum(decoded)

    def test_host_tasks_are_named_by_their_table2_task(self, traced):
        names = [s.name for s in traced.spans.values()]
        tasks = [n for n in names if n.startswith("cpu_task/")]
        assert {n.split("/", 1)[1] for n in tasks} == set(TASKS)
        assert len(tasks) == traced.eng.core_manager.metrics.assigns
        assert 0 < names.count("periodic") < len(traced.returned)

    def test_off_records_nothing_and_reads_no_clock(self, traced,
                                                    monkeypatch):
        hub = TelemetryHub()
        want = [r.output for r in traced.reqs]

        def no_clock():
            raise AssertionError("perf_counter_ns read with trace off")
        monkeypatch.setattr(time, "perf_counter_ns", no_clock)
        batch, max_len, policy, cores, prompts, news = CASES["refill"]
        eng = InferenceEngine(traced.model, max_batch=batch,
                              max_len=max_len, policy=policy,
                              num_host_cores=cores, clock=lambda: 0.0,
                              telemetry=hub)
        reqs = []
        for p, n in zip(prompts, news):
            eng.submit(p, n)
            reqs.append(eng.pending[-1])
        eng.run_until_drained()
        monkeypatch.undo()
        assert [r.output for r in reqs] == want
        assert eng.trace is None and not hub.spans
        assert all(r.submitted_ns is None for r in reqs)

    def test_prometheus_text_adds_the_trace_counters(self, traced):
        """The trace's counters and its ring's drops follow the core
        manager's text, which stays as without a trace."""
        eng = traced.eng
        on = eng.prometheus_text()
        eng.trace = None
        try:
            off = eng.prometheus_text()
        finally:
            eng.trace = traced.hub
        assert on.startswith(off)
        added = on[len(off):].splitlines()
        for name, c in traced.hub.counters.items():
            assert f"repro_{name}_total {c.value}" in added
        assert "repro_spans_dropped 0" in added
        assert len(added) == 2 * len(traced.hub.counters) + 2
