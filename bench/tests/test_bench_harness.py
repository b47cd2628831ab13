"""The benchmark's harness on the CPU: its data files resolve by name, the
traffic follows the seed, the percentiles use every sample, the work
counts equal hand-worked values, the references agree with the program
at a smoke size, and a dry pass loads neither JAX nor the JAX package.

    python -m pytest -q bench/tests
"""
from __future__ import annotations

import ast
import json
import math
import re
import subprocess
import sys
import types

import pytest
import torch

from conftest import ROOT, smoke_cell

BENCH = ROOT / "bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


# ---------------------------- data files ---------------------------- #
def test_benchmark_file_keeps_its_format():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    metrics = b["end_to_end"] + b["per_layer"]
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in metrics)
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in b["end_to_end"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for cell in b["workloads"]:
        mine = {n for n, m in e2e.items()
                if cell["name"] in m.get("workloads", [cell["name"]])}
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in b["per_layer"]
                 if cell["name"] in m["workloads"]]
        assert layer and all(m["moves"] in mine for m in layer)
        assert cell["chips"] == 1
    for m in b["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_resolves_by_name(cell):
    from bench.harness import load_cell, metric_reader, roofline
    c = load_cell(cell)
    assert isinstance(c.family.SMOKE, dict)
    for fn in ("port_config", "param_specs", "layer_weight_flops",
               "head_flops", "mixing_flops", "attention_shape", "ssd_shape",
               "logits", "forward", "state_gap"):
        assert callable(getattr(c.family, fn))
    for name in [*c.end_to_end, *c.per_layer]:
        assert callable(metric_reader(name).read)
        if name.endswith("_roofline"):
            mod = roofline(name[:-len("_roofline")])
            assert mod.NAMES and callable(mod.work)
    assert c.limits["served_gap"] > 0 and c.limits["state_gap"] > 0
    assert set(c.config["kernels"]) <= {"flash_attention",
                                        "decode_attention", "ssd_scan"}


def test_every_data_file_parses():
    for path in [*BENCH.glob("configs/*.json"), *BENCH.glob("traffic/*.json"),
                 *BENCH.glob("limits/*.json"), BENCH / "roofline/peaks.json"]:
        json.loads(path.read_text())
    from bench.traffic import check
    for path in BENCH.glob("traffic/*.json"):
        check(json.loads(path.read_text()), path.stem)


# ------------------------------ traffic ----------------------------- #
def _requests(seed, name="decode-long", n=4):
    from bench.traffic import Traffic
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    g = Traffic(t, 73448, seed)
    return [g.request(c, k) for c in range(t["clients"]) for k in range(n)]


def test_traffic_follows_the_seed():
    a, b, c = _requests(2**31 + 11), _requests(2**31 + 11), _requests(12)
    assert a == b
    assert [r.prompt for r in a] != [r.prompt for r in c]
    # the same sizes, in another order of clients
    assert sorted((len(r.prompt), r.max_new_tokens) for r in a) == \
        sorted((len(r.prompt), r.max_new_tokens) for r in c)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in c]


def test_traffic_lengths_stay_in_bounds():
    from bench.traffic import Traffic
    for path in BENCH.glob("traffic/*.json"):
        t = json.loads(path.read_text())
        g = Traffic(t, 1000, 5)
        lo, hi = t["prompt_len"]
        assert lo <= g.prompt_len.min() and g.prompt_len.max() <= hi
        lo, hi = t["output_len"]
        assert lo <= g.output_len.min() and g.output_len.max() <= hi
        first = [g.request(c, 0).max_new_tokens for c in range(t["clients"])]
        assert min(first) >= 1


# ---------------------------- percentiles --------------------------- #
def test_percentile_uses_every_sample_and_counts_missing():
    from bench.stats import percentile, spread
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile(list(range(20, 0, -1)), 95) == 19
    assert percentile([3.0, 1.0, 2.0, math.inf], 95) == math.inf
    assert percentile([1.0] * 96 + [math.inf] * 4, 95) == 1.0
    assert percentile([1.0] * 95 + [math.inf] * 5, 95) == 1.0
    assert percentile([1.0] * 94 + [math.inf] * 6, 95) == math.inf
    assert spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_ttft_and_itl_readers():
    from bench.harness import ReqLog, metric_reader
    rec = types.SimpleNamespace(t_start=10.0, window_s=2.0)
    done = ReqLog(0, [1], 3, 10.5, False, first=10.7,
                  arrivals=[10.7, 10.7, 11.0])
    primed = ReqLog(1, [1], 9, 9.0, True, first=9.5,
                    arrivals=[9.5, 9.8, 10.4])
    lost = ReqLog(2, [1], 3, 11.9, False)
    rec.requests = [done, primed, lost]
    rec.window_requests = lambda: [done, lost]
    # the request without a first token is missing: 2 samples, p95 inf
    assert metric_reader("ttft_p95_ms").read(rec) == math.inf
    # gaps whose later token came in the window: 0, 0.3 and 0.6
    assert metric_reader("itl_p95_ms").read(rec) == pytest.approx(600)
    # tokens returned in the window: 3 + 1
    assert metric_reader("output_tok_s").read(rec) == pytest.approx(2.0)


# ---------------------------- work counts --------------------------- #
MLA = dict(name="t", family="mla", hidden_size=8, num_hidden_layers=1,
           num_attention_heads=2, num_key_value_heads=2,
           intermediate_size=4, vocab_size=10, q_lora_rank=4,
           kv_lora_rank=2, qk_nope_head_dim=2, qk_rope_head_dim=2,
           v_head_dim=2, torch_dtype="bfloat16")
MAMBA = dict(name="t", family="mamba2", d_model=4, n_layer=1, d_state=2,
             d_conv=4, expand=2, headdim=4, ngroups=1, vocab_size=10,
             torch_dtype="bfloat16")


def _record(conf, calls=(), ops=None, window=1.0):
    from bench.harness import Cell, Record, TraceLog, family_module
    from bench.trace import Stretch
    cell = Cell("t", conf, {}, family_module(conf["family"]), 1, {}, {}, {})
    peaks = json.loads((BENCH / "roofline/peaks.json").read_text())
    rec = Record(cell=cell, peaks=peaks, trace=TraceLog())
    rec.trace.stretch = Stretch(window, 0.5, ops or {}, {}, {}, list(calls),
                                "test")
    return rec


def test_mla_flops_by_hand():
    rec = _record(MLA)
    # weights 32+32+32+8+8+32+96 = 240 a layer; head 2*8*10 = 160;
    # attention 2 heads * (2+2+2) * 2 = 24 a visible position
    assert rec.flops([("decode", [3, 5], 0)]) == 2 * (480 + 160) + 24 * 8
    assert rec.flops([("prefill", 4, 0)]) == 4 * 480 + 24 * 10 + 160
    # the latent's expansion is not counted: a wider latent adds only
    # its own projections, nothing per visible position
    wide = _record(dict(MLA, kv_lora_rank=64))
    fam = wide.cell.family
    assert fam.mixing_flops(wide.cell.config, 7) == \
        rec.cell.family.mixing_flops(MLA, 7) == 24 * 7


def test_mamba2_flops_by_hand():
    rec = _record(MAMBA)
    # projections 32+32+8+8+8+32 = 120, taps 4*12 = 48: 2*168 = 336;
    # head 2*4*10 = 80; the recurrence 5 * 2 heads * 4 * 2 = 80 a token
    assert rec.flops([("prefill", 3, 0)]) == 3 * (336 + 80) + 80
    assert rec.flops([("decode", [9, 1], 0)]) == 2 * (336 + 80 + 80)


def test_roofline_counts_by_hand():
    from bench.harness import roofline
    rec = _record(MLA)
    # B3: 8 rows seen by 2 slots, 2 heads, d 4, dv 2, bf16
    assert roofline("decode_attention").work(rec.cell, "decode", [3, 5]) \
        == [((8 * 2 * 6 + 2 * 2 * 6) * 2 + 8, 2 * 6 * 2 * 8)]
    # B2: S = 4 causal, 10 visible pairs a head
    assert roofline("flash_attention").work(rec.cell, "prefill", 4) == \
        [((4 * 2 * 6 + 4 * 2 * 6) * 2, 2 * 6 * 2 * 10)]
    assert roofline("ssd_scan").work(rec.cell, "prefill", 4) == []
    m = _record(MAMBA)
    # B4: L 3, 2 heads of P 4, N 2, bf16, tile 64
    assert roofline("ssd_scan").work(m.cell, "prefill", 3) == \
        [(96 + 24 + 8 + 24 + 64, 2 * 3 * (64 * 2 + 2 * (64 * 4 + 16)))]
    assert roofline("decode_attention").work(m.cell, "decode", [3]) == []


def test_roofline_share_and_mfu_from_a_stretch():
    rec = _record(MLA, calls=[("decode", [3, 5], 0)],
                  ops={"void decode_attention_kernel<bf16>": 1e-6,
                       "gemm": 1.0}, window=2.0)
    peaks = rec.peaks
    least = max(248 / peaks["hbm_bytes_per_s"], 192 / peaks["bf16_flop_per_s"])
    assert rec.roofline_share("decode_attention") == pytest.approx(
        100 * least / 1e-6)
    assert rec.roofline_share("flash_attention") is None
    assert rec.mfu() == pytest.approx(
        100 * 1472 / (2.0 * peaks["bf16_flop_per_s"]))
    assert rec.idle_share() == pytest.approx(75.0)


def test_trace_union_and_labels():
    from bench.trace import Labeller, merge
    assert merge([(5, 7), (1, 3), (2, 4), (7, 8)]) == [[1, 4], [5, 8]]
    label = Labeller([("engine_step", 10, 50), ("core_manager", 12, 14),
                      ("model_decode_issue", 20, 30)])
    assert [label(t) for t in (5, 13, 25, 40, 60)] == [
        "client", "core_manager", "model_decode_issue", "engine_self",
        "client"]


# ------------------------ references vs program ---------------------- #
@pytest.mark.parametrize("family", ["mla", "mamba2"])
def test_reference_agrees_with_the_program(family):
    """Prefill and three decode steps through the program's cache against
    the reference's full forward pass, float32, at a smoke size: the
    logits, and the cache left after them."""
    from bench import weights
    from bench.harness import family_module
    from bench.reference.common import f32_gemm
    from repro_torch.models import Model
    from repro_torch.models.config import ModelConfig
    cell = "minicpm3-4b.prefill-long" if family == "mla" else \
        "mamba2-2.7b.prefill-long"
    conf = smoke_cell(cell, dtype="float32").config
    fam = family_module(family)
    cfg = ModelConfig(**fam.port_config(conf))
    model = Model(cfg, device="meta")
    w = weights.make(fam.param_specs(conf, cfg.padded_vocab), 5, "cpu")
    model.load_state_dict(w, strict=True, assign=True)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, conf["vocab_size"], (45,), generator=gen)
    logits, cache = model.prefill(tokens[None, :41], max_len=48)
    got = [logits[0, 0, :conf["vocab_size"]]]
    for t in tokens[41:44]:
        logits, cache = model.decode_step(cache, t.view(1, 1))
        got.append(logits[0, 0, :conf["vocab_size"]])
    ref, state = fam.forward(
        weights.make(fam.param_specs(conf, cfg.padded_vocab), 5, "cpu"),
        conf, tokens[:44], 40, f32_gemm, state=True)
    torch.testing.assert_close(torch.stack(got), ref, rtol=1e-4, atol=1e-4)
    # the cache the decode steps left, as `state_gap` holds it
    slot = {k: v[:, 0] for k, v in cache.items() if k != "pos"}
    assert int(cache["pos"]) == 44
    assert fam.state_gap(slot, state, 41, 44) < 1e-4


# --------------------------- the JAX check --------------------------- #
DRY_PASS = """
import sys
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
from conftest import smoke_cell
from bench.harness import forbidden_modules, run_cell
res = run_cell(smoke_cell("minicpm3-4b.decode-long"), 3, 1.0, True,
               device="cpu")
print(sorted({{m.split('.')[0] for m in sys.modules}}))
print("FORBIDDEN", forbidden_modules(), res["correct"])
"""


def test_dry_pass_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", DRY_PASS.format(
            root=str(ROOT), src=str(ROOT / "src"),
            tests=str(BENCH / "tests"))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = eval(out.stdout.splitlines()[-2])
    assert "repro_torch" in tops
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tops)
    assert out.stdout.splitlines()[-1] == "FORBIDDEN [] True"


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n.split(".")[0] in ("repro_torch", "repro", "jax")
                           for n in names), (path, names)
    code = ("import sys; sys.path[:0] = [%r]; import bench.reference.mla, "
            "bench.reference.mamba2; print([m for m in sys.modules if "
            "m.split('.')[0] in ('repro_torch', 'repro', 'jax')])"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "minicpm3-4b.decode-long", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA is not available" in out.stderr


def test_every_family_has_a_smoke_size():
    from bench.harness import family_module
    for p in BENCH.glob("configs/*.json"):
        conf = json.loads(p.read_text())
        smoke = family_module(conf["family"]).SMOKE
        assert set(smoke) <= set(conf)
