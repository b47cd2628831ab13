"""The MLA mixture-of-experts family (`bench/reference/mla_moe.py`,
DeepSeek-V2-Lite) on the CPU: its work counts by hand, the reference
against the program at a smoke size, its cell's sound run correct, every
fault of `bench/faults.py` caught and the FP8 control's gaps wider than
the program's, and the new per-layer metrics' readers.

    python -m pytest -q -p no:cacheprovider bench/tests/test_bench_mla_moe.py
"""
from __future__ import annotations

import json

import pytest
import torch

from conftest import ROOT, smoke_cell

CELL = "deepseek-v2-lite.prefill-long"
CONF = json.loads((ROOT / "bench/configs/deepseek-v2-lite.json").read_text())
#: a tiny configuration whose counts are worked out by hand
TINY = dict(CONF, hidden_size=8, num_hidden_layers=3, num_attention_heads=2,
            num_key_value_heads=2, intermediate_size=16, vocab_size=10,
            kv_lora_rank=4, qk_nope_head_dim=2, qk_rope_head_dim=2,
            v_head_dim=2, n_routed_experts=4, num_experts_per_tok=2,
            moe_intermediate_size=4, n_shared_experts=1)


def _record(conf, calls=(), ops=None, window=1.0):
    from bench.harness import Cell, Record, TraceLog, family_module
    from bench.trace import Stretch
    cell = Cell("t", conf, {}, family_module(conf["family"]), 1, {}, {}, {})
    peaks = json.loads((ROOT / "bench/roofline/peaks.json").read_text())
    rec = Record(cell=cell, peaks=peaks, trace=TraceLog())
    rec.trace.stretch = Stretch(window, 0.5, ops or {}, {}, {}, list(calls),
                                "test")
    return rec


def test_mla_moe_flops_by_hand():
    rec = _record(TINY)
    # attention: wq 8x8 + kv_down 8x6 + k_up 4x4 + v_up 4x4 + wo 4x8 = 176
    # a layer; dense MLP 3x8x16 = 384 (layer 0); an expert layer: router
    # 8x4 + 2 experts x 3x8x4 + shared 3x8x4 = 32 + 192 + 96 = 320
    layers = 3 * 176 + 384 + 2 * 320
    # head 2x8x10 = 160; attention 2 heads x (2+2+2) x 2 x 3 layers = 72 a
    # visible position
    assert rec.flops([("decode", [3, 5], 0)]) == \
        2 * (2 * layers + 160) + 72 * 8
    assert rec.flops([("prefill", 4, 0)]) == 4 * 2 * layers + 72 * 10 + 160


def test_moe_experts_roofline_by_hand():
    from bench.harness import roofline
    rec = _record(TINY)
    # 2 expert layers x 3 projections; S = 3 tokens, k = 2: 6 rows; the
    # weights of min(4, 6) experts of 8x4, rows of 8 in and 4 out, bf16
    one = ((4 * 8 * 4 + 6 * (8 + 4)) * 2, 2.0 * 6 * 8 * 4)
    assert roofline("moe_experts").work(rec.cell, "prefill", 3) == [one] * 6
    # a decode step of 1 token: 2 rows, 2 experts' weights
    one = ((2 * 8 * 4 + 2 * (8 + 4)) * 2, 2.0 * 2 * 8 * 4)
    assert roofline("moe_experts").work(rec.cell, "decode", [9]) == [one] * 6
    rec = _record(TINY, calls=[("prefill", 3, 0)],
                  ops={"cutlass GroupProblemShape gemm": 1e-6})
    least = 6 * max((4 * 8 * 4 + 6 * 12) * 2 / 3.35e12,
                    2.0 * 6 * 8 * 4 / 989e12)
    assert rec.roofline_share("moe_experts") == pytest.approx(
        100 * least / 1e-6)


def test_load_imbalance_reader():
    from bench.harness import metric_reader
    from repro_torch.models import moe
    rec = _record(CONF)
    moe.reset_counters()
    assert metric_reader("moe_load_imbalance").read(rec) is None
    cfg_rows = torch.tensor([3, 1, 0, 2])         # one call, 4 experts
    moe._count(cfg_rows)
    assert metric_reader("moe_load_imbalance").read(rec) == \
        pytest.approx(3 * 64 / 6)
    moe.reset_counters()


def test_reference_agrees_with_the_program():
    """Prefill and three decode steps through the program's cache against
    the reference's full forward pass, float32, at the smoke size (the
    published hidden size; a dense layer, then 8 experts of which 3 a
    token and a shared one): the logits, and the latent cache."""
    from bench import weights
    from bench.reference import mla_moe
    from bench.reference.common import f32_gemm
    from repro_torch.models import Model
    from repro_torch.models.config import ModelConfig
    conf = smoke_cell(CELL, dtype="float32").config
    cfg = ModelConfig(**mla_moe.port_config(conf))
    model = Model(cfg, device="meta")
    specs = mla_moe.param_specs(conf, cfg.padded_vocab)
    model.load_state_dict(weights.make(specs, 5, "cpu"), strict=True,
                          assign=True)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, conf["vocab_size"], (45,), generator=gen)
    logits, cache = model.prefill(tokens[None, :41], max_len=48)
    got = [logits[0, 0, :conf["vocab_size"]]]
    for t in tokens[41:44]:
        logits, cache = model.decode_step(cache, t.view(1, 1))
        got.append(logits[0, 0, :conf["vocab_size"]])
    ref, state = mla_moe.forward(weights.make(specs, 5, "cpu"), conf,
                                 tokens[:44], 40, f32_gemm, state=True)
    torch.testing.assert_close(torch.stack(got), ref, rtol=1e-4, atol=1e-4)
    slot = {k: v[:, 0] for k, v in cache.items() if k != "pos"}
    assert mla_moe.state_gap(slot, state, 41, 44) < 1e-4


def _run(fault=None, control=False):
    from bench.faults import FAULTS
    from bench.harness import run_cell
    torch.manual_seed(0)
    mix = smoke_cell(CELL, prompt_len=[4, 12], check_requests=8)
    return run_cell(mix, 2**31 + 101, 3.0, False, device="cpu",
                    hook=FAULTS[fault] if fault else None, control=control)


def test_sound_run_is_correct_and_the_control_reads_wider():
    res = _run(control=True)
    c, ctrl = res["checks"], res["control"]
    assert res["correct"], c
    assert ctrl["served_gap"]["value"] > c["served_gap"]["value"], ctrl
    assert ctrl["state_gap"]["value"] > c["state_gap"]["value"], ctrl


def _faults():
    from bench.faults import FAULTS
    return sorted(FAULTS)


@pytest.mark.parametrize("fault", _faults())
def test_fault_is_caught(fault):
    res = _run(fault)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", _faults())
def test_fault_is_caught_at_the_cells_size(card, fault):
    from bench.control import faults
    row = next(faults(CELL, [fault], 2**31 + 4321, 15.0))
    assert not row["correct"], row


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(card):
    from bench.control import readings
    row = next(readings(CELL, [2**31 + 1234], 30.0))
    assert row["correct"], row
    assert not row["control_correct"], row
