"""DeepSeek-V2-Lite, the port's own architecture (no JAX counterpart), on
the CPU: the model at its smoke size against the benchmark's plain
float32 reference (`bench/reference/mla_moe.py`), the dropless MoE
against a per-token loop, YaRN's frequencies and scale against their
formulas, the parameter counts against the published ones, and the MoE
counters on a known routing. MiniCPM3's plain RoPE and MLA path stay as
they were.

    PYTHONPATH=src python -m pytest -q tests/test_torch_deepseek_v2.py
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import weights  # noqa: E402
from bench.reference import mla_moe  # noqa: E402
from bench.reference.common import f32_gemm  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import Model, layers, moe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

ARCH = "deepseek-v2-lite"


def _reference_conf() -> dict:
    """The benchmark's config file cut to the port's SMOKE sizes, in
    float32: the reference's keys for the registry's smoke model."""
    conf = json.loads((ROOT / "bench/configs/deepseek-v2-lite.json")
                      .read_text())
    smoke = get_smoke_config(ARCH)
    conf.update(hidden_size=smoke.d_model,
                num_hidden_layers=smoke.num_layers,
                num_attention_heads=smoke.num_heads,
                num_key_value_heads=smoke.num_kv_heads,
                intermediate_size=smoke.d_ff, vocab_size=smoke.vocab_size,
                kv_lora_rank=smoke.kv_lora_rank,
                qk_nope_head_dim=smoke.qk_nope_dim,
                qk_rope_head_dim=smoke.qk_rope_dim,
                v_head_dim=smoke.v_head_dim,
                n_routed_experts=smoke.num_experts,
                num_experts_per_tok=smoke.experts_per_token,
                moe_intermediate_size=smoke.moe_d_ff,
                n_shared_experts=smoke.moe_shared_d_ff // smoke.moe_d_ff,
                torch_dtype="float32")
    return conf


# ------------------------------ the model ---------------------------- #
class TestAgainstReference:
    def test_reference_config_is_the_registrys_smoke(self):
        """The reference's keys give the registry's smoke model, in
        float32 (the name and vocab padding aside)."""
        mine = ModelConfig(**mla_moe.port_config(_reference_conf()))
        smoke = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
        assert dataclasses.replace(mine, name=smoke.name,
                                   vocab_pad_mult=smoke.vocab_pad_mult,
                                   citation=smoke.citation) == smoke
        full = json.loads((ROOT / "bench/configs/deepseek-v2-lite.json")
                          .read_text())
        assert ModelConfig(**mla_moe.port_config(full)) == \
            dataclasses.replace(get_config(ARCH), citation="")

    def test_smoke_decode_matches_reference(self):
        """A prefill of 21 tokens, then 3 decode steps through the latent
        cache, against the reference's full forward pass over the 24, in
        float32: every step's logits and the cache's latent rows within
        1e-4 (what `bench/tests`' MLA check holds)."""
        conf = _reference_conf()
        cfg = ModelConfig(**mla_moe.port_config(conf))
        specs = mla_moe.param_specs(conf, cfg.padded_vocab)
        model = Model(cfg, device="meta")
        model.load_state_dict(weights.make(specs, 11, "cpu"), strict=True,
                              assign=True)
        gen = torch.Generator().manual_seed(3)
        tokens = torch.randint(0, conf["vocab_size"], (24,), generator=gen)
        logits, cache = model.prefill(tokens[None, :21], max_len=32)
        got = [logits[0, 0, :conf["vocab_size"]]]
        for t in tokens[21:24]:
            logits, cache = model.decode_step(cache, t.view(1, 1))
            got.append(logits[0, 0, :conf["vocab_size"]])
        ref, state = mla_moe.forward(weights.make(specs, 11, "cpu"), conf,
                                     tokens, 20, f32_gemm, state=True)
        torch.testing.assert_close(torch.stack(got), ref[:4], rtol=1e-4,
                                   atol=1e-4)
        assert int(cache["pos"]) == 24
        torch.testing.assert_close(cache["latent"][:, 0, :24],
                                   state["latent"], rtol=1e-4, atol=1e-4)

    def test_layers_are_dense_then_experts(self):
        """Layer 0 is a dense SwiGLU of d_ff; the rest hold the routed
        experts at `moe_d_ff` and the shared ones as one SwiGLU; the
        query comes straight from d_model (`wq`, no LoRA)."""
        cfg = get_smoke_config(ARCH)
        model = Model(cfg, device="meta")
        first, rest = model.layers[0], model.layers[1:]
        assert set(first.mlp) == {"w_gate", "w_up", "w_down"}
        assert first.mlp["w_gate"].shape == (cfg.d_model, cfg.d_ff)
        assert not hasattr(first, "shared_mlp")
        for blk in rest:
            assert blk.mlp["w_gate"].shape == (cfg.num_experts, cfg.d_model,
                                               cfg.moe_d_ff)
            assert blk.shared_mlp["w_down"].shape == (cfg.moe_shared_d_ff,
                                                      cfg.d_model)
        assert "wq" in first.attn and "q_down" not in first.attn
        # the analytic count leaves out the norms and the vocab's padding
        padding = 2 * (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model
        assert sum(p.numel() for p in model.parameters()) - padding - \
            sum(p.numel() for n, p in model.named_parameters()
                if n.endswith(("ln1", "ln2", "kv_ln", "final_ln"))) == \
            cfg.param_count()


# ----------------------------- dropless MoE -------------------------- #
def _moe_setup(cap: float, seed: int = 0, n: int = 24):
    """A smoke MoE layer (8 experts, top 3, one shared expert) whose
    router sends every token to expert 5 first, in float32, and its
    input (1, n, d)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                              moe_capacity_factor=cap)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    gen = torch.Generator().manual_seed(seed)
    params = {"router": torch.randn(d, e, generator=gen) * 0.02,
              "w_gate": torch.randn(e, d, f, generator=gen) * 0.05,
              "w_up": torch.randn(e, d, f, generator=gen) * 0.05,
              "w_down": torch.randn(e, f, d, generator=gen) * 0.05}
    x = torch.randn(1, n, d, generator=gen)
    params["router"][:, 5] += x[0].mean(0) * 0.5
    shared = {"w_gate": torch.randn(d, cfg.moe_shared_d_ff, generator=gen)
              * 0.05,
              "w_up": torch.randn(d, cfg.moe_shared_d_ff, generator=gen)
              * 0.05,
              "w_down": torch.randn(cfg.moe_shared_d_ff, d, generator=gen)
              * 0.05}
    return cfg, params, shared, x


def _per_token(cfg, params, shared, x):
    """Each token through its top-k experts one at a time, weighted by its
    (not renormalised) router probabilities, plus the shared SwiGLU."""
    probs = torch.softmax(x[0] @ params["router"], -1)
    gate, idx = torch.topk(probs, cfg.experts_per_token, -1)
    out = []
    for t in range(x.shape[1]):
        xt = x[0, t]
        y = (F.silu(xt @ shared["w_gate"]) * (xt @ shared["w_up"])) \
            @ shared["w_down"]
        for g, e in zip(gate[t], idx[t]):
            y = y + g * ((F.silu(xt @ params["w_gate"][e])
                          * (xt @ params["w_up"][e])) @ params["w_down"][e])
        out.append(y)
    return torch.stack(out)[None], idx


class TestDropless:
    def test_matches_per_token_loop_where_capacity_would_drop(self):
        """Expert 5 takes every token, more than capacity 1.25 gives it
        (ceil(24 x 3 x 1.25 / 8) = 12 slots): the dropless path gives the
        per-token loop's result, the capacity path does not."""
        cfg, params, shared, x = _moe_setup(0.0)
        want, idx = _per_token(cfg, params, shared, x)
        assert int((idx == 5).sum()) == x.shape[1] > moe.capacity(
            x.shape[1], dataclasses.replace(cfg, moe_capacity_factor=1.25))
        got, _ = moe.moe_ffn(x, params, cfg, shared)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        capped = dataclasses.replace(cfg, moe_capacity_factor=1.25)
        dropped, _ = moe.moe_ffn(x, params, capped, shared)
        gap = (dropped - want).abs().amax(-1)[0]
        assert (gap > 1e-3).sum() >= x.shape[1] - 12

    def test_is_deterministic_and_batch_independent(self):
        """Two calls give the same bits, and a batch of two rows gives
        each row what it gives alone."""
        cfg, params, shared, x = _moe_setup(0.0, seed=1)
        a, _ = moe.moe_ffn(x, params, cfg, shared)
        b, _ = moe.moe_ffn(x, params, cfg, shared)
        assert torch.equal(a, b)
        pair, _ = moe.moe_ffn(torch.cat([x, x.flip(1)]), params, cfg,
                              shared)
        torch.testing.assert_close(pair[0], a[0], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(pair[1], a[0].flip(0), rtol=1e-6,
                                   atol=1e-7)

    def test_grouped_mm_loop_equals_per_group_products(self):
        gen = torch.Generator().manual_seed(2)
        a = torch.randn(10, 6, generator=gen)
        w = torch.randn(4, 6, 5, generator=gen)
        ends = torch.tensor([3, 3, 7, 10])
        got = moe.grouped_mm(a, w, ends)
        want = torch.cat([a[:3] @ w[0], a[3:7] @ w[2], a[7:] @ w[3]])
        torch.testing.assert_close(got, want)
        meta = moe.grouped_mm(a.to("meta"), w.to("meta"), ends.to("meta"))
        assert meta.shape == (10, 5) and meta.device.type == "meta"

    def test_counters_on_a_known_routing(self):
        """A router that sends token t to experts (t, t + 1, t + 2) mod 8
        by one-hot inputs: 6 tokens give 18 routed rows, experts 2 to 5
        take 3 each, all 8 are touched; a decode call of 1 token adds 3
        rows over 3 experts."""
        cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
        d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        router = torch.zeros(d, e)
        for t in range(e):
            for j, w in enumerate((3.0, 2.0, 1.0)):
                router[t, (t + j) % e] = w
        params = {"router": router, "w_gate": torch.zeros(e, d, f),
                  "w_up": torch.zeros(e, d, f), "w_down": torch.zeros(e, f, d)}
        x = F.one_hot(torch.arange(6), d).float()[None]
        moe.reset_counters()
        moe.moe_ffn(x, params, cfg)
        assert moe.counters() == {"calls": 1, "routed_rows": 18,
                                  "largest_expert_rows": 3,
                                  "experts_touched": 8}
        moe.moe_ffn(F.one_hot(torch.tensor([[4]]), d).float(), params, cfg)
        assert moe.counters() == {"calls": 2, "routed_rows": 21,
                                  "largest_expert_rows": 4,
                                  "experts_touched": 11}
        moe.reset_counters()
        assert set(moe.counters().values()) == {0}

    def test_capacity_configs_keep_their_path(self):
        """Granite-MoE and Mixtral keep GShard capacity, renormalised
        gates and no shared experts or dense layers."""
        for arch in ("granite-moe-3b-a800m", "mixtral-8x22b"):
            cfg = get_config(arch)
            assert not moe.dropless(cfg) and cfg.moe_capacity_factor == 1.25
            assert cfg.moe_renormalize and not cfg.moe_shared_d_ff
            assert cfg.first_k_dense_replace == 0
            assert cfg.expert_d_ff == cfg.d_ff
        assert moe.dropless(get_config(ARCH))


# -------------------------------- YaRN ------------------------------- #
class TestYarn:
    def test_frequencies_follow_the_formula(self):
        """DeepSeek-V2-Lite's 32 inverse frequencies: dims below 10 keep
        theta^(-2i/64), dims from 23 on are those over 40, a linear ramp
        between (beta_fast 32 and beta_slow 1 turns over 4,096
        positions)."""
        cfg = get_config(ARCH)
        got = layers.yarn_frequencies(64, cfg)
        low = math.floor(64 * math.log(4096 / (32 * 2 * math.pi))
                         / (2 * math.log(10000)))
        high = math.ceil(64 * math.log(4096 / (1 * 2 * math.pi))
                         / (2 * math.log(10000)))
        assert (low, high) == (10, 23)
        want = []
        for i in range(32):
            plain = 10000.0 ** (-2 * i / 64)
            ramp = min(max((i - low) / (high - low), 0.0), 1.0)
            want.append(plain / 40 * ramp + plain * (1 - ramp))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        assert torch.equal(got[:10], layers.rope_frequencies(64, 1e4)[:10])

    def test_softmax_scale(self):
        mscale = 0.1 * 0.707 * math.log(40) + 1
        assert mscale == pytest.approx(1.2608, abs=1e-4)
        model = Model(get_config(ARCH), device="meta")
        assert model._mla_scale() == pytest.approx(mscale ** 2 / 192 ** 0.5,
                                                   rel=1e-12)
        assert model._mla_scale() == pytest.approx(
            mla_moe.softmax_scale(json.loads(
                (ROOT / "bench/configs/deepseek-v2-lite.json").read_text())),
            rel=1e-12)

    def test_model_rope_takes_yarn_frequencies(self):
        cfg = get_config(ARCH)
        model = Model(cfg, device="meta")
        x = torch.randn(1, 5, 2, 64)
        pos = torch.arange(3, 8)[None]
        assert torch.equal(model._rope(x, pos), layers.apply_rope(
            x, pos, 1e4, layers.yarn_frequencies(64, cfg)))


class TestMiniCPM3Unchanged:
    def test_plain_rope_frequencies(self):
        """MiniCPM3's plain RoPE: theta^(-2i/d), computed as before, and
        the model's rope is `apply_rope` at theta bit for bit."""
        got = layers.rope_frequencies(32, 10000.0)
        want = 1.0 / (10000.0 ** (torch.arange(0, 32, 2,
                                               dtype=torch.float32) / 32))
        assert torch.equal(got, want)
        cfg = get_smoke_config("minicpm3-4b")
        assert not cfg.yarn_factor and cfg.q_lora_rank
        model = Model(cfg, device="cpu", seed=0)
        x = torch.randn(2, 7, 4, 8)
        pos = torch.arange(7)[None]
        assert torch.equal(model._rope(x, pos),
                           layers.apply_rope(x, pos, cfg.rope_theta))
        assert model._mla_scale() == (16 + 8) ** -0.5

    def test_logits_as_the_plain_path_computes_them(self):
        """MiniCPM3's smoke model in float32: a prefill and two decode
        steps give the logits of the MLA equations written out here (the
        query's LoRA, plain RoPE, 1 / sqrt(24), one dense SwiGLU a
        layer)."""
        cfg = dataclasses.replace(get_smoke_config("minicpm3-4b"),
                                  dtype="float32")
        model = Model(cfg, device="cpu", seed=4)
        toks = torch.randint(0, 1000, (1, 12),
                             generator=torch.Generator().manual_seed(5))
        logits, cache = model.prefill(toks[:, :10], max_len=16)
        got = [logits[0, 0]]
        for t in toks[0, 10:12]:
            logits, cache = model.decode_step(cache, t.view(1, 1))
            got.append(logits[0, 0])
        want = _minicpm3_by_hand(model, toks[0])[9:12]
        v = cfg.vocab_size          # the padded ids read the lowest value
        torch.testing.assert_close(torch.stack(got)[:, :v], want[:, :v],
                                   rtol=1e-4, atol=1e-4)


def _minicpm3_by_hand(model, toks):
    cfg = model.cfg
    s = toks.shape[0]
    pos = torch.arange(s)
    dn, dr, dv, h = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, \
        cfg.num_heads

    def norm(x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + cfg.norm_eps) * w

    def rope(x):
        inv = 1.0 / cfg.rope_theta ** (torch.arange(0, dr, 2).float() / dr)
        ang = pos[:, None].float() * inv
        cos, sin = ang.cos()[:, None], ang.sin()[:, None]
        a, b = x.chunk(2, -1)
        return torch.cat([a * cos - b * sin, a * sin + b * cos], -1)
    x = model.embed[toks]
    for blk in model.layers:
        ap, hn = blk.attn, norm(x, blk.ln1)
        q = (norm(hn @ ap["q_down"], ap["q_ln"]) @ ap["q_up"]).view(
            s, h, dn + dr)
        q = torch.cat([q[..., :dn], rope(q[..., dn:])], -1)
        lat = hn @ ap["kv_down"]
        c = norm(lat[:, :cfg.kv_lora_rank], ap["kv_ln"])
        kr = rope(lat[:, None, cfg.kv_lora_rank:]).expand(s, h, dr)
        k = torch.cat([(c @ ap["k_up"]).view(s, h, dn), kr], -1)
        v = (c @ ap["v_up"]).view(s, h, dv)
        sc = torch.einsum("qhd,khd->hqk", q, k) * (dn + dr) ** -0.5
        sc = sc.masked_fill(torch.ones(s, s).triu(1).bool(), float("-inf"))
        o = torch.einsum("hqk,khd->qhd", sc.softmax(-1), v)
        x = x + o.reshape(s, h * dv) @ ap["wo"]
        hn = norm(x, blk.ln2)
        x = x + (F.silu(hn @ blk.mlp["w_gate"]) * (hn @ blk.mlp["w_up"])) \
            @ blk.mlp["w_down"]
    return norm(x, model.final_ln) @ model.unembed.T


# ------------------------------- counts ------------------------------ #
def test_parameter_counts():
    """15.71 B parameters in all (the dense layer 0 and the shared
    experts counted); 2.4 B a token without the input embedding table,
    whose lookup is no product (the output head counts)."""
    cfg = get_config(ARCH)
    assert cfg.param_count() == pytest.approx(15.71e9, rel=5e-3)
    active = cfg.active_param_count() - cfg.vocab_size * cfg.d_model
    assert active == pytest.approx(2.4e9, rel=3e-2)
    shapes = {n: p.numel() for n, p in Model(cfg, device="meta")
              .named_parameters() if not n.endswith("ln1")
              and not n.endswith(("ln2", "kv_ln", "final_ln"))}
    assert sum(shapes.values()) == cfg.param_count()


def test_rope_apart_takes_the_deepseek_instance():
    """B3's wrapper takes K in two parts at (192, 128): the nope part
    (128 columns) per head, the rope part the latent's columns 512 to 575
    read in place."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    assert {(96, 64), (192, 128)} == set(dec_ops.ROPE_APART)
    latent = torch.zeros(4, 64, 576, dtype=torch.bfloat16)
    k_nope = torch.zeros(4, 64, 16, 128, dtype=torch.bfloat16)
    dec_ops._check_rope_in_place(k_nope, latent[..., 512:], 128)
    with pytest.raises(ValueError, match="two parts only"):
        dec_ops._check_rope_in_place(k_nope[..., :96], latent[..., 512:],
                                     128)
