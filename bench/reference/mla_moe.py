"""The MLA mixture-of-experts family (DeepSeek-V2-Lite, arXiv:2405.04434):
its parameters, its work and its plain float32 forward pass.

Each layer, with h the residual stream (S, d) and RMSNorm n(.):

    x  = n(h; ln1)
    q  = x Wq                                     (S, H, dn + dr)
    q  = [q_nope, yarn_rope(q_rope)]
    c, kr = split(x Wkv_down, [r, dr]);  c = n(c; kv_ln);  kr = yarn_rope(kr)
    k  = [c Wk_up, kr broadcast over heads]       (S, H, dn + dr)
    v  = c Wv_up                                  (S, H, dv)
    h += softmax_causal(q k^T * m^2 / sqrt(dn + dr)) v Wo
    x  = n(h; ln2)
    h += swiglu(x; W_gate, W_up, W_down)          the first k_dense layers
    h += sum over the top-k experts e of p_e(x) swiglu(x; W_e)
         + swiglu(x; shared)                      the others
    logits = n(h; final_ln) Unembed^T

with p(x) = softmax(x W_router) over the routed experts in float32, its
top k taken greedily and not renormalised (`norm_topk_prob` false,
`routed_scaling_factor` 1), the shared experts one SwiGLU of width
n_shared x moe_intermediate_size, and YaRN RoPE (HF
`DeepseekV2YarnRotaryEmbedding`): inverse frequencies theta^(-2i/dr)
where the rotation is slow, those over `factor` where it is fast, a linear
ramp between, and the softmax temperature m = 0.1 mscale_all_dim ln(factor)
+ 1. RoPE turns the halves of the rope columns (rotate_half), as the
program does; HF turns interleaved pairs, a fixed permutation of the rope
columns of Wq and Wkv_down under random weights (the config file's
`published.note`).

Each token is computed through its own routed experts only, one expert at
a time; every product, the router's and the experts' included, goes
through `gemm`, so the FP8 control rounds them all. The seed's weights
stay in their served dtype and each layer's are cast to float32 as that
layer is used. Parameter names follow the program's state dict so the
benchmark can hand one set of weights to both; nothing here imports the
program.
"""
from __future__ import annotations

import math

import torch

from bench.reference import mla
from bench.reference.common import causal_attention, rms_norm, swiglu

#: the tests' smoke size: a dense layer and an expert layer at the
#: published hidden size, 8 experts of which 3 a token, 1 shared
SMOKE = dict(num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4, intermediate_size=512,
             vocab_size=1000, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
             num_experts_per_tok=3, moe_intermediate_size=64,
             n_shared_experts=1)


def dims(c: dict) -> dict:
    if c.get("q_lora_rank"):
        raise ValueError("mla_moe: a query LoRA is not this family's")
    if (c["scoring_func"], c["topk_method"]) != ("softmax", "greedy") or \
            float(c["routed_scaling_factor"]) != 1.0:
        raise ValueError("mla_moe: only softmax scores, greedy top-k and a "
                         "routed scaling factor of 1 are computed")
    return {"d": c["hidden_size"], "layers": c["num_hidden_layers"],
            "heads": c["num_attention_heads"], "f": c["intermediate_size"],
            "kv_rank": c["kv_lora_rank"], "dn": c["qk_nope_head_dim"],
            "dr": c["qk_rope_head_dim"], "dv": c["v_head_dim"],
            "vocab": c["vocab_size"], "experts": c["n_routed_experts"],
            "k": c["num_experts_per_tok"],
            "fe": c["moe_intermediate_size"],
            "fs": c["n_shared_experts"] * c["moe_intermediate_size"],
            "dense": c["first_k_dense_replace"]}


def port_config(c: dict) -> dict:
    """Keyword arguments of the program's `ModelConfig` for this file."""
    m, y = dims(c), c["rope_scaling"]
    return {"name": c["name"], "family": "moe", "num_layers": m["layers"],
            "d_model": m["d"], "num_heads": m["heads"],
            "num_kv_heads": c["num_key_value_heads"], "d_ff": m["f"],
            "vocab_size": m["vocab"], "attn_type": "mla",
            "q_lora_rank": 0, "kv_lora_rank": m["kv_rank"],
            "qk_nope_dim": m["dn"], "qk_rope_dim": m["dr"],
            "v_head_dim": m["dv"], "rope_theta": float(c["rope_theta"]),
            "yarn_factor": float(y["factor"]),
            "yarn_original_max_pos": y["original_max_position_embeddings"],
            "yarn_beta_fast": float(y["beta_fast"]),
            "yarn_beta_slow": float(y["beta_slow"]),
            "yarn_mscale": float(y["mscale"]),
            "yarn_mscale_all_dim": float(y["mscale_all_dim"]),
            "num_experts": m["experts"], "experts_per_token": m["k"],
            "moe_capacity_factor": 0.0, "moe_d_ff": m["fe"],
            "moe_shared_d_ff": m["fs"],
            "moe_renormalize": bool(c["norm_topk_prob"]),
            "first_k_dense_replace": m["dense"],
            "norm_eps": float(c["rms_norm_eps"]),
            "dtype": c["torch_dtype"]}


def attn_shapes(c: dict) -> dict:
    m = dims(c)
    d, h, qk = m["d"], m["heads"], m["dn"] + m["dr"]
    return {"attn.wq": (d, h * qk),
            "attn.kv_down": (d, m["kv_rank"] + m["dr"]),
            "attn.k_up": (m["kv_rank"], h * m["dn"]),
            "attn.v_up": (m["kv_rank"], h * m["dv"]),
            "attn.wo": (h * m["dv"], d)}


def mlp_shapes(c: dict, moe: bool) -> dict:
    """{name: shape} of one layer's MLP: dense, or the experts stacked on
    a leading axis and the shared experts as one SwiGLU."""
    m = dims(c)
    d, e, fe, fs = m["d"], m["experts"], m["fe"], m["fs"]
    if not moe:
        return {"mlp.w_gate": (d, m["f"]), "mlp.w_up": (d, m["f"]),
                "mlp.w_down": (m["f"], d)}
    return {"mlp.w_gate": (e, d, fe), "mlp.w_up": (e, d, fe),
            "mlp.w_down": (e, fe, d), "shared_mlp.w_gate": (d, fs),
            "shared_mlp.w_up": (d, fs), "shared_mlp.w_down": (fs, d)}


def param_specs(c: dict, padded_vocab: int) -> list[tuple]:
    """(name, shape, init, dtype name) of every parameter; init is
    ("normal", std) or ("ones",); the router in float32, as the
    program keeps it."""
    m, dt = dims(c), c["torch_dtype"]
    specs = [("embed", (padded_vocab, m["d"]), ("normal", 0.02), dt),
             ("unembed", (padded_vocab, m["d"]), ("normal", 0.02), dt),
             ("final_ln", (m["d"],), ("ones",), dt)]
    for i in range(m["layers"]):
        p, moe = f"layers.{i}.", i >= m["dense"]
        specs += [(p + "ln1", (m["d"],), ("ones",), dt),
                  (p + "ln2", (m["d"],), ("ones",), dt),
                  (p + "attn.kv_ln", (m["kv_rank"],), ("ones",), dt)]
        shapes = {**attn_shapes(c), **mlp_shapes(c, moe)}
        specs += [(p + n, s, ("normal", 0.02), dt) for n, s in shapes.items()]
        if moe:
            specs.append((p + "mlp.router", (m["d"], m["experts"]),
                          ("normal", 0.02), "float32"))
    return specs


# ------------------------------ work -------------------------------- #
def layer_weight_flops(c: dict) -> float:
    """2 x the parameters one token passes through in all layers: the
    attention's, the dense layers' MLP, and in each expert layer the
    router, its k routed experts and the shared ones."""
    m = dims(c)
    attn = sum(a * b for a, b in attn_shapes(c).values())
    dense = 3 * m["d"] * m["f"]
    moe = (m["d"] * m["experts"] + 3 * m["d"] * m["fe"] * m["k"]
           + 3 * m["d"] * m["fs"])
    per = m["layers"] * attn + m["dense"] * dense \
        + (m["layers"] - m["dense"]) * moe
    return 2.0 * per


def head_flops(c: dict) -> float:
    m = dims(c)
    return 2.0 * m["d"] * m["vocab"]


def mixing_flops(c: dict, visible: float) -> float:
    """Attention's scores and values of one token over `visible`
    positions, at the published head dims, in all layers (the latent's
    expansion is not counted: the absorbed form needs none)."""
    m = dims(c)
    return 2.0 * m["heads"] * (m["dn"] + m["dr"] + m["dv"]) * visible \
        * m["layers"]


def attention_shape(c: dict) -> dict:
    """What an attention kernel of one layer reads: query heads, K/V
    heads (MLA expands the latent to every head), q/k and v head dims."""
    m = dims(c)
    return {"layers": m["layers"], "heads": m["heads"],
            "kv_heads": m["heads"], "d": m["dn"] + m["dr"], "dv": m["dv"]}


def moe_shape(c: dict) -> dict:
    """What the routed experts of one expert layer hold and compute:
    experts, experts a token, hidden size, an expert's width."""
    m = dims(c)
    return {"layers": m["layers"] - m["dense"], "experts": m["experts"],
            "k": m["k"], "d": m["d"], "f": m["fe"]}


def ssd_shape(c: dict):
    return None


# ----------------------------- forward ------------------------------ #
def yarn_inverse_frequencies(c: dict, device) -> torch.Tensor:
    """(dr / 2,) YaRN's inverse frequencies, HF's
    `DeepseekV2YarnRotaryEmbedding._set_cos_sin_cache`: the correction
    range [low, high) of dims from beta_fast and beta_slow turns over the
    original positions, the plain frequencies below it, those over
    `factor` above it, a linear ramp across it."""
    y, dr = c["rope_scaling"], c["qk_rope_head_dim"]
    base, orig = float(c["rope_theta"]), y["original_max_position_embeddings"]

    def correction_dim(turns):
        return dr * math.log(orig / (turns * 2 * math.pi)) / \
            (2 * math.log(base))
    low = max(math.floor(correction_dim(y["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(y["beta_slow"])), dr - 1)
    if low == high:
        high += 0.001
    exps = torch.arange(0, dr, 2, dtype=torch.float32, device=device) / dr
    extra = 1.0 / base ** exps
    inter = 1.0 / (y["factor"] * base ** exps)
    ramp = ((torch.arange(dr // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def yarn_rope(x: torch.Tensor, positions: torch.Tensor,
              inv: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of x (S, H, D) at `positions` (S,) with inverse
    frequencies `inv` (D/2,), half-split (rotate_half); cos and sin
    unscaled (YaRN's mscale over mscale_all_dim is 1 here, the two equal)."""
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def softmax_scale(c: dict) -> float:
    """1 / sqrt(dn + dr) times YaRN's temperature squared."""
    y = c["rope_scaling"]
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    if y["mscale_all_dim"] and y["factor"] > 1:
        scale *= (0.1 * y["mscale_all_dim"] * math.log(y["factor"]) + 1) ** 2
    return scale


def routed_experts(x: torch.Tensor, g, c: dict, gemm) -> torch.Tensor:
    """Each token of x (S, d) through its top-k routed experts, weighted
    by its router probabilities, plus the shared experts."""
    m = dims(c)
    probs = torch.softmax(gemm(x, g("mlp.router")), dim=-1)
    gate, idx = torch.topk(probs, m["k"], dim=-1)
    if c["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True)
    y = swiglu(x, g("shared_mlp.w_gate"), g("shared_mlp.w_up"),
               g("shared_mlp.w_down"), gemm)
    w_gate, w_up, w_down = g("mlp.w_gate"), g("mlp.w_up"), g("mlp.w_down")
    for e in range(m["experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            out = swiglu(x[tok], w_gate[e], w_up[e], w_down[e], gemm)
            y.index_add_(0, tok, out * gate[tok, slot][:, None])
    return y


def logits(w: dict, c: dict, tokens: torch.Tensor, first: int,
           gemm) -> torch.Tensor:
    """float32 logits (S - first, vocab) at positions first .. S-1 of
    `tokens` (S,), each predicting the token after it; weights `w` by the
    program's names in any dtype (used in float32); products by `gemm`."""
    return forward(w, c, tokens, first, gemm)[0]


@torch.no_grad()
def forward(w: dict, c: dict, tokens: torch.Tensor, first: int, gemm,
            state: bool = False):
    """(`logits`, and with `state` the decode cache after `tokens`:
    {"latent": (layers, S, kv_rank + dr)}, each row the normed latent c
    and the roped kr of its position, float32; else None)."""
    m, eps = dims(c), float(c["rms_norm_eps"])
    s = tokens.shape[0]
    pos = torch.arange(s, device=tokens.device)
    inv = yarn_inverse_frequencies(c, tokens.device)
    scale = softmax_scale(c)
    h = w["embed"][tokens].float()
    hq, dn, dr, dv = m["heads"], m["dn"], m["dr"], m["dv"]
    latent = [] if state else None
    for i in range(m["layers"]):
        p = {n: t.float() for n, t in w.items()
             if n.startswith(f"layers.{i}.")}

        def g(name):
            return p[f"layers.{i}.{name}"]
        x = rms_norm(h, g("ln1"), eps)
        q = gemm(x, g("attn.wq")).view(s, hq, dn + dr)
        q = torch.cat([q[..., :dn], yarn_rope(q[..., dn:], pos, inv)], -1)
        lat = gemm(x, g("attn.kv_down"))
        ckv = rms_norm(lat[:, :m["kv_rank"]], g("attn.kv_ln"), eps)
        kr = yarn_rope(lat[:, None, m["kv_rank"]:], pos, inv)  # (S, 1, dr)
        if state:
            latent.append(torch.cat([ckv, kr[:, 0]], -1))
        k = torch.cat([gemm(ckv, g("attn.k_up")).view(s, hq, dn),
                       kr.expand(s, hq, dr)], -1)
        v = gemm(ckv, g("attn.v_up")).view(s, hq, dv)
        o = causal_attention(q, k, v, scale)
        h = h + gemm(o.reshape(s, hq * dv), g("attn.wo"))
        x = rms_norm(h, g("ln2"), eps)
        if i < m["dense"]:
            h = h + swiglu(x, g("mlp.w_gate"), g("mlp.w_up"),
                           g("mlp.w_down"), gemm)
        else:
            h = h + routed_experts(x, g, c, gemm)
        del p, q, k, v, o, lat
    hn = rms_norm(h[first:], w["final_ln"].float(), eps)
    out = gemm(hn, w["unembed"][:m["vocab"]].float().T)
    return out, ({"latent": torch.stack(latent)} if state else None)


#: the cache is MLA's compressed latent, compared as `mla` compares it
state_gap = mla.state_gap
