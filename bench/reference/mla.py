"""The MLA decoder family (MiniCPM3, arXiv:2405.04434's multi-head latent
attention in a dense decoder): its parameters, its work and its plain
float32 forward pass.

Each layer, with h the residual stream (S, d) and RMSNorm n(.):

    x  = n(h; ln1)
    q  = n(x Wq_down; q_ln) Wq_up                 (S, H, dn + dr)
    q  = [q_nope, rope(q_rope)]
    c, kr = split(x Wkv_down, [r, dr]);  c = n(c; kv_ln);  kr = rope(kr)
    k  = [c Wk_up, kr broadcast over heads]       (S, H, dn + dr)
    v  = c Wv_up                                  (S, H, dv)
    h += softmax_causal(q k^T / sqrt(dn + dr)) v Wo
    h += (silu(n(h; ln2) Wgate) * (n(h; ln2) Wup)) Wdown
    logits = n(h; final_ln) Unembed^T

MiniCPM3's own scalings (scale_emb, scale_depth, dim_model_base) and its
LongRoPE factors are not part of the program under test; the config
file sets them to what is run (each scaling 1, plain RoPE) and lists them
in `reduced`, and this reference computes what is run. Parameter names follow the program's state dict so the
benchmark can hand one set of weights to both; nothing here imports the
program.
"""
from __future__ import annotations

import torch

from bench.reference.common import causal_attention, rms_norm, rope, swiglu

#: the tests' smoke size: two layers at the published hidden size
SMOKE = dict(num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4, intermediate_size=512, vocab_size=1000,
             q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16)


def dims(c: dict) -> dict:
    return {"d": c["hidden_size"], "layers": c["num_hidden_layers"],
            "heads": c["num_attention_heads"], "f": c["intermediate_size"],
            "q_rank": c["q_lora_rank"], "kv_rank": c["kv_lora_rank"],
            "dn": c["qk_nope_head_dim"], "dr": c["qk_rope_head_dim"],
            "dv": c["v_head_dim"], "vocab": c["vocab_size"]}


def port_config(c: dict) -> dict:
    """Keyword arguments of the program's `ModelConfig` for this file."""
    m = dims(c)
    return {"name": c["name"], "family": "dense", "num_layers": m["layers"],
            "d_model": m["d"], "num_heads": m["heads"],
            "num_kv_heads": c["num_key_value_heads"], "d_ff": m["f"],
            "vocab_size": m["vocab"], "attn_type": "mla",
            "q_lora_rank": m["q_rank"], "kv_lora_rank": m["kv_rank"],
            "qk_nope_dim": m["dn"], "qk_rope_dim": m["dr"],
            "v_head_dim": m["dv"], "rope_theta": float(c["rope_theta"]),
            "norm_eps": float(c["rms_norm_eps"]),
            "dtype": c["torch_dtype"]}


def layer_shapes(c: dict) -> dict:
    """{name: shape} of one layer's matrices."""
    m = dims(c)
    d, h, qk = m["d"], m["heads"], m["dn"] + m["dr"]
    return {"attn.q_down": (d, m["q_rank"]),
            "attn.q_up": (m["q_rank"], h * qk),
            "attn.kv_down": (d, m["kv_rank"] + m["dr"]),
            "attn.k_up": (m["kv_rank"], h * m["dn"]),
            "attn.v_up": (m["kv_rank"], h * m["dv"]),
            "attn.wo": (h * m["dv"], d),
            "mlp.w_gate": (d, m["f"]), "mlp.w_up": (d, m["f"]),
            "mlp.w_down": (m["f"], d)}


def param_specs(c: dict, padded_vocab: int) -> list[tuple]:
    """(name, shape, init, dtype name) of every parameter; init is
    ("normal", std) or ("ones",)."""
    m, dt = dims(c), c["torch_dtype"]
    specs = [("embed", (padded_vocab, m["d"]), ("normal", 0.02), dt),
             ("unembed", (padded_vocab, m["d"]), ("normal", 0.02), dt),
             ("final_ln", (m["d"],), ("ones",), dt)]
    for i in range(m["layers"]):
        p = f"layers.{i}."
        specs += [(p + "ln1", (m["d"],), ("ones",), dt),
                  (p + "ln2", (m["d"],), ("ones",), dt),
                  (p + "attn.q_ln", (m["q_rank"],), ("ones",), dt),
                  (p + "attn.kv_ln", (m["kv_rank"],), ("ones",), dt)]
        specs += [(p + n, s, ("normal", 0.02), dt)
                  for n, s in layer_shapes(c).items()]
    return specs


# ------------------------------ work -------------------------------- #
def layer_weight_flops(c: dict) -> float:
    """2 x the parameters one token passes through in all layers."""
    per = sum(a * b for a, b in layer_shapes(c).values())
    return 2.0 * per * dims(c)["layers"]


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


def ssd_shape(c: dict):
    return None


# ----------------------------- forward ------------------------------ #
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
    m, eps, theta = dims(c), float(c["rms_norm_eps"]), float(c["rope_theta"])
    s = tokens.shape[0]
    pos = torch.arange(s, device=tokens.device)
    h = w["embed"][tokens].float()
    hq, dn, dr, dv = m["heads"], m["dn"], m["dr"], m["dv"]
    latent = [] if state else None
    for i in range(m["layers"]):
        p = {n: t.float() for n, t in w.items()
             if n.startswith(f"layers.{i}.")}

        def g(name):
            return p[f"layers.{i}.{name}"]
        x = rms_norm(h, g("ln1"), eps)
        q = gemm(rms_norm(gemm(x, g("attn.q_down")), g("attn.q_ln"), eps),
                 g("attn.q_up")).view(s, hq, dn + dr)
        q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, theta)], -1)
        lat = gemm(x, g("attn.kv_down"))
        ckv = rms_norm(lat[:, :m["kv_rank"]], g("attn.kv_ln"), eps)
        kr = rope(lat[:, None, m["kv_rank"]:], pos, theta)   # (S, 1, dr)
        if state:
            latent.append(torch.cat([ckv, kr[:, 0]], -1))
        k = torch.cat([gemm(ckv, g("attn.k_up")).view(s, hq, dn),
                       kr.expand(s, hq, dr)], -1)
        v = gemm(ckv, g("attn.v_up")).view(s, hq, dv)
        o = causal_attention(q, k, v, (dn + dr) ** -0.5)
        h = h + gemm(o.reshape(s, hq * dv), g("attn.wo"))
        x = rms_norm(h, g("ln2"), eps)
        h = h + swiglu(x, g("mlp.w_gate"), g("mlp.w_up"), g("mlp.w_down"),
                       gemm)
        del p, q, k, v, o, lat
    hn = rms_norm(h[first:], w["final_ln"].float(), eps)
    out = gemm(hn, w["unembed"][:m["vocab"]].float().T)
    return out, ({"latent": torch.stack(latent)} if state else None)


def state_gap(program: dict, ref: dict, prompt: int, rows: int) -> float:
    """The widest relative gap of one slot's cache as the program left
    it against the reference's: per layer, ||p - r|| / ||r|| over the
    rows [0, rows) that the prefill and the decode steps wrote, and apart
    over the decoded rows [prompt, rows), so that a few lost rows are not
    drowned by thousands of prompt rows."""
    p = program["latent"][:, :rows].float()
    r = ref["latent"][:, :rows]
    gaps = [_relative(p, r)]
    if rows > prompt:
        gaps.append(_relative(p[:, prompt:], r[:, prompt:]))
    return max(float(g.max()) for g in gaps)


def _relative(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """||p - r|| / ||r|| over all but the first (layer) axis."""
    return (p - r).flatten(1).norm(dim=1) / \
        r.flatten(1).norm(dim=1).clamp_min(1e-30)
