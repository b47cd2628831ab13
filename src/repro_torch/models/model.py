"""Decoder models of the port: dense GQA, mixture-of-experts, MLA and
Mamba2 (ssm): init / prefill / decode (the counterpart of
`repro.models.model` for those families).

Conventions, as in the reference where they can be:
  * parameters keep the reference's names and layouts, one `Block` or
    `MambaBlock` per layer instead of arrays stacked on a leading
    `num_layers` axis (`params_from_jax` converts the reference's tree);
  * the GQA decode cache is {"k", "v": (L, B, S, Hkv, D), "pos"}, the
    MLA one the compressed latent {"latent": (L, B, S, kv_lora_rank +
    qk_rope_dim), "pos"} (rope applied before caching), the ssm one
    {"conv": (L, B, W-1, C), "state": (L, B, H, P, N) float32, "pos"},
    with `pos` a 0-d or (B,) int32 tensor of valid tokens on the model's
    device;
  * the cache is written in place: `decode_step` updates its tensors and
    returns them with `pos + 1` (the reference returns new arrays; a copy
    of the whole cache per step is what this avoids).

On CUDA the prefill attention runs in the hand-written kernel
`kernels/flash_attention`, the decode attention in
`kernels/decode_attention` and the Mamba2 prefill's SSD scan in
`kernels/ssd_scan`; on the CPU, or with `use_kernel=False` on any device,
the attention kernels' plain PyTorch versions (`ref.py`) and the model's
own chunked scan (`mamba2.ssd_chunked`, what the reference's model
computes) run instead. MLA attends with a q/k head dim of qk_nope_dim +
qk_rope_dim and a v head dim of v_head_dim (96 and 64 in MiniCPM3, an
instance of both kernels); its decode expands K and V from the whole
latent cache each step, as the reference does, or with `mla_absorb`
attends against the latent itself in plain PyTorch (the reference's jnp
`_mla_absorbed_attention`, which no kernel computes). The MoE FFN
(`models/moe.py`) is batched matrix products, as in the reference. The
attention keeps the softmax in float32, where the reference's jnp model
path rounds its scores and probabilities to bfloat16, so at bfloat16 the
two models agree to the reference's bfloat16 bound, not bit for bit. The
Mamba2 decode step has no kernel, in the port as in the reference. The
model runs on the card unless the caller passes `device="cpu"`.

Other families (hybrid, encoder-decoder, vision frontend) raise
NotImplementedError at `Model(...)`, naming the ROADMAP item that ports
them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, embed, rms_norm, swiglu,
                                       unembed)

INIT_STD = 0.02

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what this port does not run yet."""
    if cfg.family == "ssm":
        return
    if cfg.family == "hybrid":
        item = "the hybrid family (Zamba2, ROADMAP A10 and A11)"
    elif cfg.is_encdec:
        item = "encoder-decoder models (ROADMAP A11)"
    elif cfg.frontend != "none":
        item = f"the {cfg.frontend} frontend of the {cfg.family} family " \
               f"(ROADMAP A11)"
    elif cfg.family not in ("dense", "moe") or \
            cfg.attn_type not in ("gqa", "mla"):
        item = f"family {cfg.family!r} with attention {cfg.attn_type!r}"
    else:
        return
    raise NotImplementedError(f"{cfg.name}: the port runs dense, "
                              f"mixture-of-experts (GQA or MLA attention) "
                              f"and Mamba2 (ssm) models only; {item} is not "
                              f"ported yet")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device raises when CUDA is not
    available instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the model runs on device {str(dev)!r} but CUDA "
                           f"is not available; pass device='cpu' to run it "
                           f"on the CPU")
    return dev


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One decoder layer: attention (`ln1`, `attn`: GQA, or MLA's low-rank
    projections) and SwiGLU MLP (`ln2`, `mlp`: dense, or `num_experts`
    experts stacked on a leading axis behind a float32 router), with the
    reference's parameter names and layouts
    (`repro.models.model._init_attn`, `_init_mlp`)."""

    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
        h, hkv = cfg.num_heads, cfg.num_kv_heads
        self.ln1 = _param(make.ones(d))
        if cfg.attn_type == "mla":
            qk = cfg.qk_nope_dim + cfg.qk_rope_dim
            attn = {
                "q_down": make.normal(d, cfg.q_lora_rank),
                "q_ln": make.ones(cfg.q_lora_rank),
                "q_up": make.normal(cfg.q_lora_rank, h * qk),
                "kv_down": make.normal(d, cfg.kv_lora_rank
                                       + cfg.qk_rope_dim),
                "kv_ln": make.ones(cfg.kv_lora_rank),
                "k_up": make.normal(cfg.kv_lora_rank, h * cfg.qk_nope_dim),
                "v_up": make.normal(cfg.kv_lora_rank, h * cfg.v_head_dim),
                "wo": make.normal(h * cfg.v_head_dim, d),
            }
        else:
            attn = {"wq": make.normal(d, h * hd),
                    "wk": make.normal(d, hkv * hd),
                    "wv": make.normal(d, hkv * hd),
                    "wo": make.normal(h * hd, d)}
        self.attn = nn.ParameterDict({k: _param(v) for k, v in attn.items()})
        self.ln2 = _param(make.ones(d))
        if cfg.num_experts:
            e = cfg.num_experts
            mlp = {"router": make.normal(d, e, dtype=torch.float32),
                   "w_gate": make.normal(e, d, f),
                   "w_up": make.normal(e, d, f),
                   "w_down": make.normal(e, f, d)}
        else:
            mlp = {"w_gate": make.normal(d, f), "w_up": make.normal(d, f),
                   "w_down": make.normal(f, d)}
        self.mlp = nn.ParameterDict({k: _param(v) for k, v in mlp.items()})


class MambaBlock(nn.Module):
    """One Mamba2 layer, with the reference's parameter names and layouts
    (`repro.models.model._init_mamba`): `dt_bias`, `a_log` and `d_skip`
    are float32, the rest in the model's dtype; `conv` is (W, C). Indexed
    by name (`blk["w_z"]`), as the functions of `models/mamba2.py` read a
    layer's parameters."""

    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        f32 = torch.float32
        self.ln = _param(make.ones(d))
        self.w_z = _param(make.normal(d, di))
        self.w_x = _param(make.normal(d, di))
        self.w_b = _param(make.normal(d, n))
        self.w_c = _param(make.normal(d, n))
        self.w_dt = _param(make.normal(d, h))
        self.dt_bias = _param(make.zeros(h, dtype=f32))
        self.conv = _param(make.normal(cfg.ssm_conv_width, di + 2 * n,
                                       std=0.2))
        self.a_log = _param(make.zeros(h, dtype=f32))       # A = -1
        self.d_skip = _param(make.ones(h, dtype=f32))
        self.gate_ln = _param(make.ones(di))
        self.w_out = _param(make.normal(di, d))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


class _Maker:
    """Draws parameters from one generator straight on the device, in the
    model's dtype: each tensor is drawn in float32, scaled and cast on
    its own, so no float32 copy of the whole model is ever held."""

    def __init__(self, dtype, device, generator):
        self.dtype, self.device, self.generator = dtype, device, generator

    def normal(self, *shape, std=INIT_STD, dtype=None) -> torch.Tensor:
        x = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32).mul_(std)
        return x.to(dtype or self.dtype)

    def ones(self, *shape, dtype=None) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype or self.dtype,
                          device=self.device)

    def zeros(self, *shape, dtype=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype or self.dtype,
                           device=self.device)


class Model(nn.Module):
    """Dense, MoE or MLA decoder, or Mamba2 model, with random weights
    drawn from a `torch.Generator` seeded with `seed`, on `device`
    (default "cuda")."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        make = _Maker(_DTYPES[cfg.dtype], dev, generator)
        self.embed = _param(make.normal(cfg.padded_vocab, cfg.d_model))
        self.unembed = _param(make.normal(cfg.padded_vocab, cfg.d_model))
        self.final_ln = _param(make.ones(cfg.d_model))
        layer = MambaBlock if cfg.family == "ssm" else Block
        self.layers = nn.ModuleList(layer(cfg, make)
                                    for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def loss(self, batch):
        raise NotImplementedError("training is not ported yet (ROADMAP "
                                  "A13)")

    # ====================== attention sub-blocks ====================== #
    def _gqa_qkv(self, h, ap, positions):
        cfg = self.cfg
        b, s, _ = h.shape
        hd = cfg.resolved_head_dim
        q = (h @ ap["wq"]).reshape(b, s, cfg.num_heads, hd)
        k = (h @ ap["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
        v = (h @ ap["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _mla_q(self, h, ap, positions):
        cfg = self.cfg
        b, s, _ = h.shape
        qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
        ql = rms_norm(h @ ap["q_down"], ap["q_ln"], cfg.norm_eps)
        q = (ql @ ap["q_up"]).reshape(b, s, cfg.num_heads, qk_dim)
        q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim],
                                     dim=-1)
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        return torch.cat([q_nope, q_rope], dim=-1)

    def _mla_latent(self, h, ap, positions):
        """Compressed KV latent: (B,S,kv_lora + rope). Rope pre-applied."""
        cfg = self.cfg
        lat = h @ ap["kv_down"]
        c_kv, k_rope = torch.split(lat, [cfg.kv_lora_rank, cfg.qk_rope_dim],
                                   dim=-1)
        c_kv = rms_norm(c_kv, ap["kv_ln"], cfg.norm_eps)
        k_rope = apply_rope(k_rope[:, :, None, :], positions,
                            cfg.rope_theta)[:, :, 0]
        return torch.cat([c_kv, k_rope], dim=-1)

    def _mla_kv_from_latent(self, latent, ap):
        """Expand cached latent to per-head K (nope+rope) and V."""
        cfg = self.cfg
        b, s, _ = latent.shape
        c_kv, k_rope = torch.split(latent,
                                   [cfg.kv_lora_rank, cfg.qk_rope_dim],
                                   dim=-1)
        k_nope = (c_kv @ ap["k_up"]).reshape(b, s, cfg.num_heads,
                                             cfg.qk_nope_dim)
        v = (c_kv @ ap["v_up"]).reshape(b, s, cfg.num_heads,
                                        cfg.v_head_dim)
        k_rope = k_rope[:, :, None, :].expand(b, s, cfg.num_heads,
                                              cfg.qk_rope_dim)
        return torch.cat([k_nope, k_rope], dim=-1), v

    def _mla_scale(self) -> float:
        return (self.cfg.qk_nope_dim + self.cfg.qk_rope_dim) ** -0.5

    def _attn_full(self, h, blk, positions, use_kernel):
        """The attention half of a layer over a whole sequence; returns
        (h, what the decode cache keeps: (k, v), or MLA's latent)."""
        cfg = self.cfg
        hn = rms_norm(h, blk.ln1, cfg.norm_eps)
        if cfg.attn_type == "mla":
            q = self._mla_q(hn, blk.attn, positions)
            kept = self._mla_latent(hn, blk.attn, positions)
            k, v = self._mla_kv_from_latent(kept, blk.attn)
            scale = self._mla_scale()
        else:
            q, k, v = self._gqa_qkv(hn, blk.attn, positions)
            kept, scale = (k, v), None
        o = attn.self_attention(q, k, v, causal=True,
                                window=cfg.sliding_window, scale=scale,
                                chunk=cfg.attn_chunk, use_kernel=use_kernel)
        o = o.reshape(*o.shape[:2], -1)
        return h + o @ blk.attn["wo"], kept

    def _mlp(self, h, blk):
        hn = rms_norm(h, blk.ln2, self.cfg.norm_eps)
        if self.cfg.num_experts:
            y, _ = moe.moe_ffn_sharded(hn, blk.mlp, self.cfg)
            return h + y
        return h + swiglu(hn, blk.mlp["w_gate"], blk.mlp["w_up"],
                          blk.mlp["w_down"])

    # ========================= serving: prefill ======================= #
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int | None = None, *,
                use_kernel: bool = True):
        """Process the full prompt (B, S) int tokens; returns (last-token
        logits (B, 1, padded_vocab), cache). Cache arrays are allocated at
        `max_len` (default: prompt length); an ssm cache does not grow
        with the sequence and ignores it."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        if cfg.family == "ssm":
            return self._prefill_ssm(tokens, use_kernel)
        h = embed(tokens, self.embed)
        b, s, _ = h.shape
        max_len = max_len or s
        if s > max_len:
            raise ValueError(f"prompt of {s} tokens exceeds max_len "
                             f"{max_len}")
        positions = torch.arange(s, device=self.device)[None, :]
        cache = self.empty_cache(b, max_len)
        ring = bool(cfg.swa_ring and cfg.sliding_window)
        for i, blk in enumerate(self.layers):
            h, kept = self._attn_full(h, blk, positions, use_kernel)
            h = self._mlp(h, blk)
            if cfg.attn_type == "mla":
                cache["latent"][i, :, :s] = kept
            elif ring:
                cache["k"][i] = self._to_ring(kept[0], s)
                cache["v"][i] = self._to_ring(kept[1], s)
            else:
                cache["k"][i, :, :s] = kept[0]
                cache["v"][i, :, :s] = kept[1]
        h = rms_norm(h, self.final_ln, cfg.norm_eps)
        logits = unembed(h[:, -1:], self.unembed, cfg)
        cache["pos"] = torch.tensor(s, dtype=torch.int32, device=self.device)
        return logits, cache

    def empty_cache(self, batch: int, max_len: int) -> dict:
        """The zeroed decode cache of an attention model for `batch`
        sequences of up to `max_len` tokens, without "pos": MLA's latent,
        or K and V (the `swa_ring` ring holds the window)."""
        cfg = self.cfg
        if cfg.attn_type == "mla":
            shapes = {"latent": (cfg.num_layers, batch, max_len,
                                 cfg.kv_lora_rank + cfg.qk_rope_dim)}
        else:
            ring = bool(cfg.swa_ring and cfg.sliding_window)
            kv = (cfg.num_layers, batch,
                  cfg.sliding_window if ring else max_len,
                  cfg.num_kv_heads, cfg.resolved_head_dim)
            shapes = {"k": kv, "v": kv}
        return {key: torch.zeros(shape, dtype=self.dtype, device=self.device)
                for key, shape in shapes.items()}

    def _to_ring(self, k, s):
        """§Perf: one layer's full-length K/V (B,S,H,D) as a sliding-window
        ring buffer (B,W,H,D): slot j holds the most recent position p with
        p % W == j (RoPE was applied at write time with true positions, so
        only the mask logic changes)."""
        w = self.cfg.sliding_window
        if s >= w:
            return torch.roll(k[:, s - w:], shifts=(s - w) % w, dims=1)
        out = k.new_zeros((k.shape[0], w, *k.shape[2:]))
        out[:, :s] = k
        return out

    def _prefill_ssm(self, tokens, use_kernel):
        cfg = self.cfg
        h = embed(tokens, self.embed)
        convs, states = [], []
        for blk in self.layers:
            h, conv, state = self._mamba_block_with_state(h, blk, use_kernel)
            convs.append(conv)
            states.append(state)
        h = rms_norm(h, self.final_ln, cfg.norm_eps)
        logits = unembed(h[:, -1:], self.unembed, cfg)
        pos = torch.tensor(tokens.shape[1], dtype=torch.int32,
                           device=self.device)
        return logits, {"conv": torch.stack(convs),
                        "state": torch.stack(states), "pos": pos}

    def _mamba_block_with_state(self, h, blk, use_kernel):
        """`mamba2.mamba2_block` that also returns the decode cache: the
        last W-1 rows of the conv input and the final SSD state. On CUDA
        with `use_kernel` the scan runs in the ssd_scan kernel, else in
        `mamba2.ssd_chunked`."""
        cfg = self.cfg
        bsz, l, _ = h.shape
        di, n = cfg.d_inner, cfg.ssm_state
        nh, p = cfg.ssm_heads, cfg.ssm_head_dim
        w = cfg.ssm_conv_width
        hn = rms_norm(h, blk.ln, cfg.norm_eps)
        z, xbc, dt = mamba2.mamba2_projections(hn, blk, cfg)
        # the reference keeps xbc[:, -(W-1):], fewer than W-1 rows after a
        # shorter prompt (ROADMAP R6); the zeros before them are the history
        # the zero-padded conv below assumed
        conv_state = F.pad(xbc[:, -(w - 1):], (0, 0, max(w - 1 - l, 0), 0))
        xbc_act = F.silu(mamba2._causal_conv(xbc, blk.conv))
        xin, bg, cg = torch.split(xbc_act, [di, n, n], dim=-1)
        xh = xin.reshape(bsz, l, nh, p)
        chunk = min(cfg.ssm_chunk, l)
        if use_kernel and h.device.type == "cuda":
            y, h_final = ssd_ops.ssd(xh, dt, blk.a_log, bg, cg, chunk=chunk,
                                     return_state=True)
        else:
            y, h_final = mamba2.ssd_chunked(xh, dt, blk.a_log, bg, cg,
                                            chunk=chunk)
        out = h + mamba2._gated_out(y, z, xh, blk, cfg, (bsz, l, di))
        return out, conv_state.to(self.dtype), h_final

    # ========================= serving: decode ======================== #
    @torch.no_grad()
    def decode_step(self, cache: dict, token: torch.Tensor, *,
                    use_kernel: bool = True):
        """One decode step. token: (B, 1) int. Returns (logits (B, 1,
        padded_vocab), cache), the cache updated in place with pos + 1.
        The ssm step launches no kernel: `use_kernel` applies to the
        attention of the dense family."""
        cfg = self.cfg
        pos = torch.as_tensor(cache["pos"], device=self.device).to(
            torch.int32)
        token = torch.as_tensor(token, device=self.device)
        h = embed(token, self.embed)
        if cfg.family == "ssm":
            return self._decode_ssm(cache, h, pos)
        positions = pos.reshape(1, 1) if pos.dim() == 0 else pos[:, None]
        for i, blk in enumerate(self.layers):
            if cfg.attn_type == "mla":
                h = self._mla_decode_block(h, blk, cache["latent"][i], pos,
                                           positions, use_kernel)
            else:
                h = self._gqa_decode_block(h, blk, cache["k"][i],
                                           cache["v"][i], pos, positions,
                                           use_kernel)
        h = rms_norm(h, self.final_ln, cfg.norm_eps)
        logits = unembed(h, self.unembed, cfg)
        new = {key: t for key, t in cache.items() if key != "pos"}
        return logits, {**new, "pos": pos + 1}

    def _decode_ssm(self, cache, h, pos):
        """Every layer's one-token Mamba2 block, its conv history and
        state written back into the cache in place."""
        cfg = self.cfg
        for i, blk in enumerate(self.layers):
            h, new = mamba2.mamba2_block_decode(
                h, blk, {"conv": cache["conv"][i],
                         "state": cache["state"][i]}, cfg)
            cache["conv"][i] = new["conv"]
            cache["state"][i] = new["state"]
        h = rms_norm(h, self.final_ln, cfg.norm_eps)
        return unembed(h, self.unembed, cfg), {
            "conv": cache["conv"], "state": cache["state"], "pos": pos + 1}

    def _gqa_decode_block(self, h, blk, ck, cv, pos, positions, use_kernel):
        cfg = self.cfg
        hn = rms_norm(h, blk.ln1, cfg.norm_eps)
        q, k, v = self._gqa_qkv(hn, blk.attn, positions)
        if cfg.swa_ring and cfg.sliding_window:
            w = cfg.sliding_window
            attn.cache_update(ck, cv, k, v, pos % w)
            pos_eff = torch.clamp(pos + 1, max=w)
            window = 0   # the ring holds exactly the window
        else:
            attn.cache_update(ck, cv, k, v, pos)
            pos_eff = pos + 1
            window = cfg.sliding_window
        o = attn.decode_attention(q, ck, cv, pos_eff, window=window,
                                  use_kernel=use_kernel)
        o = o.reshape(*o.shape[:2], -1)
        h = h + o @ blk.attn["wo"]
        return self._mlp(h, blk)

    def _mla_decode_block(self, h, blk, latent_cache, pos, positions,
                          use_kernel):
        """MLA decode: write this token's latent into the cache in place
        at `pos`, expand K/V from the whole latent cache (the reference's
        naive materialization) and attend with pos + 1 valid rows, or,
        with `mla_absorb`, attend against the latent itself."""
        cfg = self.cfg
        hn = rms_norm(h, blk.ln1, cfg.norm_eps)
        q = self._mla_q(hn, blk.attn, positions)
        lat_new = self._mla_latent(hn, blk.attn, positions)
        attn.write_row(latent_cache, lat_new, pos)
        scale = self._mla_scale()
        if cfg.mla_absorb:
            o = self._mla_absorbed_attention(q, latent_cache, blk.attn, pos,
                                             scale)
        else:
            k, v = self._mla_kv_from_latent(latent_cache, blk.attn)
            o = attn.decode_attention(q, k, v, pos + 1, scale=scale,
                                      use_kernel=use_kernel)
        o = o.reshape(*o.shape[:2], -1)
        h = h + o @ blk.attn["wo"]
        return self._mlp(h, blk)

    def _mla_absorbed_attention(self, q, latent_cache, ap, pos, scale):
        """Absorbed-matmul MLA decode (the reference's §Perf option, in
        plain PyTorch as the reference computes it in jnp, float32): fold
        k_up into the query and v_up into the output, so attention runs
        against the compressed latent cache and per-head K/V of shape
        (B, S, H, d) are never made."""
        cfg = self.cfg
        s_max = latent_cache.shape[1]
        heads = cfg.num_heads
        q_nope, q_rope = torch.split(q[:, 0], [cfg.qk_nope_dim,
                                               cfg.qk_rope_dim], dim=-1)
        k_up = ap["k_up"].reshape(cfg.kv_lora_rank, heads, cfg.qk_nope_dim)
        # q_eff[b,h,r] = sum_d q_nope[b,h,d] * k_up[r,h,d]
        q_eff = torch.einsum("bhd,rhd->bhr", q_nope.float(), k_up.float())
        c_kv, k_rope = torch.split(latent_cache,
                                   [cfg.kv_lora_rank, cfg.qk_rope_dim],
                                   dim=-1)
        c_kv = c_kv.float()
        scores = (torch.einsum("bhr,bsr->bhs", q_eff, c_kv)
                  + torch.einsum("bhd,bsd->bhs", q_rope.float(),
                                 k_rope.float())) * scale
        idx = torch.arange(s_max, device=q.device)[None, None, :]
        p = pos if pos.dim() == 0 else pos[:, None, None]
        scores = torch.where(idx < p + 1, scores, attn.NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out_lat = torch.einsum("bhs,bsr->bhr", probs, c_kv)
        v_up = ap["v_up"].reshape(cfg.kv_lora_rank, heads, cfg.v_head_dim)
        o = torch.einsum("bhr,rhd->bhd", out_lat, v_up.float())
        return o[:, None].to(q.dtype)



def _tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 from ml_dtypes included) as a CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(cfg: ModelConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The reference's stacked parameter dict (`repro.models.Model.init`,
    its leaves as numpy arrays) as a state dict of the port's `Model`:
    `Model(cfg, device=...).load_state_dict(params_from_jax(cfg, tree))`
    makes the port compute what the reference computes."""
    check_supported(cfg)
    layers = tree["layers"]
    state = {name: _tensor(tree[name])
             for name in ("embed", "unembed", "final_ln")}
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            for name, stacked in layers.items():
                state[f"layers.{i}.{name}"] = _tensor(stacked[i])
        return state
    for i in range(cfg.num_layers):
        for name in ("ln1", "ln2"):
            state[f"layers.{i}.{name}"] = _tensor(layers[name][i])
        for group in ("attn", "mlp"):
            for name, stacked in layers[group].items():
                state[f"layers.{i}.{group}.{name}"] = _tensor(stacked[i])
    return state
