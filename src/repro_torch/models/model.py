"""Dense GQA decoder and Mamba2 (ssm) model: init / prefill / decode (the
counterpart of `repro.models.model`, dense and ssm families only).

Conventions, as in the reference where they can be:
  * parameters keep the reference's names and layouts, one `Block` or
    `MambaBlock` per layer instead of arrays stacked on a leading
    `num_layers` axis (`params_from_jax` converts the reference's tree);
  * the dense decode cache is {"k", "v": (L, B, S, Hkv, D), "pos"}, the
    ssm one {"conv": (L, B, W-1, C), "state": (L, B, H, P, N) float32,
    "pos"}, with `pos` a 0-d or (B,) int32 tensor of valid tokens on the
    model's device;
  * the cache is written in place: `decode_step` updates its tensors and
    returns them with `pos + 1` (the reference returns new arrays; a copy
    of the whole cache per step is what this avoids).

On CUDA the prefill attention runs in the hand-written kernel
`kernels/flash_attention`, the decode attention in
`kernels/decode_attention` and the Mamba2 prefill's SSD scan in
`kernels/ssd_scan`; on the CPU, or with `use_kernel=False` on any device,
the attention kernels' plain PyTorch versions (`ref.py`) and the model's
own chunked scan (`mamba2.ssd_chunked`, what the reference's model
computes) run instead. The attention keeps the softmax in float32, where
the reference's jnp model path rounds its scores and probabilities to
bfloat16, so at bfloat16 the two models agree to the reference's bfloat16
bound, not bit for bit. The Mamba2 decode step has no kernel, in the port
as in the reference. The model runs on the card unless the caller passes
`device="cpu"`.

Other families raise NotImplementedError at `Model(...)`, naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
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
    elif cfg.attn_type == "mla":
        item = "MLA attention (ROADMAP A11)"
    elif cfg.num_experts:
        item = "mixture-of-experts layers (ROADMAP A10)"
    elif cfg.family != "dense" or cfg.attn_type != "gqa":
        item = f"family {cfg.family!r} with attention {cfg.attn_type!r}"
    else:
        return
    raise NotImplementedError(f"{cfg.name}: the port runs dense GQA and "
                              f"Mamba2 (ssm) models only; {item} is not "
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
    """One decoder layer: attention (`ln1`, `attn`) and SwiGLU MLP
    (`ln2`, `mlp`), with the reference's parameter names and layouts."""

    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
        h, hkv = cfg.num_heads, cfg.num_kv_heads
        self.ln1 = _param(make.ones(d))
        self.attn = nn.ParameterDict({
            "wq": _param(make.normal(d, h * hd)),
            "wk": _param(make.normal(d, hkv * hd)),
            "wv": _param(make.normal(d, hkv * hd)),
            "wo": _param(make.normal(h * hd, d)),
        })
        self.ln2 = _param(make.ones(d))
        self.mlp = nn.ParameterDict({
            "w_gate": _param(make.normal(d, f)),
            "w_up": _param(make.normal(d, f)),
            "w_down": _param(make.normal(f, d)),
        })


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

    def normal(self, *shape, std=INIT_STD) -> torch.Tensor:
        x = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32).mul_(std)
        return x.to(self.dtype)

    def ones(self, *shape, dtype=None) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype or self.dtype,
                          device=self.device)

    def zeros(self, *shape, dtype=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype or self.dtype,
                           device=self.device)


class Model(nn.Module):
    """Dense GQA decoder or Mamba2 model with random weights drawn from a
    `torch.Generator` seeded with `seed`, on `device` (default "cuda")."""

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

    def _attn_full(self, h, blk, positions, use_kernel):
        cfg = self.cfg
        hn = rms_norm(h, blk.ln1, cfg.norm_eps)
        q, k, v = self._gqa_qkv(hn, blk.attn, positions)
        o = attn.self_attention(q, k, v, causal=True,
                                window=cfg.sliding_window,
                                chunk=cfg.attn_chunk, use_kernel=use_kernel)
        o = o.reshape(*o.shape[:2], -1)
        return h + o @ blk.attn["wo"], (k, v)

    def _mlp(self, h, blk):
        hn = rms_norm(h, blk.ln2, self.cfg.norm_eps)
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
        ring = bool(cfg.swa_ring and cfg.sliding_window)
        shape = (cfg.num_layers, b, cfg.sliding_window if ring else max_len,
                 cfg.num_kv_heads, cfg.resolved_head_dim)
        k_cache = torch.zeros(shape, dtype=self.dtype, device=self.device)
        v_cache = torch.zeros(shape, dtype=self.dtype, device=self.device)
        for i, blk in enumerate(self.layers):
            h, (k, v) = self._attn_full(h, blk, positions, use_kernel)
            h = self._mlp(h, blk)
            if ring:
                k_cache[i] = self._to_ring(k, s)
                v_cache[i] = self._to_ring(v, s)
            else:
                k_cache[i, :, :s] = k
                v_cache[i, :, :s] = v
        h = rms_norm(h, self.final_ln, cfg.norm_eps)
        logits = unembed(h[:, -1:], self.unembed, cfg)
        pos = torch.tensor(s, dtype=torch.int32, device=self.device)
        return logits, {"k": k_cache, "v": v_cache, "pos": pos}

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
            h = self._gqa_decode_block(h, blk, cache["k"][i], cache["v"][i],
                                       pos, positions, use_kernel)
        h = rms_norm(h, self.final_ln, cfg.norm_eps)
        logits = unembed(h, self.unembed, cfg)
        return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}

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
