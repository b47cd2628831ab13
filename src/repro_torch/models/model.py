"""The port's models, every family of the reference: dense GQA,
mixture-of-experts, MLA, Mamba2 (ssm), the Zamba2 hybrid, the vision
frontend (vlm) and the encoder-decoder (audio): init / prefill / decode
(the counterpart of `repro.models.model`).

Conventions, as in the reference where they can be:
  * parameters keep the reference's names and layouts, one `Block` or
    `MambaBlock` per layer instead of arrays stacked on a leading
    `num_layers` axis (`params_from_jax` converts the reference's tree);
    the hybrid adds `shared`, one `Block` applied after every
    `hybrid_period` Mamba2 layers, and the encoder-decoder decoder
    `Block`s with cross-attention (`ln_x`, `xattn`) plus `enc_layers`
    and `enc_final_ln`;
  * the GQA decode cache is {"k", "v": (L, B, S, Hkv, D), "pos"}, the
    MLA one the compressed latent {"latent": (L, B, S, kv_lora_rank +
    qk_rope_dim), "pos"} (rope applied before caching), the ssm one
    {"conv": (L, B, W-1, C), "state": (L, B, H, P, N) float32, "pos"};
    the hybrid's {"ssm": {"conv", "state"} stacked (G, per, B, ...),
    "attn": {"k", "v": (G, B, S, Hkv, D)}, "tail": the last layers'
    {"conv", "state"} or None, "pos"}; the encoder-decoder's {"k", "v",
    "xk", "xv": (L, B, S_mem, Hkv, D), "pos"}; `pos` a 0-d or (B,) int32
    tensor of valid tokens on the model's device (`empty_cache` makes
    each layout);
  * the cache is written in place: `decode_step` updates its tensors and
    returns them with `pos + 1` (the reference returns new arrays; a copy
    of the whole cache per step is what this avoids);
  * the frontends are stubs, as in the reference: a vlm prefill takes the
    frontend's `embeds` (B, frontend_tokens, D) before the tokens (they
    count in positions, `pos` and `max_len`), an encoder-decoder prefill
    encodes its `embeds` (frame embeddings) with bidirectional attention.

On CUDA the prefill attention (causal, or the encoder's non-causal)
runs in the hand-written kernel `kernels/flash_attention`, the decode
attention in `kernels/decode_attention` and the Mamba2 prefill's SSD scan
(the hybrid's too) in `kernels/ssd_scan`; on the CPU, or with
`use_kernel=False` on any device, the attention kernels' plain PyTorch
versions (`ref.py`) and the model's own chunked scan
(`mamba2.ssd_chunked`, what the reference's model computes) run instead.
MLA attends with a q/k head dim of qk_nope_dim + qk_rope_dim and a v head
dim of v_head_dim (96 and 64 in MiniCPM3, an instance of both kernels);
its decode expands K and V from the whole latent cache each step, as the
reference does, or with `mla_absorb` attends against the latent itself in
plain PyTorch (the reference's jnp `_mla_absorbed_attention`, which no
kernel computes). Zamba2's shared block attends at head dim 112, an
instance of both kernels. The encoder-decoder's cross-attention is plain
PyTorch (`attention.cross_attention`), as the reference computes it in
jnp outside any Pallas kernel, rounding where the reference rounds. The
MoE FFN (`models/moe.py`) is batched matrix products, as in the
reference. The attention keeps the softmax in float32, where the
reference's jnp model path rounds its scores and probabilities to
bfloat16, so at bfloat16 the two models agree to the reference's
bfloat16 bound, not bit for bit. The Mamba2 decode step has no kernel, in
the port as in the reference. `loss`, the training forward, runs the
plain math on any device (no kernel has a backward, here or in the
reference). The model runs on the card unless the caller passes
`device="cpu"`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, cross_entropy_loss, embed,
                                       rms_norm, swiglu, unembed,
                                       yarn_frequencies, yarn_mscale)

INIT_STD = 0.02
MOE_AUX_COEF = 0.01

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a configuration no family of the
    reference computes: the hybrid's shared block and the
    encoder-decoder take GQA attention (the reference's decode paths for
    them are GQA's), the other attention families GQA or MLA."""
    if cfg.family == "ssm":
        return
    # (the reference's configs, which `params_from_jax` also takes, have
    # no YaRN fields)
    if getattr(cfg, "yarn_factor", 0.0) and \
            cfg.yarn_mscale != cfg.yarn_mscale_all_dim:
        raise NotImplementedError(f"{cfg.name}: YaRN with mscale "
                                  f"{cfg.yarn_mscale} apart from mscale_all_dim "
                                  f"{cfg.yarn_mscale_all_dim} (cos and sin "
                                  f"scaled) is not implemented")
    families = ("dense", "moe", "vlm", "hybrid", "audio")
    attn_types = ("gqa",) if cfg.family == "hybrid" or cfg.is_encdec \
        else ("gqa", "mla")
    if cfg.family in families and cfg.attn_type in attn_types:
        return
    raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} with "
                              f"attention {cfg.attn_type!r} is no family "
                              f"of the reference's models")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device raises when CUDA is not
    available instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the model runs on device {str(dev)!r} but CUDA "
                           f"is not available; pass device='cpu' to run it "
                           f"on the CPU")
    return dev


def _fits(s: int, max_len: int | None) -> int:
    """`max_len` (default `s`), which must hold a sequence of `s`."""
    max_len = max_len or s
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    return max_len


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _mesh_aware(method):
    """A public method of `Model` run with plain tensors taken as
    replicated (`sharding.implicit_replication`) when the parameters are
    DTensors (`sharding.distribute`); as it is otherwise."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        if self.mesh is None:
            return method(self, *args, **kwargs)
        with shd.implicit_replication():
            return method(self, *args, **kwargs)
    return run


def _attn_params(cfg: ModelConfig, make) -> nn.ParameterDict:
    """An attention's projections (`repro.models.model._init_attn`): GQA,
    or MLA's low-rank ones; MLA without a query LoRA (`q_lora_rank` 0,
    DeepSeek-V2-Lite) takes its query straight from d_model (`wq`)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    if cfg.attn_type == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        query = ({"q_down": make.normal(d, cfg.q_lora_rank),
                  "q_ln": make.ones(cfg.q_lora_rank),
                  "q_up": make.normal(cfg.q_lora_rank, h * qk)}
                 if cfg.q_lora_rank else {"wq": make.normal(d, h * qk)})
        attn = {
            **query,
            "kv_down": make.normal(d, cfg.kv_lora_rank + cfg.qk_rope_dim),
            "kv_ln": make.ones(cfg.kv_lora_rank),
            "k_up": make.normal(cfg.kv_lora_rank, h * cfg.qk_nope_dim),
            "v_up": make.normal(cfg.kv_lora_rank, h * cfg.v_head_dim),
            "wo": make.normal(h * cfg.v_head_dim, d),
        }
    else:
        attn = {"wq": make.normal(d, h * hd), "wk": make.normal(d, hkv * hd),
                "wv": make.normal(d, hkv * hd), "wo": make.normal(h * hd, d)}
    return nn.ParameterDict({k: _param(v) for k, v in attn.items()})


def _swiglu_params(make, d: int, f: int) -> nn.ParameterDict:
    return nn.ParameterDict({"w_gate": _param(make.normal(d, f)),
                             "w_up": _param(make.normal(d, f)),
                             "w_down": _param(make.normal(f, d))})


class Block(nn.Module):
    """One transformer layer: attention (`ln1`, `attn`: GQA, or MLA's
    low-rank projections) and SwiGLU MLP (`ln2`, `mlp`: dense, or with
    `moe` `num_experts` experts of width `expert_d_ff` stacked on a leading
    axis behind a float32 router, and with `moe_shared_d_ff` the shared
    experts as one SwiGLU, `shared_mlp`); with `cross`, an
    encoder-decoder's cross-attention between them (`ln_x`, `xattn`). The
    reference's parameter names and layouts
    (`repro.models.model._init_block`)."""

    def __init__(self, cfg: ModelConfig, make, cross: bool = False,
                 moe: bool = False):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _param(make.ones(d))
        self.attn = _attn_params(cfg, make)
        self.ln2 = _param(make.ones(d))
        if moe:
            e, f = cfg.num_experts, cfg.expert_d_ff
            mlp = {"router": make.normal(d, e, dtype=torch.float32),
                   "w_gate": make.normal(e, d, f),
                   "w_up": make.normal(e, d, f),
                   "w_down": make.normal(e, f, d)}
            self.mlp = nn.ParameterDict({k: _param(v)
                                         for k, v in mlp.items()})
            if cfg.moe_shared_d_ff:
                self.shared_mlp = _swiglu_params(make, d,
                                                 cfg.moe_shared_d_ff)
        else:
            self.mlp = _swiglu_params(make, d, cfg.d_ff)
        if cross:
            self.ln_x = _param(make.ones(d))
            self.xattn = _attn_params(cfg, make)


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
    its own, so no float32 copy of the whole model is ever held. On the
    `meta` device it draws nothing and needs no generator: the tensors
    have shapes and dtypes only (`Model.abstract_params`)."""

    def __init__(self, dtype, device, generator):
        self.dtype, self.device, self.generator = dtype, device, generator

    def normal(self, *shape, std=INIT_STD, dtype=None) -> torch.Tensor:
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype or self.dtype,
                               device=self.device)
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
    """A model of any family of the reference, with random weights drawn
    from a `torch.Generator` seeded with `seed`, on `device` (default
    "cuda"); on "meta" a model of shapes only, which computes shapes
    (the reference's `jax.eval_shape`)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        generator = (None if dev.type == "meta"
                     else torch.Generator(device=dev).manual_seed(seed))
        make = _Maker(_DTYPES[cfg.dtype], dev, generator)
        self.embed = _param(make.normal(cfg.padded_vocab, cfg.d_model))
        self.unembed = _param(make.normal(cfg.padded_vocab, cfg.d_model))
        self.final_ln = _param(make.ones(cfg.d_model))
        if cfg.family in ("ssm", "hybrid"):
            self.layers = nn.ModuleList(MambaBlock(cfg, make)
                                        for _ in range(cfg.num_layers))
        else:
            self.layers = nn.ModuleList(
                Block(cfg, make, cross=cfg.is_encdec,
                      moe=cfg.is_moe_layer(i))
                for i in range(cfg.num_layers))
        if cfg.family == "hybrid":
            self.shared = Block(cfg, make, moe=bool(cfg.num_experts))
        if cfg.is_encdec:
            self.enc_layers = nn.ModuleList(
                Block(cfg, make, moe=bool(cfg.num_experts))
                for _ in range(cfg.encoder_layers))
            self.enc_final_ln = _param(make.ones(cfg.d_model))
        self._inv_freq: dict = {}     # YaRN's frequencies by (device, width)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    @property
    def mesh(self):
        """The `DeviceMesh` the parameters are laid out on
        (`sharding.distribute`), or None."""
        return (self.embed.device_mesh if isinstance(self.embed, DTensor)
                else None)

    def abstract_params(self) -> dict[str, torch.Tensor]:
        """{name: meta tensor} of the parameters' shapes and dtypes, whole
        (global) on a mesh: the reference's `abstract_params`
        (`jax.eval_shape` of `init`). `Model(cfg, device="meta")` holds
        such tensors itself."""
        return {name: torch.empty(p.shape, dtype=p.dtype, device="meta")
                for name, p in self.named_parameters()}

    # ======================== mesh awareness ========================== #
    def _model_axis(self) -> int | None:
        """The size of the mesh's `model` axis, or None without one."""
        mesh = self.mesh
        if mesh is None or "model" not in mesh.mesh_dim_names:
            return None
        return mesh.size(mesh.mesh_dim_names.index("model"))

    def _maybe_seq_parallel(self, h):
        """Megatron-SP (§Perf): pin the residual stream to a
        sequence-sharded layout at layer boundaries, so activations kept
        for the backward pass are S / `model` per device; the tensor-
        parallel all-reduces become reduce-scatter + all-gather pairs. The
        batch stays over (`pod`, `data`) where it divides. `h` as it is
        without `cfg.seq_parallel`, a DTensor or a `model` axis, or when
        that axis does not divide S."""
        model = self._model_axis()
        if (not self.cfg.seq_parallel or not isinstance(h, DTensor)
                or model is None or h.shape[1] % model):
            return h
        return self._lay_out(h, shd.P(self._batch_spec(h), "model", None))

    def _batch_spec(self, t):
        """The batch axes for `t`'s leading dim where they divide it."""
        return shd.dim_spec(self.mesh, t.shape[0], shd.batch_axes(self.mesh))

    def _lay_out(self, t, spec):
        return t.redistribute(self.mesh, shd.placements(spec, self.mesh))

    def _pin_residual(self, h):
        """The residual stream's layout at the entry of each sublayer
        (attention, MLP, Mamba2 block) and of the head, on a mesh with a
        `model` axis: the batch over (`pod`, `data`) where it divides, and
        S over `model` under `cfg.seq_parallel` (`_maybe_seq_parallel`),
        else replicated over `model`, Megatron's tensor-parallel layout.
        GSPMD infers that layout from the weights' shardings; DTensor
        chooses op by op from its inputs' (after the embedding it would
        shard S and gather the attention scores), so the port states it.
        `h` as it is without a mesh or a `model` axis."""
        if not isinstance(h, DTensor) or self._model_axis() is None:
            return h
        if self.cfg.seq_parallel and not h.shape[1] % self._model_axis():
            return self._maybe_seq_parallel(h)
        return self._lay_out(h, shd.P(self._batch_spec(h),
                                      *([None] * (h.dim() - 1))))

    def _kv_heads_shardable(self) -> bool:
        """True when the KV-head count divides the model axis — then the
        baseline head-sharded decode attention is already reshard-free and
        the length-sharded path would only waste replicated-q compute.
        True without a mesh."""
        model = self._model_axis()
        return model is None or self.cfg.num_kv_heads % model == 0

    def _pin_cache(self, arr, kind="kv"):
        """§Perf: pin a decode cache layer (B, S, H, D), or MLA's latent
        (B, S, R), to its canonical layout after the token write: batch
        over (`pod`, `data`), heads over `model` where they divide, else S
        over `model` (the latent: S). `arr` as it is without
        `cfg.pin_cache_sharding`, a DTensor or a `model` axis."""
        if (not self.cfg.pin_cache_sharding or not isinstance(arr, DTensor)
                or self._model_axis() is None):
            return arr
        mesh, b_ax = self.mesh, self._batch_spec(arr)
        if kind == "kv":
            h_ax = shd.dim_spec(mesh, arr.shape[2], "model")
            s_ax = None if h_ax else shd.dim_spec(mesh, arr.shape[1],
                                                  "model")
            spec = shd.P(b_ax, s_ax, h_ax, None)
        else:
            spec = shd.P(b_ax, shd.dim_spec(mesh, arr.shape[1], "model"),
                         None)
        return self._lay_out(arr, spec)

    # ========================= train forward ========================== #
    @_mesh_aware
    def loss(self, batch: dict) -> torch.Tensor:
        """Mean next-token CE (+ MOE_AUX_COEF x the MoE aux loss), the
        reference's train forward. batch keys: tokens (B, S_text) int,
        and for vlm/audio `embeds` (B, frontend_tokens, D); numpy arrays
        or tensors.

        Plain PyTorch under autograd: every attention takes its plain
        version (`use_kernel=False`) and the Mamba2 layers run
        `mamba2.ssd_chunked`, as the reference's loss reaches no Pallas
        kernel (none has a backward). With `cfg.remat` each layer (the
        hybrid: each group, and each Mamba2 layer in it) is recomputed in
        the backward pass (`torch.utils.checkpoint`), as `jax.checkpoint`
        wraps them. Gradients reach the parameters once they require
        them (`model.requires_grad_()`); serving runs under `no_grad`
        either way."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        embeds = batch.get("embeds")
        if embeds is not None:
            embeds = torch.as_tensor(embeds, device=self.device).to(
                self.dtype)
        if cfg.is_encdec:
            if embeds is None:
                raise ValueError(f"{cfg.name}: an encoder-decoder loss needs "
                                 f"the frame embeddings (batch['embeds'])")
            logits, aux = self._encdec_forward(tokens, embeds)
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=self.device)
            return (cross_entropy_loss(logits[:, :-1], tokens[:, 1:],
                                       mask[:, 1:])
                    + MOE_AUX_COEF * aux)
        h = embed(tokens, self.embed)
        n_front = 0
        if cfg.frontend != "none" and embeds is not None:
            h = torch.cat([embeds, h], dim=1)
            n_front = embeds.shape[1]
        s_total = h.shape[1]
        positions = torch.arange(s_total, device=self.device)[None, :]
        h, aux = self._stack_forward(h, positions)
        logits = self._head(h)
        labels_full = shd.per_device(lambda t: F.pad(t, (n_front, 0)),
                                     tokens)
        mask = (positions >= n_front).float().expand(labels_full.shape)
        return (cross_entropy_loss(logits[:, :-1], labels_full[:, 1:],
                                   mask[:, 1:]) + MOE_AUX_COEF * aux)

    def _remat(self, fn):
        """`fn` recomputed in the backward pass under `cfg.remat`."""
        if not self.cfg.remat:
            return fn
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)

    def _block_full(self, h, blk, positions, causal=True):
        """A whole layer over the sequence on the plain path: (h, MoE aux
        loss)."""
        h, _ = self._attn_full(h, blk, positions, False, causal=causal)
        return self._mlp_aux(h, blk)

    def _stack_forward(self, h, positions):
        cfg = self.cfg
        if cfg.family == "hybrid":
            return self._hybrid_forward(h, positions), 0.0
        if cfg.family == "ssm":
            body = self._remat(lambda hh, blk: mamba2.mamba2_block(
                self._pin_residual(hh), blk, cfg))
            for blk in self.layers:
                h = body(h, blk)
            return h, 0.0
        body = self._remat(lambda hh, blk: self._block_full(hh, blk,
                                                            positions))
        aux = 0.0
        for blk in self.layers:
            h, a = body(h, blk)
            aux = aux + a
        return h, aux

    def _hybrid_forward(self, h, positions):
        """Zamba2: each group of `hybrid_period` Mamba2 layers, then the
        single SHARED attention block; the tail's Mamba2 layers last."""
        cfg = self.cfg
        per, g = cfg.hybrid_period, cfg.num_hybrid_groups
        inner = self._remat(lambda hh, blk: mamba2.mamba2_block(
            self._pin_residual(hh), blk, cfg))

        def group(hh, gi):
            for blk in self.layers[gi * per:(gi + 1) * per]:
                hh = inner(hh, blk)
            return self._block_full(hh, self.shared, positions)[0]

        group = self._remat(group)
        for gi in range(g):
            h = group(h, gi)
        for blk in self.layers[g * per:]:
            h = inner(h, blk)
        return h

    def _encdec_forward(self, tokens, embeds):
        """Seamless: bidirectional encoder over the frame embeddings,
        causal decoder with cross-attention. Returns (logits, aux)."""
        cfg = self.cfg
        enc_pos = torch.arange(embeds.shape[1], device=self.device)[None, :]
        enc = self._remat(lambda hh, blk: self._block_full(
            hh, blk, enc_pos, causal=False)[0])
        henc = embeds
        for blk in self.enc_layers:
            henc = enc(henc, blk)
        memory = rms_norm(henc, self.enc_final_ln, cfg.norm_eps)
        h = embed(tokens, self.embed)
        dec_pos = torch.arange(tokens.shape[1], device=self.device)[None, :]
        dec = self._remat(lambda hh, blk: self._dec_block_full(
            hh, blk, dec_pos, memory))
        aux = 0.0
        for blk in self.layers:
            h, a = dec(h, blk)
            aux = aux + a
        return self._head(h), aux

    def _dec_block_full(self, h, blk, positions, memory):
        """A decoder layer over the sequence on the plain path: causal
        self-attention, cross-attention on the memory, the MLP."""
        h, _ = self._attn_full(h, blk, positions, False)
        h = self._cross_attn(h, blk, *self._memory_kv(memory, blk))
        return self._mlp_aux(h, blk)

    # ====================== attention sub-blocks ====================== #
    def _rope(self, x, positions):
        """`apply_rope` at the config's theta, with YaRN's frequencies
        (made once per device and width) where `yarn_factor` is set."""
        cfg = self.cfg
        inv = None
        if cfg.yarn_factor:
            key = (str(x.device), x.shape[-1])
            inv = self._inv_freq.get(key)
            if inv is None:
                inv = self._inv_freq[key] = yarn_frequencies(
                    x.shape[-1], cfg, x.device)
        return apply_rope(x, positions, cfg.rope_theta, inv)

    def _gqa_qkv(self, h, ap, positions):
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        q = shd.split_last(h @ ap["wq"], cfg.num_heads, hd)
        k = shd.split_last(h @ ap["wk"], cfg.num_kv_heads, hd)
        v = shd.split_last(h @ ap["wv"], cfg.num_kv_heads, hd)
        return self._rope(q, positions), self._rope(k, positions), v

    def _mla_q(self, h, ap, positions):
        cfg = self.cfg
        qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
        if cfg.q_lora_rank:
            ql = rms_norm(h @ ap["q_down"], ap["q_ln"], cfg.norm_eps)
            q = ql @ ap["q_up"]
        else:
            q = h @ ap["wq"]
        q = shd.split_last(q, cfg.num_heads, qk_dim)
        q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim],
                                     dim=-1)
        return torch.cat([q_nope, self._rope(q_rope, positions)], dim=-1)

    def _mla_latent(self, h, ap, positions):
        """Compressed KV latent: (B,S,kv_lora + rope). Rope pre-applied."""
        cfg = self.cfg
        lat = h @ ap["kv_down"]
        c_kv, k_rope = torch.split(lat, [cfg.kv_lora_rank, cfg.qk_rope_dim],
                                   dim=-1)
        c_kv = rms_norm(c_kv, ap["kv_ln"], cfg.norm_eps)
        k_rope = self._rope(k_rope[:, :, None, :], positions)[:, :, 0]
        return torch.cat([c_kv, k_rope], dim=-1)

    def _mla_kv_from_latent(self, latent, ap):
        """Expand cached latent to per-head K's nope part and V, (B, S, H,
        qk_nope) and (B, S, H, v), beside K's rope part (B, S, qk_rope):
        the latent's own columns, shared by every head and not copied
        (`attn.whole_key` writes K out whole). On a mesh a length-sharded
        latent stays so: each device expands its own rows with the
        up-projections gathered whole (`rows_times`), K and V
        length-sharded as the latent. That is the reshard GSPMD makes at
        the dry run's shapes: it all-gathers the smaller operand, here the
        weights (2 x 1.3 MB against the latent's 134 MB a device at
        decode_32k)."""
        cfg = self.cfg
        c_kv, k_rope = torch.split(latent,
                                   [cfg.kv_lora_rank, cfg.qk_rope_dim],
                                   dim=-1)
        k_nope, v = shd.rows_times(c_kv, ap["k_up"], ap["v_up"])
        k_nope = shd.split_last(k_nope, cfg.num_heads, cfg.qk_nope_dim)
        v = shd.split_last(v, cfg.num_heads, cfg.v_head_dim)
        return k_nope, v, k_rope

    def _mla_scale(self) -> float:
        """1 / sqrt(q/k head dim), times YaRN's mscale(mscale_all_dim)
        squared where `yarn_factor` and `yarn_mscale_all_dim` are set (HF
        `DeepseekV2Attention.softmax_scale`)."""
        cfg = self.cfg
        scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
        if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
            scale *= yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
        return scale

    def _attn_full(self, h, blk, positions, use_kernel, causal=True):
        """The attention half of a layer over a whole sequence, causal or
        (an encoder's) bidirectional; returns (h, what the decode cache
        keeps: (k, v), or MLA's latent)."""
        cfg = self.cfg
        h = self._pin_residual(h)
        hn = rms_norm(h, blk.ln1, cfg.norm_eps)
        if cfg.attn_type == "mla":
            q = self._mla_q(hn, blk.attn, positions)
            kept = self._mla_latent(hn, blk.attn, positions)
            k_nope, v, k_rope = self._mla_kv_from_latent(kept, blk.attn)
            k = attn.whole_key(k_nope, k_rope)
            scale = self._mla_scale()
        else:
            q, k, v = self._gqa_qkv(hn, blk.attn, positions)
            kept, scale = (k, v), None
        o = attn.self_attention(q, k, v, causal=causal,
                                window=cfg.sliding_window, scale=scale,
                                chunk=cfg.attn_chunk, use_kernel=use_kernel)
        o = shd.merge_last(o)
        return h + o @ blk.attn["wo"], kept

    def _mlp(self, h, blk):
        return self._mlp_aux(h, blk)[0]

    def _mlp_aux(self, h, blk):
        """The MLP half of a layer: (h, the MoE aux loss, or 0.0)."""
        h = self._pin_residual(h)
        hn = rms_norm(h, blk.ln2, self.cfg.norm_eps)
        if "router" in blk.mlp:
            y, aux = moe.moe_ffn_sharded(hn, blk.mlp, self.cfg,
                                         getattr(blk, "shared_mlp", None))
            return h + y, aux
        return h + swiglu(hn, blk.mlp["w_gate"], blk.mlp["w_up"],
                          blk.mlp["w_down"]), 0.0

    def _cross_attn(self, h, blk, xk, xv):
        """An encoder-decoder layer's cross-attention against the encoder
        memory's keys and values (B, S_mem, Hkv, D): q from the decoder,
        no rope, no mask (`repro.models.model._gqa_qkv_mem`); plain
        PyTorch, as the reference's jnp."""
        cfg = self.cfg
        h = self._pin_residual(h)
        hn = rms_norm(h, blk.ln_x, cfg.norm_eps)
        q = shd.split_last(hn @ blk.xattn["wq"], cfg.num_heads,
                           cfg.resolved_head_dim)
        o = attn.cross_attention(q, xk, xv)
        return h + shd.merge_last(o) @ blk.xattn["wo"]

    def _memory_kv(self, memory, blk):
        """The encoder memory's keys and values for one decoder layer's
        cross-attention (B, S_mem, Hkv, D), kept in the decode cache."""
        cfg = self.cfg
        heads = (cfg.num_kv_heads, cfg.resolved_head_dim)
        return (shd.split_last(memory @ blk.xattn["wk"], *heads),
                shd.split_last(memory @ blk.xattn["wv"], *heads))

    # ========================= serving: prefill ======================= #
    @torch.no_grad()
    @_mesh_aware
    def prefill(self, tokens: torch.Tensor, max_len: int | None = None, *,
                embeds: torch.Tensor | None = None, use_kernel: bool = True):
        """Process the full prompt (B, S) int tokens; returns (last-token
        logits (B, 1, padded_vocab), cache). Cache arrays are allocated at
        `max_len` (default: the prompt's length); an ssm cache does not
        grow with the sequence and ignores it. `embeds` (B, S_f, D): a
        vlm's frontend embeddings, put before the tokens (they count in
        the positions and in `max_len`; without them the model reads
        text only), or an encoder-decoder's frame embeddings, which it
        needs; other families ignore them, as the reference does."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        if embeds is not None:
            embeds = torch.as_tensor(embeds, device=self.device).to(
                self.dtype)
        if cfg.family == "ssm":
            return self._prefill_ssm(tokens, use_kernel)
        if cfg.family == "hybrid":
            return self._prefill_hybrid(tokens, max_len, use_kernel)
        if cfg.is_encdec:
            return self._prefill_encdec(tokens, embeds, max_len, use_kernel)
        h = embed(tokens, self.embed)
        if cfg.frontend != "none" and embeds is not None:
            h = torch.cat([embeds, h], dim=1)
        b, s, _ = h.shape
        max_len = _fits(s, max_len)
        positions = torch.arange(s, device=self.device)[None, :]
        cache = self.empty_cache(b, max_len)
        ring = bool(cfg.swa_ring and cfg.sliding_window)
        for i, blk in enumerate(self.layers):
            h, kept = self._attn_full(h, blk, positions, use_kernel)
            h = self._mlp(h, blk)
            if cfg.attn_type == "mla":
                attn.write_prefix(cache["latent"][i], kept)
            elif ring:
                cache["k"][i] = self._to_ring(kept[0], s)
                cache["v"][i] = self._to_ring(kept[1], s)
            else:
                attn.write_prefix(cache["k"][i], kept[0])
                attn.write_prefix(cache["v"][i], kept[1])
        return self._head(h[:, -1:]), self._with_pos(cache, s)

    def _head(self, h):
        """Logits of the last hidden states (B, S, D)."""
        h = self._pin_residual(h)
        return unembed(rms_norm(h, self.final_ln, self.cfg.norm_eps),
                       self.unembed, self.cfg)

    def _with_pos(self, cache, s):
        cache["pos"] = torch.tensor(s, dtype=torch.int32, device=self.device)
        return cache

    def empty_cache(self, batch: int, max_len: int,
                    memory_len: int | None = None) -> dict:
        """The zeroed decode cache of this model for `batch` sequences of
        up to `max_len` tokens, without "pos", in the layout of its family
        (module docstring): K and V (the `swa_ring` ring holds the
        window), MLA's latent, the ssm's conv history and state (which
        ignore `max_len`), the hybrid's groups, or the encoder-decoder's
        self and cross caches, the latter over `memory_len` encoder
        frames (default: the config's `frontend_tokens`). On a mesh, laid
        out on it by `sharding.cache_specs`."""
        cache = self._zero_cache(batch, max_len, memory_len)
        mesh = self.mesh
        if mesh is None:
            return cache
        return shd.distribute(cache, mesh,
                              shd.cache_specs(self.cfg, cache, mesh))

    def _zero_cache(self, batch, max_len, memory_len):
        cfg = self.cfg
        f32 = torch.float32

        def zeros(*shape, dtype=None):
            return torch.zeros(shape, dtype=dtype or self.dtype,
                               device=self.device)

        conv = (cfg.ssm_conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state)
        state = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        if cfg.family == "ssm":
            return {"conv": zeros(cfg.num_layers, batch, *conv),
                    "state": zeros(cfg.num_layers, batch, *state, dtype=f32)}
        kv = (cfg.num_kv_heads, cfg.resolved_head_dim)
        if cfg.family == "hybrid":
            g, per = cfg.num_hybrid_groups, cfg.hybrid_period
            rem = cfg.hybrid_remainder
            tail = {"conv": zeros(rem, batch, *conv),
                    "state": zeros(rem, batch, *state, dtype=f32)} \
                if rem else None
            return {"ssm": {"conv": zeros(g, per, batch, *conv),
                            "state": zeros(g, per, batch, *state,
                                           dtype=f32)},
                    "attn": {"k": zeros(g, batch, max_len, *kv),
                             "v": zeros(g, batch, max_len, *kv)},
                    "tail": tail}
        if cfg.attn_type == "mla":
            return {"latent": zeros(cfg.num_layers, batch, max_len,
                                    cfg.kv_lora_rank + cfg.qk_rope_dim)}
        ring = bool(cfg.swa_ring and cfg.sliding_window)
        rows = cfg.sliding_window if ring else max_len
        cache = {"k": zeros(cfg.num_layers, batch, rows, *kv),
                 "v": zeros(cfg.num_layers, batch, rows, *kv)}
        if cfg.is_encdec:
            mem = memory_len or cfg.frontend_tokens
            cache["xk"] = zeros(cfg.num_layers, batch, mem, *kv)
            cache["xv"] = zeros(cfg.num_layers, batch, mem, *kv)
        return cache

    def cache_batch_dim(self, key: str) -> int:
        """The batch axis of the cache's tensors under `key`, a key of
        `empty_cache`'s dict: 2 under the hybrid's "ssm" (groups, layers of
        a group, B, ...), else 1 (after the layers or the groups)."""
        return 2 if self.cfg.family == "hybrid" and key == "ssm" else 1

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
        h = embed(tokens, self.embed)
        cache = self.empty_cache(tokens.shape[0], 0)
        for i, blk in enumerate(self.layers):
            h, cache["conv"][i], cache["state"][i] = \
                self._mamba_block_with_state(h, blk, use_kernel)
        return self._head(h[:, -1:]), self._with_pos(cache, tokens.shape[1])

    def _hybrid_groups(self, cache):
        """The hybrid's layers in order, as (layers, conv, state, k, v):
        each group of `hybrid_period` Mamba2 layers with its slices of the
        cache's "ssm" and its shared block's K/V cache, then the tail's
        layers with "tail" and no K/V (the shared block does not follow
        them)."""
        cfg = self.cfg
        per, g = cfg.hybrid_period, cfg.num_hybrid_groups
        ssm, kv = cache["ssm"], cache["attn"]
        out = [(self.layers[gi * per:(gi + 1) * per], ssm["conv"][gi],
                ssm["state"][gi], kv["k"][gi], kv["v"][gi])
               for gi in range(g)]
        if cfg.hybrid_remainder:
            out.append((self.layers[g * per:], cache["tail"]["conv"],
                        cache["tail"]["state"], None, None))
        return out

    def _prefill_hybrid(self, tokens, max_len, use_kernel):
        """Zamba2: each group of `hybrid_period` Mamba2 layers (their
        scans in the ssd_scan kernel on CUDA), then the shared attention
        block over the whole sequence, causal (the flash_attention
        kernel); the tail's Mamba2 layers last."""
        b, s = tokens.shape
        max_len = _fits(s, max_len)
        h = embed(tokens, self.embed)
        positions = torch.arange(s, device=self.device)[None, :]
        cache = self.empty_cache(b, max_len)
        for layers, conv, state, ck, cv in self._hybrid_groups(cache):
            for j, blk in enumerate(layers):
                h, conv[j], state[j] = self._mamba_block_with_state(
                    h, blk, use_kernel)
            if ck is not None:
                h, (k, v) = self._attn_full(h, self.shared, positions,
                                            use_kernel)
                h = self._mlp(h, self.shared)
                attn.write_prefix(ck, k)
                attn.write_prefix(cv, v)
        return self._head(h[:, -1:]), self._with_pos(cache, s)

    def _prefill_encdec(self, tokens, embeds, max_len, use_kernel):
        """Seamless: the encoder's blocks over the frame embeddings,
        bidirectional (the flash_attention kernel, non-causal), then
        `enc_final_ln`; the decoder's blocks over the tokens: causal
        self-attention (the kernel; the reference gives it no window),
        cross-attention on the memory, the MLP."""
        if embeds is None:
            raise ValueError(f"{self.cfg.name}: an encoder-decoder prefill "
                             f"needs the frame embeddings (embeds=)")
        cfg = self.cfg
        enc_pos = torch.arange(embeds.shape[1], device=self.device)[None, :]
        henc = embeds
        for blk in self.enc_layers:
            henc, _ = self._attn_full(henc, blk, enc_pos, use_kernel,
                                      causal=False)
            henc = self._mlp(henc, blk)
        memory = rms_norm(henc, self.enc_final_ln, cfg.norm_eps)
        b, s = tokens.shape
        max_len = _fits(s, max_len)
        h = embed(tokens, self.embed)
        positions = torch.arange(s, device=self.device)[None, :]
        cache = self.empty_cache(b, max_len, memory.shape[1])
        for i, blk in enumerate(self.layers):
            hn = rms_norm(h, blk.ln1, cfg.norm_eps)
            q, k, v = self._gqa_qkv(hn, blk.attn, positions)
            o = attn.self_attention(q, k, v, causal=True,
                                    use_kernel=use_kernel)
            h = h + shd.merge_last(o) @ blk.attn["wo"]
            xk, xv = self._memory_kv(memory, blk)
            h = self._mlp(self._cross_attn(h, blk, xk, xv), blk)
            attn.write_prefix(cache["k"][i], k)
            attn.write_prefix(cache["v"][i], v)
            cache["xk"][i] = xk
            cache["xv"][i] = xv
        return self._head(h[:, -1:]), self._with_pos(cache, s)

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
        h = self._pin_residual(h)
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
    @_mesh_aware
    def decode_step(self, cache: dict, token: torch.Tensor, *,
                    use_kernel: bool = True):
        """One decode step. token: (B, 1) int. Returns (logits (B, 1,
        padded_vocab), cache), the cache updated in place with pos + 1.
        The Mamba2 layers' step launches no kernel: `use_kernel` applies
        to the attention."""
        cfg = self.cfg
        pos = torch.as_tensor(cache["pos"], device=self.device).to(
            torch.int32)
        token = torch.as_tensor(token, device=self.device)
        h = embed(token, self.embed)
        positions = pos.reshape(1, 1) if pos.dim() == 0 else pos[:, None]
        if cfg.family == "ssm":
            for i, blk in enumerate(self.layers):
                h = self._mamba_decode(h, blk, cache["conv"], cache["state"],
                                       i)
        elif cfg.family == "hybrid":
            for layers, conv, state, ck, cv in self._hybrid_groups(cache):
                for j, blk in enumerate(layers):
                    h = self._mamba_decode(h, blk, conv, state, j)
                if ck is not None:
                    h = self._gqa_decode_block(h, self.shared, ck, cv, pos,
                                               positions, use_kernel)
        elif cfg.is_encdec:
            for i, blk in enumerate(self.layers):
                h = self._encdec_decode_block(h, blk, cache, i, pos,
                                              positions, use_kernel)
        else:
            for i, blk in enumerate(self.layers):
                if cfg.attn_type == "mla":
                    h = self._mla_decode_block(h, blk, cache["latent"][i],
                                               pos, positions, use_kernel)
                else:
                    h = self._gqa_decode_block(h, blk, cache["k"][i],
                                               cache["v"][i], pos, positions,
                                               use_kernel)
        new = {key: t for key, t in cache.items() if key != "pos"}
        return self._head(h), {**new, "pos": pos + 1}

    def _mamba_decode(self, h, blk, conv, state, i):
        """One Mamba2 layer's one-token block (plain, as in the
        reference), its conv history and state written back in place at
        index `i` of `conv` and `state`."""
        h, new = mamba2.mamba2_block_decode(
            self._pin_residual(h), blk, {"conv": conv[i], "state": state[i]},
            self.cfg)
        conv[i] = new["conv"]
        state[i] = new["state"]
        return h

    def _encdec_decode_block(self, h, blk, cache, i, pos, positions,
                             use_kernel):
        """Seamless's decoder layer `i` for one token: self-attention
        written into the cache and attended in the decode_attention
        kernel (no window, as in the reference), cross-attention against
        the cached memory keys and values, the MLP."""
        cfg = self.cfg
        h = self._pin_residual(h)
        hn = rms_norm(h, blk.ln1, cfg.norm_eps)
        q, k, v = self._gqa_qkv(hn, blk.attn, positions)
        ck, cv = attn.cache_update(cache["k"][i], cache["v"][i], k, v, pos)
        o = self._decode_attention(q, ck, cv, pos + 1, 0, use_kernel)
        h = h + shd.merge_last(o) @ blk.attn["wo"]
        return self._mlp(self._cross_attn(h, blk, cache["xk"][i],
                                          cache["xv"][i]), blk)

    def _gqa_decode_block(self, h, blk, ck, cv, pos, positions, use_kernel):
        cfg = self.cfg
        h = self._pin_residual(h)
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
        o = self._decode_attention(q, ck, cv, pos_eff, window, use_kernel)
        o = shd.merge_last(o)
        h = h + o @ blk.attn["wo"]
        return self._mlp(h, blk)

    def _decode_attention(self, q, ck, cv, pos, window, use_kernel):
        """The decode attention of a GQA layer: with `pin_cache_sharding`
        on a mesh whose `model` axis the KV heads do not divide, the
        caches pinned to their length-sharded layout and attended there
        (`decode_attention_length_sharded`), as the reference; else
        `decode_attention`."""
        if self.cfg.pin_cache_sharding and not self._kv_heads_shardable():
            ck, cv = self._pin_cache(ck), self._pin_cache(cv)
            return attn.decode_attention_length_sharded(
                q, ck, cv, pos, window=window, use_kernel=use_kernel)
        return attn.decode_attention(q, ck, cv, pos, window=window,
                                     use_kernel=use_kernel)

    def _mla_decode_block(self, h, blk, latent_cache, pos, positions,
                          use_kernel):
        """MLA decode: write this token's latent into the cache in place
        at `pos`, expand K's nope part and V from the whole latent cache
        (the reference's naive materialization) and attend with pos + 1
        valid rows, K's rope part read from the latent in place; or, with
        `mla_absorb`, attend against the latent itself."""
        cfg = self.cfg
        h = self._pin_residual(h)
        hn = rms_norm(h, blk.ln1, cfg.norm_eps)
        q = self._mla_q(hn, blk.attn, positions)
        lat_new = self._mla_latent(hn, blk.attn, positions)
        attn.write_row(latent_cache, lat_new, pos)
        latent_cache = self._pin_cache(latent_cache, kind="latent")
        scale = self._mla_scale()
        if cfg.mla_absorb:
            o = self._mla_absorbed_attention(q, latent_cache, blk.attn, pos,
                                             scale)
        else:
            k_nope, v, k_rope = self._mla_kv_from_latent(latent_cache,
                                                         blk.attn)
            o = attn.decode_attention(q, k_nope, v, pos + 1, scale=scale,
                                      use_kernel=use_kernel, k_rope=k_rope)
        o = shd.merge_last(o)
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
        k_up = shd.split_last(ap["k_up"], heads, cfg.qk_nope_dim)
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
        v_up = shd.split_last(ap["v_up"], heads, cfg.v_head_dim)
        o = torch.einsum("bhr,rhd->bhd", out_lat, v_up.float())
        return o[:, None].to(q.dtype)



def _tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 from ml_dtypes included) as a CPU tensor; a
    tensor as it is."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(prefix: str, tree: dict, index: int | None = None) -> dict:
    """One layer of the reference's tree (entry `index` of each stacked
    leaf, or the leaves themselves) as state-dict entries under `prefix`:
    a leaf `ln1` as `<prefix>ln1`, a group `attn` as `<prefix>attn.wq`."""
    out = {}
    for name, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(f"{prefix}{name}.", val, index))
        else:
            out[f"{prefix}{name}"] = _tensor(val if index is None
                                             else val[index])
    return out


def params_from_jax(cfg: ModelConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The reference's stacked parameter dict (`repro.models.Model.init`,
    its leaves as numpy arrays or tensors) as a state dict of the port's
    `Model`:
    `Model(cfg, device=...).load_state_dict(params_from_jax(cfg, tree))`
    makes the port compute what the reference computes. Per-layer leaves
    are stacked on a leading axis (`layers`, `enc_layers`); the hybrid's
    `shared` block is one layer's leaves."""
    check_supported(cfg)
    state = {}
    for name in ("embed", "unembed", "final_ln", "enc_final_ln"):
        if name in tree:
            state[name] = _tensor(tree[name])
    for group, count in (("layers", cfg.num_layers),
                         ("enc_layers", cfg.encoder_layers)):
        for i in range(count if group in tree else 0):
            state.update(_flatten(f"{group}.{i}.", tree[group], i))
    if "shared" in tree:
        state.update(_flatten("shared.", tree["shared"]))
    return state


def params_to_jax(cfg: ModelConfig, state: dict) -> dict:
    """The inverse of `params_from_jax`: a state dict of the port's `Model`
    (or anything keyed by its names, as the optimizer's moments) as the
    reference's nested parameter tree, each `layers.<i>.` and
    `enc_layers.<i>.` entry stacked on a leading layer axis, the rest as
    they are. The leaves are new CPU tensors (copies); each stacked leaf
    is stacked on its device and then copied, so a card holds one
    stacked leaf at a time beside the model."""
    check_supported(cfg)
    tree: dict = {}
    stacked: dict = {}
    for name, t in state.items():
        group, _, rest = name.partition(".")
        if group in ("layers", "enc_layers"):
            i, _, rest = rest.partition(".")
            stacked.setdefault((group, rest), {})[int(i)] = t
        else:
            _put(tree, name.split("."), t.detach().to("cpu", copy=True))
    counts = {"layers": cfg.num_layers, "enc_layers": cfg.encoder_layers}
    for (group, rest), by_index in stacked.items():
        if sorted(by_index) != list(range(counts[group])):
            raise ValueError(f"{cfg.name}: {group}.<i>.{rest} has layers "
                             f"{sorted(by_index)}, not {counts[group]}")
        _put(tree.setdefault(group, {}), rest.split("."), torch.stack(
            [by_index[i].detach() for i in range(counts[group])]).cpu())
    return tree


def _put(tree: dict, path: list[str], leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf
