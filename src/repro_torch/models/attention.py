"""Attention cores: GQA (full / sliding-window / causal), decode against
a KV cache, and cross-attention (the counterpart of
`repro.models.attention`).

`self_attention` and `decode_attention`, which the model calls, go
through the kernels' wrappers: on CUDA tensors the hand-written prefill
kernel (`kernels/flash_attention`) and decode kernel
(`kernels/decode_attention`), on CPU tensors or with `use_kernel=False`
their plain versions (`ref.py`, which `self_attention` calls itself for
`use_kernel=False`). Both keep the scores and the softmax in
float32, as the reference's Pallas kernels and oracles do.

The other functions are the reference's jnp formulations in PyTorch, in
the same dtypes (scores in the input dtype, softmax in float32,
probabilities rounded back to the input dtype before the PV product), so
at bfloat16 they round where the reference's model path rounds.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import decode_bhd
from repro_torch.kernels.flash_attention.ops import attention_bhsd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, H, D) by group broadcast."""
    hkv = k.shape[2]
    if hkv == num_heads:
        return k
    return k.repeat_interleave(num_heads // hkv, dim=2)


def causal_mask(q_len: int, kv_len: int, window: int = 0,
                q_offset: int = 0, device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean mask: True = attend.

    q position i (global i+q_offset) attends kv position j iff
    j <= i+q_offset and (window == 0 or j > i+q_offset-window).
    """
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    m = kj <= qi
    if window:
        m &= kj > qi - window
    return m


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor | None = None,
              scale: float | None = None) -> torch.Tensor:
    """Batched multi-head attention.

    q: (B, Sq, H, D), k/v: (B, Skv, Hkv, D) with H % Hkv == 0.
    mask: broadcastable to (B, H, Sq, Skv), True = attend.
    """
    h = q.shape[2]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def self_attention(q, k, v, *, causal: bool = True, window: int = 0,
                   q_offset: int = 0, scale: float | None = None,
                   chunk: int = 0, use_kernel: bool = True):
    """Self-attention over a full sequence (train / prefill path), in the
    prefill kernel on CUDA tensors, else in its plain version; with
    `use_kernel=False` the plain version on any device, at head dims the
    kernel has no instance for too (the training forward's). `chunk` is
    the reference's switch to its online-softmax blocked formulation
    (`chunked_self_attention`); the kernel is that formulation, and both
    give the exact result, so it changes nothing here, but for one
    thing: as in the reference, only the blocked formulation masks a
    bidirectional (`causal=False`) attention by `window`."""
    if not causal and not (chunk and chunk < k.shape[1]):
        window = 0
    if not use_kernel:
        out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window, scale=scale,
                                  q_offset=q_offset)
        return out.transpose(1, 2)
    return attention_bhsd(q, k, v, causal=causal, window=window,
                          scale=scale, q_offset=q_offset,
                          use_kernel=use_kernel)


def chunked_self_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                           scale=None, chunk=1024):
    """Flash-style attention in plain PyTorch: a loop over KV chunks with
    a running (m, l, acc) online softmax in float32, so the (Sq, Skv)
    score matrix is never materialized. Exact (same fp32 math)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    dv = v.shape[-1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scale = scale if scale is not None else d ** -0.5
    q32 = q.float()
    q_pos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    for start in range(0, skv, chunk):
        kb = k[:, start:start + chunk].float()
        vb = v[:, start:start + chunk].float()
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb) * scale
        k_pos = start + torch.arange(kb.shape[1], device=q.device)
        bound = q_pos[:, None] if causal else torch.full(
            (sq, 1), skv, device=q.device)
        mask = k_pos[None, :] <= bound
        if window:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                    vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, window: int = 0,
                     scale: float | None = None,
                     use_kernel: bool = True) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: (B, 1, H, D); k_cache/v_cache: (B, S_max, Hkv, D); pos: () or (B,)
    int32 — number of valid cache entries *including* the current token
    (the caller writes the new k/v at index pos-1 before calling).
    A vector pos supports continuous batching (per-slot lengths). Runs
    in the decode kernel on CUDA tensors, else in its plain version.
    """
    return decode_bhd(q[:, 0], k_cache, v_cache, pos, window=window,
                      scale=scale, use_kernel=use_kernel)[:, None]


def decode_mask(s_max: int, pos, window: int = 0,
                device=None) -> torch.Tensor:
    """The reference's decode mask: cache index i is visible iff
    i < pos and (window == 0 or i >= pos - window); broadcastable to
    (B, H, 1, S) for a () or (B,) pos."""
    pos = torch.as_tensor(pos, device=device)
    idx = torch.arange(s_max, device=device)[None, None, None, :]
    p = pos if pos.dim() == 0 else pos[:, None, None, None]
    valid = idx < p
    if window:
        valid &= idx >= p - window
    return valid


def cache_update(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pos):
    """Write one token's k/v at index `pos` (scalar, or (B,) per-slot for
    continuous batching). cache (B, S, Hkv, D), new (B, 1, Hkv, D).

    Unlike the reference, which returns new arrays, this writes into the
    caches in place (a decode step would otherwise copy the whole cache)
    and returns them. `pos` must lie inside the cache: the reference's
    scalar path clamps an index past the end, and its per-slot path drops
    the write.
    """
    write_row(k_cache, k_new, pos)
    write_row(v_cache, v_new, pos)
    return k_cache, v_cache


def write_row(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write one token's row `new` (B, 1, ...) into `cache` (B, S, ...) in
    place at index `pos` (scalar, or (B,) per slot), in the cache's dtype:
    `cache_update`'s write of K or V, and MLA's of its latent."""
    new = new.to(cache.dtype)
    pos = torch.as_tensor(pos, device=cache.device).long()
    if pos.dim() == 0:
        cache.index_copy_(1, pos.reshape(1), new)
    else:
        cache[torch.arange(cache.shape[0], device=cache.device), pos] = \
            new[:, 0]


def cross_attention(q: torch.Tensor, k_mem: torch.Tensor,
                    v_mem: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Encoder-decoder cross attention (no mask: full encoder memory)."""
    return attention(q, k_mem, v_mem, None, scale)


def decode_attention_length_sharded(q, k_cache, v_cache, pos, window=0,
                                    scale=None, use_kernel=True):
    """The reference keeps a length-sharded cache layout across a device
    mesh; on one GPU there is no mesh, and like the reference without one
    this is `decode_attention`."""
    return decode_attention(q, k_cache, v_cache, pos, window, scale,
                            use_kernel)
