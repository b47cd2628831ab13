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

import functools
import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed import sharding as shd
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


def _kv_heads_of(k, first: int, count: int, group: int):
    """The KV heads (dim 2) that query heads first .. first + count - 1
    read, with `group` query heads to a KV head, as a GQA layout of their
    own: a slice where the query heads cover whole groups or lie in one,
    else one KV head per query head."""
    if count % group == 0:
        return k[:, :, first // group:(first + count) // group]
    if first // group == (first + count - 1) // group:
        return k[:, :, first // group:first // group + 1]
    idx = torch.div(torch.arange(first, first + count, device=k.device),
                    group, rounding_mode="floor")
    return k.index_select(2, idx)


def _on_local_heads(fn, q, k, v, pos=None):
    """`fn(q, k, v[, pos])`, an attention over (B, S, H, D) queries and
    (B, S, Hkv, D) keys and values (a (B,) or () `pos` with them), run on
    each device's own batch rows and query heads when q is a DTensor
    (`local_map`): the batch over (`pod`, `data`) and the query heads over
    `model` where they divide, each device's keys and values the KV heads
    its query heads read, whole along S. Attention is independent per
    (row, head), so this is Megatron's tensor-parallel attention, with no
    collective inside; a length-sharded cache is gathered first (the
    baseline's reshard; `decode_attention_length_sharded` avoids it).
    Plain tensors go to `fn` as they are."""
    if not isinstance(q, DTensor):
        return fn(q, k, v) if pos is None else fn(q, k, v, pos)
    mesh = q.device_mesh
    heads, group = q.shape[2], q.shape[2] // k.shape[2]
    bax, model = shd.head_layout(mesh, q.shape[0], heads)
    split = mesh.size(model) if model is not None else 1

    def layout(heads_split: bool):
        return tuple(Shard(0) if i in bax else Shard(2)
                     if heads_split and i == model else Replicate()
                     for i in range(mesh.ndim))

    def local(ql, kl, vl, *rest):
        if split > 1:
            first = mesh.get_local_rank(model) * (heads // split)
            kl = _kv_heads_of(kl, first, heads // split, group)
            vl = _kv_heads_of(vl, first, heads // split, group)
        return fn(ql, kl, vl, *rest)

    args, placements = [q, k, v], [layout(True), layout(False),
                                   layout(False)]
    if pos is not None:
        pos = torch.as_tensor(pos, device=q.device)
        if not isinstance(pos, DTensor):
            pos = DTensor.from_local(pos, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
        args.append(pos)
        placements.append(layout(False) if pos.dim() else
                          (Replicate(),) * mesh.ndim)
    # each device reads only its query heads' KV heads: the keys' and
    # values' gradients are pending sums over a `model` axis that splits q
    kv_grad = tuple(Partial() if split > 1 and i == model else p
                    for i, p in enumerate(layout(False)))
    grads = [placements[0], kv_grad, kv_grad, *placements[3:]]
    return local_map(local, out_placements=(layout(True),),
                     in_placements=tuple(placements),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


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
    return _on_local_heads(functools.partial(
        _self_attention, causal=causal, window=window, scale=scale,
        q_offset=q_offset, use_kernel=use_kernel), q, k, v)


def _self_attention(q, k, v, *, causal, window, scale, q_offset,
                    use_kernel):
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


def whole_key(k_nope: torch.Tensor, k_rope: torch.Tensor) -> torch.Tensor:
    """MLA's K (B, S, H, Dn + Dr) written out whole from its two parts:
    each head's `k_nope` (B, S, H, Dn) beside `k_rope` (B, S, Dr), the
    rope part that all heads share."""
    b, s, h, _ = k_nope.shape
    return torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, k_rope.shape[-1])], dim=-1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, window: int = 0,
                     scale: float | None = None,
                     use_kernel: bool = True,
                     k_rope: torch.Tensor | None = None) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: (B, 1, H, D); k_cache/v_cache: (B, S_max, Hkv, D); pos: () or (B,)
    int32 — number of valid cache entries *including* the current token
    (the caller writes the new k/v at index pos-1 before calling).
    A vector pos supports continuous batching (per-slot lengths). Runs
    in the decode kernel on CUDA tensors, else in its plain version; on
    DTensors per device (`_on_local_heads`).

    `k_rope` (B, S_max, Dr): K's last Dr columns, shared by every head
    (MLA's rope part, a view of the latent cache); k_cache then holds the
    first D - Dr. The kernel reads it in place; on DTensors K is made
    whole first (`whole_key`).
    """
    if k_rope is not None and isinstance(q, DTensor):
        k_cache, k_rope = whole_key(k_cache, k_rope), None

    def run(q, k_cache, v_cache, pos):
        return decode_bhd(q[:, 0], k_cache, v_cache, pos, window=window,
                          scale=scale, use_kernel=use_kernel,
                          k_rope=k_rope)[:, None]
    return _on_local_heads(run, q, k_cache, v_cache, pos)


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
    `cache_update`'s write of K or V, and MLA's of its latent. On a
    DTensor cache each rank writes its own shard (`_write_sharded`)."""
    if isinstance(cache, DTensor):
        _write_sharded(cache, new, pos=pos)
        return
    new = new.to(cache.dtype)
    pos = torch.as_tensor(pos, device=cache.device).long()
    if pos.dim() == 0:
        cache.index_copy_(1, pos.reshape(1), new)
    else:
        cache[torch.arange(cache.shape[0], device=cache.device), pos] = \
            new[:, 0]


def write_prefix(cache: torch.Tensor, new: torch.Tensor) -> None:
    """Write a prompt's rows `new` (B, s, ...) into rows 0 to s - 1 of
    `cache` (B, S, ...) in place, as a prefill fills its cache; on a
    DTensor cache each rank writes its own shard."""
    if isinstance(cache, DTensor):
        _write_sharded(cache, new)
    else:
        cache[:, :new.shape[1]] = new


def shard_offset(t: DTensor, dim: int) -> tuple[int, int]:
    """(first index, count) along `dim` of the shard of DTensor `t` that
    this rank holds: DTensor splits a dim over its mesh dims in mesh order,
    evenly (the sharding rules shard only dims their axes divide)."""
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    index = 0
    for i, placement in enumerate(t.placements):
        if isinstance(placement, Shard) and placement.dim == dim:
            index = index * mesh.size(i) + coord[i]
    count = t.to_local().shape[dim]
    return index * count, count


def _write_sharded(cache: DTensor, new, pos=None) -> None:
    """`write_prefix` (pos None) or `write_row` on a DTensor cache (B, S,
    ...): `new` is laid out as the cache but whole along S, then each
    rank writes the rows of its shard of S into its local tensor. A row
    at `pos` outside the shard writes its old value back (pos stays on
    the device: no rank reads it)."""
    mesh = cache.device_mesh
    want = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in cache.placements]
    if isinstance(new, DTensor):
        new = new.redistribute(mesh, want)
    else:
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False).redistribute(mesh, want)
    local, new = cache.to_local(), new.to_local().to(cache.dtype)
    first, count = shard_offset(cache, 1)
    if pos is None:
        lo, hi = max(first, 0), min(first + count, new.shape[1])
        if lo < hi:
            local[:, lo - first:hi - first] = new[:, lo:hi]
        return
    if isinstance(pos, DTensor):
        pos = pos.full_tensor()
    pos = torch.as_tensor(pos, device=local.device).long()
    if pos.dim():
        b_first, b_count = shard_offset(cache, 0)
        pos = pos[b_first:b_first + b_count]
    if count == cache.shape[1]:
        write_row(local, new, pos)
        return
    rel = pos - first
    inside = (rel >= 0) & (rel < count)
    rel = rel.clamp(0, count - 1)
    if rel.dim() == 0:
        idx = rel.reshape(1)
        local.index_copy_(1, idx, torch.where(inside, new,
                                              local.index_select(1, idx)))
    else:
        rows = torch.arange(local.shape[0], device=local.device)
        keep = inside.reshape(-1, *([1] * (local.dim() - 2)))
        local[rows, rel] = torch.where(keep, new[:, 0], local[rows, rel])


def cross_attention(q: torch.Tensor, k_mem: torch.Tensor,
                    v_mem: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Encoder-decoder cross attention (no mask: full encoder memory);
    on DTensors per device (`_on_local_heads`)."""
    return _on_local_heads(lambda q, k, v: attention(q, k, v, None, scale),
                           q, k_mem, v_mem)


def decode_attention_length_sharded(q, k_cache, v_cache, pos, window=0,
                                    scale=None, use_kernel=True):
    """Flash-decoding-style decode attention that STAYS in the cache's
    length-sharded layout (S -> `model`) instead of gathering the cache
    every layer (the reference's §Perf path).

    On DTensors over a mesh with a `model` axis that divides S: each device
    takes the whole query (one token; recomputing it is free) against its
    own rows of S (`local_map`), its batch rows over (`pod`, `data`) where
    they divide; the softmax's max and sum and the PV contraction reduce
    over the S shards by all-reduces over `model` of the (B, H) statistics
    and the (B, H, Dv) output, the only collectives. Float32 scores, as
    the reference's. Otherwise it is `decode_attention`."""
    mesh = k_cache.device_mesh if isinstance(k_cache, DTensor) else None
    if (mesh is None or "model" not in mesh.mesh_dim_names
            or k_cache.shape[1] % mesh.size(
                mesh.mesh_dim_names.index("model"))):
        return decode_attention(q, k_cache, v_cache, pos, window, scale,
                                use_kernel)
    model = mesh.mesh_dim_names.index("model")
    bax, _ = shd.head_layout(mesh, q.shape[0], 1)
    group = (mesh, model)

    def layout(s_dim=None):
        return tuple(Shard(0) if i in bax else Shard(s_dim)
                     if s_dim is not None and i == model else Replicate()
                     for i in range(mesh.ndim))

    def local(ql, kl, vl, pl):
        b, _, h, d = ql.shape
        hkv = kl.shape[2]
        first = mesh.get_local_rank(model) * kl.shape[1]
        sc = d ** -0.5 if scale is None else scale
        qg = ql[:, 0].reshape(b, hkv, h // hkv, d).float()
        scores = torch.einsum("begd,bsed->begs", qg, kl.float()) * sc
        idx = first + torch.arange(kl.shape[1], device=ql.device)
        p = pl if pl.dim() == 0 else pl[:, None, None, None]
        valid = idx < p
        if window:
            valid &= idx >= p - window
        scores = torch.where(valid, scores, NEG_INF)
        m = funcol.all_reduce(scores.amax(-1, keepdim=True), "max", group)
        probs = torch.exp(scores - m)
        denom = funcol.all_reduce(probs.sum(-1, keepdim=True), "sum", group)
        out = funcol.all_reduce(torch.einsum("begs,bsed->begd", probs,
                                             vl.float()), "sum", group)
        out = out / torch.clamp(denom, min=1e-30)
        return out.reshape(b, 1, h, vl.shape[3]).to(ql.dtype)

    pos = torch.as_tensor(pos, device=q.device)
    if not isinstance(pos, DTensor):
        pos = DTensor.from_local(pos, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    return local_map(local, out_placements=(layout(),),
                     in_placements=(layout(), layout(1), layout(1),
                                    layout() if pos.dim() else
                                    (Replicate(),) * mesh.ndim),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k_cache, v_cache, pos)
