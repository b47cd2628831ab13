"""Common neural layers: RMSNorm, RoPE, SwiGLU, embeddings (the
counterpart of `repro.models.layers`). Plain functions on tensors, with
the reference's float32 upcasts kept where it has them."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.config import ModelConfig


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight).to(dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings, shape (head_dim//2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def yarn_frequencies(head_dim: int, cfg: ModelConfig,
                     device=None) -> torch.Tensor:
    """YaRN's inverse frequencies (DeepSeek-V2, HF
    `DeepseekV2YarnRotaryEmbedding`), shape (head_dim//2,): the plain
    frequencies for the rotations slower than `yarn_beta_fast` turns over
    `yarn_original_max_pos` positions, those divided by `yarn_factor` for
    the ones faster than `yarn_beta_slow` turns, and a linear ramp
    between, over the dims [low, high) that those two bounds give."""
    theta, orig = cfg.rope_theta, cfg.yarn_original_max_pos

    def dim_of(turns):
        return (head_dim * math.log(orig / (turns * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(dim_of(cfg.yarn_beta_fast)), 0)
    high = min(math.ceil(dim_of(cfg.yarn_beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    extra = rope_frequencies(head_dim, theta, device)
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    return extra / cfg.yarn_factor * ramp + extra * (1 - ramp)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature: 0.1 mscale ln(factor) + 1 (1 for a
    factor of at most 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, inv_freq: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Rotary position embedding.

    x: (..., S, H, D) with D even; positions: broadcastable to (..., S).
    Uses the half-split convention (rotate_half), matching Llama.
    `inv_freq` (D/2,): frequencies other than theta's plain ones (YaRN's).
    """
    d = x.shape[-1]
    if inv_freq is None:
        inv_freq = rope_frequencies(d, theta, x.device)          # (D/2,)
    angles = positions[..., None].float() * inv_freq             # (...,S,D/2)
    cos = torch.cos(angles)[..., None, :]                        # (...,S,1,D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup against a (padded_vocab, d_model) table; on
    a DTensor table, vocab-parallel (`_embed_sharded`)."""
    if isinstance(table, DTensor):
        return _embed_sharded(tokens, table)
    return table[tokens]


def _embed_sharded(tokens: torch.Tensor, table: DTensor) -> DTensor:
    """Megatron's vocab-parallel embedding (`local_map`): each device looks
    up the tokens that fall in its rows of the vocab-sharded table and
    gives zeros for the rest, so the rows (B, S, D) are a pending sum over
    the mesh dims that split the vocab, which the residual's layout then
    reduces; the tokens keep their batch split. The table's gradient is
    a pending sum over the mesh dims that split the batch."""
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0]
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(torch.as_tensor(tokens,
                                                    device=table.device),
                                    mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tok_in = tuple(Replicate() if i in vocab else p
                   for i, p in enumerate(tokens.placements))
    tab_in = tuple(Shard(0) if i in vocab else Replicate()
                   for i in range(mesh.ndim))
    out = tuple(Partial() if i in vocab else p for i, p in enumerate(tok_in))
    tab_grad = tuple(Shard(0) if i in vocab else Partial()
                     if isinstance(p, Shard) else Replicate()
                     for i, p in enumerate(tok_in))
    coord = mesh.get_coordinate()

    def local(tok, tab):
        index = 0
        for i in vocab:
            index = index * mesh.size(i) + coord[i]
        rel = tok.long() - index * tab.shape[0]
        inside = (rel >= 0) & (rel < tab.shape[0])
        rows = tab[rel.clamp(0, tab.shape[0] - 1)]
        return torch.where(inside[..., None], rows, 0)
    return local_map(local, out_placements=(out,),
                     in_placements=(tok_in, tab_in),
                     in_grad_placements=(tok_in, tab_grad), device_mesh=mesh,
                     redistribute_inputs=True)(tokens, table)


def unembed(h: torch.Tensor, table: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Project to (padded) vocabulary logits; padded ids set to the
    dtype's lowest finite value (on a DTensor by a mask, which DTensor
    lays out as the logits)."""
    logits = h @ table.T
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    low = torch.finfo(logits.dtype).min
    if isinstance(logits, DTensor):
        padded = torch.arange(cfg.padded_vocab,
                              device=logits.device) >= cfg.vocab_size
        return logits.masked_fill(padded, low)
    logits[..., cfg.vocab_size:] = low
    return logits


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross entropy. logits (B,S,V), labels (B,S). On a
    DTensor, vocab-parallel (`_nll_sharded`)."""
    if isinstance(logits, DTensor):
        nll = _nll_sharded(logits, labels)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _nll_sharded(logits: DTensor, labels: torch.Tensor) -> DTensor:
    """-log softmax(logits)[label] (B, S), in float32, by ops that keep the
    vocab dim as DTensor shards it (Megatron's vocab-parallel cross
    entropy): the max and the sum of exponentials reduce over the shards
    as pending reductions, and the label's logit is picked by a mask, not
    by `gather`, whose backward DTensor makes as a zero tensor of the
    whole (global) logits' shape on every device."""
    x = logits.float()
    z = x - x.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(z).sum(-1))
    # the vocab ids laid out as the logits' vocab dim
    last = x.dim() - 1
    ids = DTensor.from_local(
        torch.arange(x.shape[-1], device=x.device), x.device_mesh,
        [Replicate()] * x.device_mesh.ndim, run_check=False).redistribute(
        x.device_mesh, [Shard(0) if isinstance(p, Shard) and p.dim == last
                        else Replicate() for p in x.placements])
    hit = ids == labels[..., None]
    return lse - torch.where(hit, z, 0.0).sum(-1)
