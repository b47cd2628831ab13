"""Mixture-of-Experts FFN with top-k routing and GShard-style capacity
(the counterpart of `repro.models.moe`), and the port's own dropless
serving path.

The *sorted-capacity* formulation of the reference: per batch row, token
slots are sorted by expert id, each expert takes a fixed-capacity
contiguous buffer, and the results come back weighted by the router gate.
Tokens beyond an expert's capacity are dropped (capacity_factor 1.25, as
GShard and Switch). Sorting stays local to the batch row. The expert
products are `torch.einsum` (batched matrix products), as the reference
leaves them to XLA: the JAX package computes this FFN in no Pallas
kernel.

A configuration whose `moe_capacity_factor` is 0 (DeepSeek-V2-Lite) takes
the dropless path instead (`moe_ffn_dropless`): every (token, expert)
pair is computed, over the routed rows only, one grouped product per
projection (`grouped_mm`), the shared experts beside them as one SwiGLU.
It keeps device-side counters of its routing (`counters()`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import swiglu


def router_probs(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """(B,S,D) x (D,E) -> (B,S,E) softmax router probabilities (fp32)."""
    logits = torch.einsum("bsd,de->bse", x.float(), w_router.float())
    return torch.softmax(logits, dim=-1)


def load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * P_e."""
    # fraction of slots dispatched to each expert
    counts = F.one_hot(expert_idx, num_experts).float().sum(dim=(1, 2))
    f = counts / torch.clamp(counts.sum(-1, keepdim=True), min=1.0)  # (B,E)
    p = probs.mean(dim=1)                                            # (B,E)
    return num_experts * (f * p).sum(-1).mean()


def _route(x: torch.Tensor, params: dict, cfg: ModelConfig):
    """Router probabilities, the top-k gates (renormalised with a 1e-9
    floor, unless `cfg.moe_renormalize` is off) and expert ids, and the
    auxiliary loss."""
    probs = router_probs(x, params["router"])                   # (B,S,E)
    gate, expert_idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    if cfg.moe_renormalize:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gate, expert_idx, load_balance_loss(probs, expert_idx,
                                               cfg.num_experts)


def dropless(cfg: ModelConfig) -> bool:
    """Whether `cfg` routes without capacity: `moe_capacity_factor` 0."""
    return cfg.moe_capacity_factor <= 0


# ----------------------------- counters ----------------------------- #
#: what `counters()` reports, in the order of each device's buffer
COUNTERS = ("calls", "routed_rows", "largest_expert_rows",
            "experts_touched")
_COUNTS: dict[torch.device, torch.Tensor] = {}


def _count(rows: torch.Tensor) -> None:
    """Add one dropless call's routing to its device's int64 counters:
    the call, its routed rows, its most-loaded expert's rows and the
    experts it gave any row (`rows` (E,) each expert's rows). Device
    work only: nothing is read back. Nothing on a `meta` device."""
    if rows.device.type == "meta":
        return
    buf = _COUNTS.get(rows.device)
    if buf is None:
        buf = _COUNTS[rows.device] = torch.zeros(
            len(COUNTERS), dtype=torch.int64, device=rows.device)
    buf += torch.stack([torch.ones_like(rows[0]), rows.sum(), rows.max(),
                        (rows > 0).sum()])


def counters() -> dict[str, int]:
    """The dropless path's counters since the process began (or
    `reset_counters`), summed over devices: each device's buffer read
    once."""
    total = [0] * len(COUNTERS)
    for buf in _COUNTS.values():
        total = [a + b for a, b in zip(total, buf.tolist())]
    return dict(zip(COUNTERS, total))


def reset_counters() -> None:
    for buf in _COUNTS.values():
        buf.zero_()


# ----------------------------- dropless ----------------------------- #
def grouped_mm(a: torch.Tensor, w: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """Rows `a` (R, K) sorted by group, `w` (G, K, N), `ends` (G,) each
    group's end row: each group's rows times its matrix, (R, N). bfloat16
    on CUDA is one `torch._grouped_mm` launch, the group offsets read on
    the device; elsewhere a loop over the groups that have rows (the
    group sizes read on the host). On `meta` (the dry run), every row times
    the sum of the matrices: the grouped product's shape, FLOPs and
    weight bytes, and a gradient path to `a` and `w`."""
    if a.device.type == "meta":
        return a @ w.sum(0)
    if a.device.type == "cuda" and a.dtype == torch.bfloat16:
        return torch._grouped_mm(a, w, offs=ends.to(torch.int32))
    out = a.new_zeros((a.shape[0], w.shape[2]))
    lo = 0
    for g, hi in enumerate(ends.tolist()):
        if hi > lo:
            out[lo:hi] = a[lo:hi] @ w[g]
        lo = hi
    return out


def moe_ffn_dropless(x: torch.Tensor, params: dict, cfg: ModelConfig,
                     shared: dict | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE SwiGLU FFN that drops no token. x: (B,S,D) -> (y (B,S,D),
    aux_loss ()).

    The N = B S k (token, expert) pairs are sorted by expert once (stable,
    so each expert's rows keep token order); each expert's end row comes
    from a search of the sorted ids on the device, so nothing waits on the
    host. The routed rows are gathered and go through the experts' gate,
    up and down projections in one grouped product each (`grouped_mm`);
    each row's gate weighs it before the down projection. The k results of
    a token are put back in token order by the inverse of the sort and
    summed over k in float32: no float atomics, so the result is
    deterministic. `shared` ({w_gate, w_up, w_down}): the shared experts,
    one SwiGLU over every token, added in float32; y rounds once."""
    b, s, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    n = b * s
    gate, expert_idx, aux = _route(x, params, cfg)
    e_sorted, order = torch.sort(expert_idx.reshape(n * k), stable=True)
    ends = torch.searchsorted(e_sorted, torch.arange(
        e, device=x.device, dtype=e_sorted.dtype), right=True)
    _count(torch.diff(ends, prepend=ends.new_zeros(1)))
    xf = x.reshape(n, d)
    xs = xf[torch.div(order, k, rounding_mode="floor")]
    g = grouped_mm(xs, params["w_gate"], ends)
    u = grouped_mm(xs, params["w_up"], ends)
    act = F.silu(g) * u * gate.reshape(n * k)[order][:, None].to(x.dtype)
    ys = grouped_mm(act, params["w_down"], ends)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(n * k, device=x.device)
    y = ys[inverse].reshape(n, k, d).sum(1, dtype=torch.float32)
    if shared is not None:
        y = y + swiglu(xf, shared["w_gate"], shared["w_up"],
                       shared["w_down"]).float()
    return y.to(x.dtype).reshape(b, s, d), aux


def capacity(seq_len: int, cfg: ModelConfig) -> int:
    """Slots of each expert's buffer per batch row:
    max(1, min(ceil(S * k * cf / E), S * k))."""
    n_slots = seq_len * cfg.experts_per_token
    return max(1, min(-(-int(n_slots * cfg.moe_capacity_factor)
                        // cfg.num_experts), n_slots))


def dispatch(expert_idx: torch.Tensor, cfg: ModelConfig):
    """The sorted dispatch of (B, S, k) expert ids: `order` (the stable
    sort of the B rows of S * k slots by expert id), `dest` (each sorted
    slot's row in the flat (E * C + 1) buffer: e * C + its position in
    its expert's run, or the spare row E * C when that position is at or
    past capacity C) and `keep` (the slots not dropped)."""
    b, s, k = expert_idx.shape
    n_slots = s * k
    cap = capacity(s, cfg)
    e_sorted, order = torch.sort(expert_idx.reshape(b, n_slots), dim=-1,
                                 stable=True)
    # position of each slot within its expert's buffer: its index less
    # the first index of its expert in the sorted row
    first = torch.searchsorted(e_sorted, e_sorted, side="left")
    pos = torch.arange(n_slots, device=expert_idx.device) - first
    keep = pos < cap
    dest = torch.where(keep, e_sorted * cap + pos, cfg.num_experts * cap)
    return order, dest, keep, cap


def moe_ffn(x: torch.Tensor, params: dict, cfg: ModelConfig,
            shared: dict | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE SwiGLU FFN. x: (B,S,D) -> (y (B,S,D), aux_loss ()).
    A dropless configuration (`dropless`) runs `moe_ffn_dropless`, which
    also takes the shared experts (`shared`); the rest as follows.

    The reference's semantics: the same routes, capacity, stable sort,
    drops and gate weights. Its combine is a scatter-add into y
    (`.at[].add`); here the combine writes no float atomics, so the
    result is deterministic on CUDA, where `index_add_` on bfloat16 is
    not. The kept destinations are unique, so the dispatch is a plain
    indexed write (the dropped slots all write zeros to the spare row);
    the k results of each token are put back in token-major order with
    the inverse of the sort and summed over k. In float32 that sum is
    taken in top-k order where the reference adds in expert order, so
    the two differ by float32 rounding. In bfloat16 the reference rounds
    y to bfloat16 after each of the k adds; here the k terms are summed
    in float32 and rounded once.
    """
    if dropless(cfg):
        return moe_ffn_dropless(x, params, cfg, shared)
    b, s, d = x.shape
    e = cfg.num_experts
    gate, expert_idx, aux = _route(x, params, cfg)
    order, dest, keep, cap = dispatch(expert_idx, cfg)
    k = cfg.experts_per_token
    rows = torch.arange(b, device=x.device)[:, None]
    tok_sorted = torch.div(order, k, rounding_mode="floor")
    gate_sorted = gate.reshape(b, s * k).gather(-1, order)

    # gather token activations into the expert buffers (B, E*C+1, D)
    x_slot = x[rows, tok_sorted]
    buf = x.new_zeros((b, e * cap + 1, d))
    buf[rows, dest] = torch.where(keep[..., None], x_slot, 0)
    buf = buf[:, :e * cap].reshape(b, e, cap, d)

    # expert computation (SwiGLU)
    g = torch.einsum("becd,edf->becf", buf, params["w_gate"])
    u = torch.einsum("becd,edf->becf", buf, params["w_up"])
    y_buf = torch.einsum("becf,efd->becd", F.silu(g) * u,
                         params["w_down"]).reshape(b, e * cap, d)

    # combine: each sorted slot's result, weighted, back in token order
    y_buf = torch.cat([y_buf, y_buf.new_zeros((b, 1, d))], dim=1)
    y_slot = y_buf[rows, dest] * (gate_sorted * keep)[..., None].to(
        y_buf.dtype)
    inverse = torch.empty_like(order)
    inverse.scatter_(1, order, torch.arange(s * k, device=x.device).expand(
        b, -1))
    y = y_slot[rows, inverse].reshape(b, s, k, d).float().sum(2)
    if shared is not None:
        y = y + swiglu(x, shared["w_gate"], shared["w_up"],
                       shared["w_down"]).float()
    return y.to(x.dtype), aux


def moe_ffn_sharded(x: torch.Tensor, params: dict, cfg: ModelConfig,
                    shared: dict | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """`moe_ffn` with the sorted-capacity (or dropless) dispatch kept on
    each device:
    on DTensors over a mesh with a `model` axis it runs `moe_ffn` on the
    local shards (`local_map`, the reference's `shard_map`), so the sorts,
    gathers and scatters stay device-local and never meet DTensor's
    sharding rules.

    The batch stays sharded over (`pod`, `data`) where it divides; expert
    weights are sharded on d_ff over `model`, so each device's w_down
    contraction is a partial sum, finished by an all-reduce over `model`
    (the reference's `psum`, the collective a dense row-parallel MLP
    needs); the aux loss is averaged over the batch axes (`pmean`). The
    shared experts run outside, on DTensors, as a dense MLP (d_ff over
    `model`, its pending sum finished with the routed one's). Without a
    `model` axis (or without DTensors) it is `moe_ffn`."""
    mesh = x.device_mesh if isinstance(x, DTensor) else None
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return moe_ffn(x, params, cfg, shared)
    names = mesh.mesh_dim_names
    bax = [i for i, n in enumerate(names) if n in ("pod", "data")]
    n_batch = math.prod(mesh.size(i) for i in bax)
    if not bax or x.shape[0] % n_batch:
        bax, n_batch = [], 1
    model = names.index("model")
    f_ok = cfg.expert_d_ff % mesh.size(model) == 0

    def layout(batch, model_dim):
        return tuple(batch if i in bax else model_dim if i == model
                     else Replicate() for i in range(mesh.ndim))
    x_in = layout(Shard(0), Replicate())
    rep = layout(Replicate(), Replicate())
    f_in = Shard(2) if f_ok else Replicate()

    # with d_ff split, each device's products are a pending sum over
    # `model`, and so are the gradients of x (reduced as it enters, as
    # Megatron's `f`: `pinned`) and the router; the aux loss, which each
    # device computes whole, is split into equal parts there so that its
    # gradient is counted once
    part = Partial() if f_ok else Replicate()
    n_part = mesh.size(model) if f_ok else 1

    def local_fn(x_l, router, wg, wu, wd):
        y, aux = moe_ffn(x_l, {"router": router, "w_gate": wg, "w_up": wu,
                               "w_down": wd}, cfg)
        return y, aux / (n_batch * n_part)
    w_down = layout(Replicate(), Shard(1) if f_ok else Replicate())

    y, aux = local_map(
        local_fn,
        out_placements=(layout(Shard(0), part), layout(Partial(), part)),
        in_placements=(x_in, rep, layout(Replicate(), f_in),
                       layout(Replicate(), f_in), w_down),
        in_grad_placements=(layout(Shard(0), part), layout(Partial(), part),
                            layout(Partial(), f_in), layout(Partial(), f_in),
                            layout(Partial(), w_down[model])),
        device_mesh=mesh, redistribute_inputs=True,
    )(shd.pinned(x), params["router"], params["w_gate"], params["w_up"],
      params["w_down"])
    if shared is not None:
        y = y + swiglu(x, shared["w_gate"], shared["w_up"],
                       shared["w_down"])
    return y.redistribute(mesh, x_in), aux.redistribute(mesh, rep)


def moe_ffn_dense_reference(x: torch.Tensor, params: dict,
                            cfg: ModelConfig
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Oracle: compute EVERY expert densely and combine by gates (no
    capacity drops). Used by tests; O(E/k) more FLOPs than moe_ffn."""
    gate, expert_idx, aux = _route(x, params, cfg)
    # (B,S,E) combine weights (zero for non-selected experts)
    combine = (F.one_hot(expert_idx, cfg.num_experts).float()
               * gate[..., None]).sum(2)
    g = torch.einsum("bsd,edf->bsef", x, params["w_gate"])
    u = torch.einsum("bsd,edf->bsef", x, params["w_up"])
    y_all = torch.einsum("bsef,efd->bsed", F.silu(g) * u, params["w_down"])
    y = torch.einsum("bsed,bse->bsd", y_all, combine.to(x.dtype))
    return y, aux
