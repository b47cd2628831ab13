"""Sharding rules: map model, cache and input tensors onto the production
mesh (the counterpart of `repro.distributed.sharding`).

Strategy, the reference's:
  * weights: Megatron-style tensor parallelism on the `model` axis —
    column-parallel for up-projections (wq/wk/wv/w_gate/w_up/q_up/...),
    row-parallel for down-projections (wo/w_down/w_out); vocab sharded on
    `model` (vocab is padded to a multiple of 2048 so 16 always divides).
  * MoE experts: expert weights sharded on the d_ff dim over `model`
    (tensor-parallel experts) — legal for any expert count (40, 8).
  * activations/batch: sharded over (`pod`, `data`).
  * KV caches: batch -> data; heads -> model when the head count divides,
    else sequence -> model (flash-decoding style length sharding).

Every rule is divisibility-guarded: a dim that the axis does not divide
evenly is replicated instead.

A spec is a `P`: a tuple with one entry per tensor dim, each None
(replicated), a mesh axis name, or a tuple of names (the dim split over
those axes, the first name outermost), as jax's `PartitionSpec`.
`placements` turns it into DTensor placements (one per mesh dim) and
`distribute` applies a tree of them. A mesh is a `DeviceMesh` with
`mesh_dim_names`, or any object with a `shape` dict and `axis_names`, as
the reference's tests give theirs.

The port's model holds one module per layer where the reference stacks
each per-layer leaf on a leading `num_layers` axis, so a parameter's spec
here is the reference's for that leaf without its leading None.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.models.config import ModelConfig


class P(tuple):
    """A partition spec: one entry per tensor dim (None, an axis name, or a
    tuple of axis names; a tuple of one name is that name, as jax's
    `PartitionSpec` normalizes it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1 else
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {name: mesh.size(i) for i, name in enumerate(names)}
    return {name: mesh.shape[name] for name in mesh.axis_names}


def axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = mesh_axes(mesh)
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _fits(dim: int, mesh, axis) -> bool:
    return dim % axis_size(mesh, axis) == 0


def dim_spec(mesh, dim: int, axis):
    """axis if it divides dim, else replicate."""
    return axis if axis is not None and _fits(dim, mesh, axis) else None


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


# --------------------------------------------------------------------- #
# parameter specs
# --------------------------------------------------------------------- #
_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "w_z", "w_x",
                 "q_up", "k_up", "v_up", "q_down", "kv_down"}
_ROW_PARALLEL = {"wo", "w_down", "w_out"}
_VOCAB = {"embed", "unembed"}


def _leaf_spec(name: str, shape: tuple, mesh) -> P:
    nd = len(shape)
    if name in _VOCAB:
        return P(dim_spec(mesh, shape[0], "model"), None)
    if name in _COL_PARALLEL:
        if nd == 3:  # MoE expert weight (E, D, F): shard F
            return P(None, None, dim_spec(mesh, shape[2], "model"))
        return P(None, dim_spec(mesh, shape[1], "model"))
    if name in _ROW_PARALLEL:
        if nd == 3:  # MoE (E, F, D): shard F
            return P(None, dim_spec(mesh, shape[1], "model"), None)
        return P(dim_spec(mesh, shape[0], "model"), None)
    return P(*([None] * nd))  # norms, biases, router, conv, scalars


def _named(model_or_params) -> dict:
    if isinstance(model_or_params, nn.Module):
        return dict(model_or_params.named_parameters())
    return dict(model_or_params)


def param_specs(model_or_params, mesh) -> dict[str, P]:
    """{parameter name: P} for a `Model` (any device, `meta` included) or
    a dict of its named parameters: the rule of the leaf's own name (the
    last part of `layers.3.attn.wq`) on the leaf's own dims."""
    return {name: _leaf_spec(name.rsplit(".", 1)[-1], tuple(t.shape), mesh)
            for name, t in _named(model_or_params).items()}


# --------------------------------------------------------------------- #
# cache specs
# --------------------------------------------------------------------- #
def kv_cache_spec(mesh, shape: tuple) -> P:
    """(L, B, S, H, D) — batch->data, heads->model else seq->model."""
    _, b, s, h, _ = shape
    b_ax = dim_spec(mesh, b, batch_axes(mesh))
    h_ax = dim_spec(mesh, h, "model")
    s_ax = None if h_ax else dim_spec(mesh, s, "model")
    return P(None, b_ax, s_ax, h_ax, None)


def latent_cache_spec(mesh, shape: tuple) -> P:
    """MLA latent (L, B, S, R) — batch->data, seq->model."""
    _, b, s, _ = shape
    return P(None, dim_spec(mesh, b, batch_axes(mesh)),
             dim_spec(mesh, s, "model"), None)


def ssm_cache_specs(mesh, conv_shape: tuple, state_shape: tuple):
    """conv (L,B,W-1,C), state (L,B,H,P,N) — batch->data, heads/chan->model."""
    _, b, _, c = conv_shape
    _, _, h, _, _ = state_shape
    b_ax = dim_spec(mesh, b, batch_axes(mesh))
    return (P(None, b_ax, None, dim_spec(mesh, c, "model")),
            P(None, b_ax, dim_spec(mesh, h, "model"), None, None))


def _cache_leaf_spec(name: str, shape: tuple, mesh) -> P:
    b_ax = batch_axes(mesh)
    lead = [None] * (len(shape) - 4)
    if name == "pos":
        return P()
    if name in ("k", "v", "xk", "xv"):
        b, s, h, _ = shape[-4:]
        h_ax = dim_spec(mesh, h, "model")
        s_ax = None if h_ax else dim_spec(mesh, s, "model")
        return P(*lead, dim_spec(mesh, b, b_ax), s_ax, h_ax, None)
    if name == "latent":
        lead = [None] * (len(shape) - 3)
        b, s, _ = shape[-3:]
        return P(*lead, dim_spec(mesh, b, b_ax),
                 dim_spec(mesh, s, "model"), None)
    if name == "conv":
        lead = [None] * (len(shape) - 3)
        b, _, c = shape[-3:]
        return P(*lead, dim_spec(mesh, b, b_ax), None,
                 dim_spec(mesh, c, "model"))
    if name == "state":
        b, h, _, _ = shape[-4:]
        return P(*lead, dim_spec(mesh, b, b_ax),
                 dim_spec(mesh, h, "model"), None, None)
    return P(*([None] * len(shape)))


def cache_specs(cfg: ModelConfig, cache: dict, mesh) -> dict:
    """A spec tree matching a cache dict (`Model.empty_cache`'s layout,
    "pos" included), by key name; a None leaf (the hybrid's absent
    "tail") stays None.

    Rules apply to TRAILING dims so arbitrary leading stack dims (layers,
    hybrid groups, per-group layers) are handled uniformly:
      k/v/xk/xv : (..., B, S, H, D)  batch->data, heads->model else S->model
      latent    : (..., B, S, R)    batch->data, S->model
      conv      : (..., B, W, C)    batch->data, channels->model
      state     : (..., B, H, P, N) batch->data, heads->model
    """
    del cfg  # the rules read the shapes only, as the reference's do

    def walk(tree):
        return {key: (walk(val) if isinstance(val, dict) else None
                      if val is None else
                      _cache_leaf_spec(key, tuple(val.shape), mesh))
                for key, val in tree.items()}
    return walk(cache)


# --------------------------------------------------------------------- #
# DTensor placements
# --------------------------------------------------------------------- #
def placements(spec, mesh) -> list:
    """DTensor placements (one per mesh dim) of a spec: `Shard(i)` on each
    mesh dim that tensor dim i is split over, `Replicate()` elsewhere. A
    tuple entry ("pod", "data") gives `Shard(i)` on both mesh dims; DTensor
    splits over them in mesh order, jax's left-to-right order, so the
    tuple must list them in that order."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 f"splits two tensor dims")
            out[i] = Shard(dim)
    return out


def _distribute_leaf(t: torch.Tensor, mesh, spec):
    # each rank cuts its own shard from the whole tensor it holds (every
    # rank builds the same seeded tensors): no collective is issued
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def distribute(model_or_tree, mesh, specs):
    """Lay out a `Model` or a tree of tensors on `mesh` by `specs`
    (`param_specs`' or `cache_specs`' tree): a model's parameters are
    replaced by DTensors in place and the model returned; a dict tree is
    returned as a new tree of DTensors, a None leaf kept. The reference's
    `named` and `with_sharding`."""
    if isinstance(model_or_tree, nn.Module):
        for name, param in list(model_or_tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            module = model_or_tree.get_submodule(owner) if owner \
                else model_or_tree
            new = _distribute_leaf(param.detach(), mesh, specs[name])
            setattr(module, leaf, nn.Parameter(
                new, requires_grad=param.requires_grad))
        return model_or_tree

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {key: walk(val, spec[key]) for key, val in tree.items()}
        if tree is None:
            return None
        return _distribute_leaf(tree, mesh, spec)
    return walk(model_or_tree, specs)


@contextlib.contextmanager
def implicit_replication():
    """Let DTensor ops take plain tensors (the positions, masks and
    constants a model makes as it runs) as replicated ones: torch's
    `implicit_replication`, but restoring the setting it found, so that
    it nests."""
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """A DTensor as it is, its gradient laid out as it in the backward
    pass (a redistribution to its own placements moves nothing forward and
    redistributes the gradient backward), so that a reshape's backward
    meets the layout its forward had."""
    return x.redistribute(x.device_mesh, x.placements)


def split_last(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """`x` (..., n * d) reshaped to (..., n, d): a projection's output
    split into heads. On a DTensor whose last dim is sharded over mesh
    dims that do not divide `n` (8 KV heads over a `model` axis of 16),
    those mesh dims are replicated first, the reshard GSPMD makes."""
    if not isinstance(x, DTensor):
        return x.reshape(*x.shape[:-1], n, d)
    last = x.dim() - 1
    split = [i for i, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim == last]
    if n % math.prod(x.device_mesh.size(i) for i in split):
        x = x.redistribute(x.device_mesh, [
            Replicate() if i in split else p
            for i, p in enumerate(x.placements)])
    return _pinned(x.reshape(*x.shape[:-1], n, d))


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """`x` (..., n, d) reshaped to (..., n * d): heads merged back into a
    projection's input. On a DTensor, a sharding of d, or of n over mesh
    dims that do not divide it (DTensor may shard unevenly), and a pending
    sum are replicated first, the reshard GSPMD makes."""
    shape = (*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    n_dim, d_dim = x.dim() - 2, x.dim() - 1
    on_n = [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == n_dim]
    even = x.shape[n_dim] % math.prod(
        x.device_mesh.size(i) for i in on_n) == 0
    fixed = [Replicate() if p.is_partial() or isinstance(p, Shard) and (
        p.dim == d_dim or (p.dim == n_dim and not even)) else p
             for p in x.placements]
    if fixed != list(x.placements):
        x = x.redistribute(x.device_mesh, fixed)
    return _pinned(x.reshape(shape))
