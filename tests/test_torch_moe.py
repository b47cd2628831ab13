"""The port's mixture-of-experts FFN (`repro_torch.models.moe`) against
the reference's (`repro.models.moe`), on the CPU.

Inputs and parameters are drawn with numpy from a seed and handed to both
sides (`TestMoE` of `tests/test_models.py` draws them with jax.random;
the shapes and scales are its own: granite-moe's smoke width, 4 experts,
top-2, batch 2 of 16 tokens, weights of std 0.02). The routes are
discrete, so they are compared exactly; outputs at float32 to rtol 1e-5,
atol 1e-6 (the k results of a token are summed in another order), at
bfloat16 to the reference's bfloat16 bound (rtol 0.08, atol 0.15). The
reference's `moe_ffn` computes no Pallas kernel, and neither does the
port's.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import moe as ref_moe
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=0.08, atol=0.15)}


def _cfgs(e=4, k=2, cf=8.0):
    kw = dict(num_experts=e, experts_per_token=k, moe_capacity_factor=cf)
    return (dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                                **kw),
            dataclasses.replace(ref_smoke_config("granite-moe-3b-a800m"),
                                **kw))


def _setup(dtype="float32", e=4, k=2, cf=8.0, shape=(2, 16), seed=0):
    """(port cfg, reference cfg, port params and x, reference params and
    x): the router in float32, the experts and x in `dtype`."""
    cfg, ref_cfg = _cfgs(e, k, cf)
    d, f = cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(seed)
    arrays = {"router": rng.standard_normal((d, e)) * 0.02,
              "w_gate": rng.standard_normal((e, d, f)) * 0.02,
              "w_up": rng.standard_normal((e, d, f)) * 0.02,
              "w_down": rng.standard_normal((e, f, d)) * 0.02,
              "x": rng.standard_normal((*shape, d))}
    tdt, jdt = DTYPES[dtype]
    port, ref = {}, {}
    for name, a in arrays.items():
        a = a.astype(np.float32)
        if name == "router":
            port[name], ref[name] = torch.from_numpy(a), jnp.asarray(a)
        else:
            port[name] = torch.from_numpy(a).to(tdt)
            ref[name] = jnp.asarray(a).astype(jdt)
    return cfg, ref_cfg, port, ref


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _ref_dispatch(expert_idx, cfg):
    """`repro.models.moe.moe_ffn`'s dispatch lines on the reference's
    routes: (order, dest, keep)."""
    b = expert_idx.shape[0]
    n_slots = expert_idx.shape[1] * expert_idx.shape[2]
    capacity = max(1, min(-(-int(n_slots * cfg.moe_capacity_factor)
                            // cfg.num_experts), n_slots))
    e_flat = expert_idx.reshape(b, n_slots)
    order = jnp.argsort(e_flat, axis=-1, stable=True)
    e_sorted = jnp.take_along_axis(e_flat, order, axis=-1)
    first = jax.vmap(
        lambda row: jnp.searchsorted(row, row, side="left"))(e_sorted)
    pos = jnp.arange(n_slots)[None, :] - first
    keep = pos < capacity
    dest = jnp.where(keep, e_sorted * capacity + pos,
                     cfg.num_experts * capacity)
    return np.asarray(order), np.asarray(dest), np.asarray(keep)


class TestRouter:
    @pytest.mark.parametrize("e,k", [(4, 2), (40, 8), (8, 2)])
    def test_router_probs_and_top_k(self, e, k):
        _, _, port, ref = _setup(e=e, k=k, shape=(3, 24), seed=e)
        probs = moe.router_probs(port["x"], port["router"])
        ref_probs = ref_moe.router_probs(ref["x"], ref["router"])
        assert probs.dtype == torch.float32
        np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs),
                                   rtol=1e-5, atol=1e-7)
        idx = torch.topk(probs, k, dim=-1).indices
        _, ref_idx = jax.lax.top_k(ref_probs, k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))

    @pytest.mark.parametrize("e,k", [(4, 2), (40, 8)])
    def test_load_balance_loss(self, e, k):
        cfg, _, port, ref = _setup(e=e, k=k, shape=(2, 32), seed=7)
        probs = moe.router_probs(port["x"], port["router"])
        idx = torch.topk(probs, k, dim=-1).indices
        aux = moe.load_balance_loss(probs, idx, e)
        ref_probs = ref_moe.router_probs(ref["x"], ref["router"])
        _, ref_idx = jax.lax.top_k(ref_probs, k)
        ref_aux = ref_moe.load_balance_loss(ref_probs, ref_idx, e)
        assert float(aux) == pytest.approx(float(ref_aux), rel=1e-6)
        assert 0.9 < float(aux) < 1.6   # ~1.0 when balanced (TestMoE)

    @pytest.mark.parametrize("s,k,e,cf", [(16, 2, 4, 1.25), (1, 8, 40, 1.25),
                                          (1024, 8, 40, 1.25),
                                          (16, 2, 4, 8.0), (3, 2, 4, 1.0)])
    def test_capacity(self, s, k, e, cf):
        cfg, _ = _cfgs(e, k, cf)
        n = s * k
        assert moe.capacity(s, cfg) == max(1, min(-(-int(n * cf) // e), n))


class TestMoeFFN:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
    def test_matches_reference(self, dtype, cf):
        cfg, ref_cfg, port, ref = _setup(dtype, cf=cf)
        y, aux = moe.moe_ffn(port["x"], port, cfg)
        ref_y, ref_aux = ref_moe.moe_ffn(ref["x"], ref, ref_cfg)
        assert y.dtype == port["x"].dtype and y.shape == port["x"].shape
        np.testing.assert_allclose(_np(y), _np(ref_y), **TOL[dtype])
        assert float(aux) == pytest.approx(float(ref_aux), rel=1e-6)

    @pytest.mark.parametrize("cf", [1.0, 1.25])
    def test_kept_and_dropped_slots_equal_reference(self, cf):
        """At cf = 1.0 experts overflow: the same slots are kept, and the
        same dropped into the spare row, in the same sorted order."""
        cfg, ref_cfg, port, ref = _setup(cf=cf, shape=(2, 32), seed=3)
        probs = moe.router_probs(port["x"], port["router"])
        idx = torch.topk(probs, cfg.experts_per_token, dim=-1).indices
        order, dest, keep, cap = moe.dispatch(idx, cfg)
        _, ref_idx = jax.lax.top_k(
            ref_moe.router_probs(ref["x"], ref["router"]),
            ref_cfg.experts_per_token)
        ref_order, ref_dest, ref_keep = _ref_dispatch(ref_idx, ref_cfg)
        np.testing.assert_array_equal(order.numpy(), ref_order)
        np.testing.assert_array_equal(dest.numpy(), ref_dest)
        np.testing.assert_array_equal(keep.numpy(), ref_keep)
        if cf == 1.0:
            assert not keep.all()          # some slots do drop here
        assert int(dest.max()) <= cfg.num_experts * cap
        for row in range(dest.shape[0]):   # kept destinations are unique
            row_kept = dest[row][keep[row]]
            assert row_kept.unique().numel() == row_kept.numel()

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_dense_oracle_matches_reference(self, dtype):
        cfg, ref_cfg, port, ref = _setup(dtype)
        y, aux = moe.moe_ffn_dense_reference(port["x"], port, cfg)
        ref_y, ref_aux = ref_moe.moe_ffn_dense_reference(ref["x"], ref,
                                                         ref_cfg)
        np.testing.assert_allclose(_np(y), _np(ref_y), **TOL[dtype])
        assert float(aux) == pytest.approx(float(ref_aux), rel=1e-6)

    def test_matches_dense_oracle_at_high_capacity(self):
        """`TestMoE::test_matches_dense_reference_at_high_capacity` on the
        port: nothing drops at cf = 8, so the dispatch is exact."""
        cfg, _, port, _ = _setup(cf=8.0)
        y, aux = moe.moe_ffn(port["x"], port, cfg)
        y_ref, aux_ref = moe.moe_ffn_dense_reference(port["x"], port, cfg)
        np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-4,
                                   atol=1e-5)
        assert float(aux) == pytest.approx(float(aux_ref), rel=1e-5)

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_decode_single_token(self, dtype):
        """S = 1, as in a decode step: capacity 1, top-2 of 4 experts
        never collide, so nothing drops; against the reference and the
        dense oracle."""
        cfg, ref_cfg, port, ref = _setup(dtype, cf=1.25, shape=(4, 1),
                                         seed=9)
        assert moe.capacity(1, cfg) == 1
        y, _ = moe.moe_ffn(port["x"], port, cfg)
        ref_y, _ = ref_moe.moe_ffn(ref["x"], ref, ref_cfg)
        np.testing.assert_allclose(_np(y), _np(ref_y), **TOL[dtype])
        dense, _ = moe.moe_ffn_dense_reference(port["x"], port, cfg)
        np.testing.assert_allclose(_np(y), _np(dense), **TOL[dtype])

    def test_granite_routing_width(self):
        """granite-moe's 40 experts, top-8, at its default capacity
        factor, on a narrow width."""
        cfg, ref_cfg, port, ref = _setup(e=40, k=8, cf=1.25, shape=(2, 48),
                                         seed=5)
        y, _ = moe.moe_ffn(port["x"], port, cfg)
        ref_y, _ = ref_moe.moe_ffn(ref["x"], ref, ref_cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y),
                                   **TOL["float32"])

    def test_sharded_is_moe_ffn_on_one_device(self):
        cfg, _, port, _ = _setup(cf=1.0)
        y, aux = moe.moe_ffn_sharded(port["x"], port, cfg)
        want, want_aux = moe.moe_ffn(port["x"], port, cfg)
        assert torch.equal(y, want) and torch.equal(aux, want_aux)

    def test_combine_is_deterministic(self):
        cfg, _, port, _ = _setup("bfloat16", cf=1.0, shape=(2, 64), seed=11)
        first, _ = moe.moe_ffn(port["x"], port, cfg)
        for _ in range(3):
            again, _ = moe.moe_ffn(port["x"], port, cfg)
            assert torch.equal(first, again)
