"""Mamba2's SSD in the port (`repro_torch.models.mamba2`,
`repro_torch.kernels.ssd_scan`) against the reference (`repro.models.mamba2`,
`repro.kernels.ssd_scan`), on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides. The
tolerances are the reference's own: `tests/test_models.py::TestSSD` (y
2e-4 at float32 and 2e-2 at bfloat16 with atol x5, the state 1e-3, the
decode step 1e-4) and `tests/test_kernels.py::TestSSDScanKernel` (rtol
1e-4 / 4e-2 with atol x5, where the reference's Pallas kernel runs in
interpret mode). The CUDA kernel itself runs only on the card
(`tests/test_torch_cuda.py`); here its wrapper takes CPU tensors to the
plain version and refuses devices it has no kernel for.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels.ssd_scan import ops as ref_ops
from repro.kernels.ssd_scan.ref import ssd_scan_ref as ref_ssd_scan_ref
from repro.models import mamba2 as ref_mamba2
from repro.models import Model as RefModel
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_phases as ref_phases
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models import mamba2

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _inputs(seed, b, l, h, p, n, dtype="float32", a_scale=0.5):
    """(torch tensors, jax arrays) of x, dt, a_log, b, c: x, b and c in
    `dtype`, dt = softplus(normal) and a_log in float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a_log = (rng.standard_normal(h) * a_scale).astype(np.float32)
    bb = rng.standard_normal((b, l, n)).astype(np.float32)
    cc = rng.standard_normal((b, l, n)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    mine = [torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
            torch.from_numpy(a_log), torch.from_numpy(bb).to(tdt),
            torch.from_numpy(cc).to(tdt)]
    theirs = [jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(a_log),
              jnp.asarray(bb, jdt), jnp.asarray(cc, jdt)]
    return mine, theirs


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


class TestSSDFunctions:
    """`tests/test_models.py::TestSSD` on the port, each function held
    against its reference counterpart on the same inputs."""

    @pytest.mark.parametrize("l,chunk", [(32, 8), (64, 16), (128, 128)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_chunked_and_reference_match(self, l, chunk, dtype):
        mine, theirs = _inputs(0, 2, l, 4, 8, 16, dtype)
        y, h = mamba2.ssd_chunked(*mine, chunk=chunk)
        ry, rh = ref_mamba2.ssd_chunked(*theirs, chunk=chunk)
        y_seq, h_seq = mamba2.ssd_reference(*mine)
        ry_seq, rh_seq = ref_mamba2.ssd_reference(*theirs)
        assert y.dtype == y_seq.dtype == mine[0].dtype
        assert h.dtype == h_seq.dtype == torch.float32
        tol = 2e-2 if dtype == "bfloat16" else 2e-4
        for a, b in ((y, ry), (y_seq, ry_seq), (y, y_seq)):
            _close(a, b, tol, tol * 5)
        for a, b in ((h, rh), (h_seq, rh_seq), (h, h_seq)):
            _close(a, b, 1e-3, 1e-3)

    def test_segsum(self):
        a = np.random.default_rng(1).standard_normal((3, 2, 16)).astype(
            np.float32)
        out = mamba2.segsum(torch.from_numpy(a))
        ref = np.asarray(ref_mamba2.segsum(jnp.asarray(a)))
        np.testing.assert_array_equal(np.isinf(out.numpy()), np.isinf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(out.numpy()[fin], ref[fin], rtol=1e-6,
                                   atol=1e-6)

    def test_decode_step_matches_scan(self):
        mine, theirs = _inputs(1, 2, 8, 4, 8, 16)
        state, rstate = torch.zeros((2, 4, 8, 16)), jnp.zeros((2, 4, 8, 16))
        x, dt, a_log, b, c = mine
        rx, rdt, ra, rb, rc = theirs
        y_ref, h_ref = mamba2.ssd_reference(*mine)
        for t in range(8):
            y, state = mamba2.ssd_decode_step(state, x[:, t], dt[:, t], a_log,
                                              b[:, t], c[:, t])
            ry, rstate = ref_mamba2.ssd_decode_step(
                rstate, rx[:, t], rdt[:, t], ra, rb[:, t], rc[:, t])
            _close(y, ry, 1e-4, 1e-4)
            _close(y, y_ref[:, t], 1e-4, 1e-4)
        _close(state, rstate, 1e-4, 1e-4)
        _close(state, h_ref, 1e-4, 1e-4)

    def test_initial_state_carried(self):
        """Chunked prefill of 12 steps, then decode (the port's functions),
        equals one long reference scan; `h0` carries a state into a second
        chunked scan as in the reference."""
        mine, theirs = _inputs(2, 1, 16, 2, 4, 8, a_scale=0.0)
        x, dt, a_log, b, c = mine
        ry_all, rh_all = ref_mamba2.ssd_reference(*theirs)
        _, h_pre = mamba2.ssd_chunked(x[:, :12], dt[:, :12], a_log,
                                      b[:, :12], c[:, :12], chunk=4)
        state = h_pre
        for t in range(12, 16):
            y, state = mamba2.ssd_decode_step(state, x[:, t], dt[:, t],
                                              a_log, b[:, t], c[:, t])
        _close(y, ry_all[:, -1], 1e-4, 1e-4)
        y_tail, h_tail = mamba2.ssd_chunked(
            x[:, 12:], dt[:, 12:], a_log, b[:, 12:], c[:, 12:], chunk=4,
            h0=h_pre)
        _close(y_tail, ry_all[:, 12:], 1e-4, 1e-4)
        _close(h_tail, rh_all, 1e-3, 1e-3)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("history", [False, True])
    def test_causal_conv(self, dtype, history):
        rng = np.random.default_rng(3)
        seq = rng.standard_normal((2, 1 if history else 9, 24)).astype(
            np.float32)
        kernel = (rng.standard_normal((4, 24)) * 0.2).astype(np.float32)
        prev = rng.standard_normal((2, 3, 24)).astype(np.float32)
        tdt, jdt = DTYPES[dtype]
        out = mamba2._causal_conv(
            torch.from_numpy(seq).to(tdt), torch.from_numpy(kernel).to(tdt),
            torch.from_numpy(prev).to(tdt) if history else None)
        ref = ref_mamba2._causal_conv(
            jnp.asarray(seq, jdt), jnp.asarray(kernel, jdt),
            jnp.asarray(prev, jdt) if history else None)
        assert out.dtype == tdt and out.shape == ref.shape
        tol = 2e-2 if dtype == "bfloat16" else 1e-6
        _close(out, ref, tol, tol)

    @pytest.mark.parametrize("use_ref", [False, True])
    def test_block_and_decode_block(self, use_ref):
        """`mamba2_block` and `mamba2_block_decode` on one layer of the
        float32 smoke config, with the reference's parameters as a dict."""
        cfg = dataclasses.replace(get_smoke_config("mamba2-2.7b"),
                                  dtype="float32")
        ref_cfg = dataclasses.replace(ref_smoke_config("mamba2-2.7b"),
                                      dtype="float32")
        params = RefModel(ref_cfg).init(jax.random.key(5))
        rlp = jax.tree.map(lambda a: a[0], params["layers"])
        lp = {k: torch.tensor(np.asarray(v)) for k, v in rlp.items()}
        h = np.random.default_rng(6).standard_normal(
            (2, 11, cfg.d_model)).astype(np.float32)
        out = mamba2.mamba2_block(torch.from_numpy(h), lp, cfg,
                                  use_ref=use_ref)
        ref = ref_mamba2.mamba2_block(jnp.asarray(h), rlp, ref_cfg,
                                      use_ref=use_ref)
        _close(out, ref, 1e-4, 1e-4)
        rng = np.random.default_rng(7)
        conv = rng.standard_normal((2, 3, cfg.d_inner + 2 * cfg.ssm_state))
        state = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim,
                                     cfg.ssm_state))
        cache = {"conv": torch.tensor(conv, dtype=torch.float32),
                 "state": torch.tensor(state, dtype=torch.float32)}
        rcache = {"conv": jnp.asarray(conv, jnp.float32),
                  "state": jnp.asarray(state, jnp.float32)}
        out, new = mamba2.mamba2_block_decode(torch.from_numpy(h[:, :1]), lp,
                                              cache, cfg)
        ref, rnew = ref_mamba2.mamba2_block_decode(jnp.asarray(h[:, :1]),
                                                   rlp, rcache, ref_cfg)
        _close(out, ref, 1e-4, 1e-4)
        _close(new["conv"], rnew["conv"], 1e-6, 1e-6)
        _close(new["state"], rnew["state"], 1e-4, 1e-4)


# (b, l, h, p, n, chunk): tests/test_kernels.py::TestSSDScanKernel
KERNEL_SHAPES = [(1, 128, 2, 64, 128, 128), (2, 256, 4, 64, 64, 128),
                 (1, 200, 2, 32, 64, 128), (2, 512, 1, 64, 128, 256)]


class TestSSDScan:
    """`ssd_scan_ref` and the wrapper `ops.ssd` on CPU tensors, against
    the reference's Pallas kernel in interpret mode and its oracle."""

    @pytest.mark.parametrize("b,l,h,p,n,chunk", KERNEL_SHAPES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_reference_kernel(self, b, l, h, p, n, chunk, dtype):
        mine, theirs = _inputs(l, b, l, h, p, n, dtype)
        pallas = ref_ops.ssd(*theirs, chunk=chunk, interpret=True)
        oracle = ref_ssd_scan_ref(*theirs)
        plain = ssd_scan_ref(*mine)
        before = ops.KERNEL.launches
        wrapped, state = ops.ssd(*mine, chunk=chunk, return_state=True)
        assert ops.KERNEL.launches == before          # CPU: no kernel
        assert wrapped.dtype == mine[0].dtype and state.shape == (b, h, p, n)
        rt = 4e-2 if dtype == "bfloat16" else 1e-4
        for a, ref in ((plain, oracle), (plain, pallas), (wrapped, pallas)):
            _close(a, ref, rt, rt * 5)
        _, ref_state = ref_mamba2.ssd_reference(*theirs)
        _close(state, ref_state, 1e-3, 1e-3)

    def test_state_matches_chunked(self):
        mine, _ = _inputs(9, 2, 96, 3, 32, 32)
        y, state = ops.ssd(*mine, return_state=True)
        y_chk, h_chk = mamba2.ssd_chunked(*mine, chunk=32)
        _close(y, y_chk, 1e-4, 5e-4)
        _close(state, h_chk, 1e-3, 1e-3)
        np.testing.assert_array_equal(_np(ops.ssd(*mine)), _np(y))

    def test_strided_inputs(self):
        """x, b and c as slices of one packed tensor, as the model gives
        them: the same result as contiguous copies."""
        rng = np.random.default_rng(10)
        xbc = torch.from_numpy(rng.standard_normal((1, 40, 2 * 32 + 2 * 16))
                               .astype(np.float32))
        x = xbc[..., :64].reshape(1, 40, 2, 32)
        b, c = xbc[..., 64:80], xbc[..., 80:]
        dt = torch.full((1, 40, 2), 0.3)
        a_log = torch.zeros(2)
        np.testing.assert_array_equal(
            _np(ops.ssd(x, dt, a_log, b, c)),
            _np(ops.ssd(x.contiguous(), dt, a_log, b.contiguous(),
                        c.contiguous())))

    def test_wrapper_rejects_bad_inputs(self):
        mine, _ = _inputs(11, 1, 8, 2, 32, 32)
        x, dt, a_log, b, c = mine
        with pytest.raises(ValueError, match="do not fit"):
            ops.ssd(x, dt[:, :4], a_log, b, c)
        with pytest.raises(ValueError, match=r"\(B, L, N\)"):
            ops.ssd(x, dt, a_log, b, c[:, :4])
        with pytest.raises(TypeError, match="must be a tensor"):
            ops.ssd(x, dt, a_log, b.numpy(), c)
        with pytest.raises(ValueError, match="chunk must be positive"):
            ops.ssd(*mine, chunk=0)

    def test_no_kernel_for_other_devices(self):
        """Off the CPU the wrapper launches the CUDA kernel or raises:
        there is no fallback to the plain version."""
        mine, _ = _inputs(12, 1, 8, 2, 32, 32)
        meta = [t.to("meta") for t in mine]
        before = ops.KERNEL.launches
        with pytest.raises(ValueError, match="no kernel for device meta"):
            ops.ssd(*meta)
        assert ops.KERNEL.launches == before


class TestKernelDecomposition:
    """`ref.ssd_phases`, the CUDA kernel's three phases in plain PyTorch at
    the kernel's tile (`ops.TILES`), with the bfloat16 instance's rounding
    of the products' operands when the inputs are bfloat16: held against
    the recurrence, the reference's chunked scan and its Pallas kernel in
    interpret mode at `TestSSDScanKernel`'s tolerances."""

    @pytest.mark.parametrize("b,l,h,p,n,chunk", KERNEL_SHAPES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_reference(self, b, l, h, p, n, chunk, dtype):
        mine, theirs = _inputs(l, b, l, h, p, n, dtype)
        tdt = DTYPES[dtype][0]
        y, state, _ = ref_phases(*mine, tile=ops.TILES[tdt],
                                 bf16_products=tdt == torch.bfloat16)
        assert y.dtype == tdt and state.shape == (b, h, p, n)
        pallas = ref_ops.ssd(*theirs, chunk=chunk, interpret=True)
        chunked, h_chunked = ref_mamba2.ssd_chunked(*theirs, chunk=chunk)
        rt = 4e-2 if dtype == "bfloat16" else 1e-4
        for ref in (pallas, chunked, ref_ssd_scan_ref(*theirs)):
            _close(y, ref, rt, rt * 5)
        _close(state, h_chunked, 1e-3, 1e-3)

    @pytest.mark.parametrize("l", [1, 63, 64, 65, 129, 142])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_ragged_lengths(self, l, dtype):
        """Lengths that are no multiple of a tile: the steps past the
        length act as dt = 0."""
        mine, _ = _inputs(l + 1, 1, l, 2, 32, 64, dtype)
        tdt = DTYPES[dtype][0]
        y, state, _ = ref_phases(*mine, tile=ops.TILES[tdt],
                                 bf16_products=tdt == torch.bfloat16)
        y_ref, state_ref = ssd_scan_ref(*mine, return_state=True)
        rt = 4e-2 if dtype == "bfloat16" else 1e-4
        _close(y, y_ref, rt, rt * 5)
        _close(state, state_ref, 1e-3, 1e-3)

    def test_scratch(self):
        """The scratch the kernel writes: S_in[0] = 0; S_in[c + 1] =
        exp(s_last[c]) S_in[c] + S_c[c]; the final state continues it."""
        mine, _ = _inputs(13, 2, 150, 3, 32, 32)
        _, state, work = ref_phases(*mine, tile=64)
        states, s_last, s_in = work["states"], work["s_last"], work["s_in"]
        assert states.shape == s_in.shape == (2, 3, 3, 32, 32)
        assert s_last.shape == (2, 3, 3)
        assert not s_in[:, :, 0].any()
        run = s_in[:, :, -1]
        nxt = torch.exp(s_last)[..., None, None] * s_in + states
        _close(s_in[:, :, 1:], nxt[:, :, :-1], 1e-6, 1e-6)
        _close(state, nxt[:, :, -1], 1e-6, 1e-6)
        assert run.shape == (2, 3, 32, 32)

    def test_hi_lo_split_keeps_the_state(self):
        """x o w is no bf16 value: rounded once, the chunk states move by
        some 2^-9 of their size; as bf16 hi + lo they stay near float32,
        and the final state well inside its 1e-3 tolerance."""
        mine, _ = _inputs(14, 1, 128, 2, 64, 128, "bfloat16")
        x, dt, a_log, b, c = mine
        _, state_ref = ssd_scan_ref(*mine, return_state=True)
        _, state, work = ref_phases(*mine, tile=128, bf16_products=True)
        assert float((state - state_ref).abs().max()) < 1e-4
        s = torch.cumsum(dt * -torch.exp(a_log), dim=1)       # one chunk
        xw = x.float() * (torch.exp(s[:, -1:] - s) * dt)[..., None]
        once = torch.einsum("bqhp,bqn->bhpn",
                            xw.bfloat16().float(), b.float())
        exact = torch.einsum("bqhp,bqn->bhpn", xw, b.float())
        split = work["states"][:, :, 0]
        err_split = float((split - exact).abs().max())
        err_once = float((once - exact).abs().max())
        assert err_split < 1e-4 < 1e-3 < err_once

def vector_loads(x, b, c) -> bool:
    """Whether `ops.launch` lets the kernel load x, b and c (bfloat16, 80
    heads of P 64, N 128) by 16 bytes: their strides (`_layout_args`) and
    their starts allow it."""
    bsz, l = x.shape[:2]
    pl = ops.plan(bsz, l, 80, 64, 128, torch.bfloat16, sms=132)
    _, rows = ops._layout_args(pl, x.stride(), (l * 80, 80, 1), b.stride(),
                               c.stride(), (l * 5120, 5120, 64, 1))
    return rows and not any(t.data_ptr() % 16 for t in (x, b, c))


# L -> (chunks, head group) of Mamba2-2.7B's shape (80 heads, P 64, N 128,
# one row) on 132 SMs, bfloat16 (tile 128) and float32 (tile 64)
PLANS = {1: ((1, 1), (1, 1)), 63: ((1, 1), (1, 1)), 64: ((1, 1), (1, 1)),
         65: ((1, 1), (2, 2)), 142: ((2, 2), (3, 2)),
         891: ((7, 5), (14, 8)), 1024: ((8, 5), (16, 8))}


class TestPlan:
    """The wrapper's planning, on the CPU: tile, chunks, head group, grids
    and scratch."""

    @pytest.mark.parametrize("l", sorted(PLANS))
    @pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
    def test_serve_shape(self, l, dtype):
        tdt = DTYPES[dtype][0]
        pl = ops.plan(1, l, 80, 64, 128, tdt, sms=132)
        chunks, group = PLANS[l][dtype == "float32"]
        assert pl.tile == (128 if dtype == "bfloat16" else 64)
        assert (pl.chunks, pl.group) == (chunks, group)
        assert pl.grid == (chunks, -(-80 // group), 1)
        assert pl.device_launches == 3
        # one wave of one CTA per SM, filling at least half of the SMs
        ctas = pl.grid[0] * pl.grid[1]
        assert 66 <= ctas and (ctas <= 132 or group == ops.MAX_GROUP)
        shapes = pl.scratch_shapes()
        assert shapes["states"] == ((1, 80, chunks, 64, 128), torch.float32)
        assert shapes["s_in"] == ((1, 80, chunks, 64, 128), tdt)
        assert shapes["s_last"] == ((1, 80, chunks), torch.float32)
        # one allocation, y first, each part on a 256-byte boundary
        per_chunk = 80 * 64 * 128 * (4 + tdt.itemsize) + 80 * 4
        y_bytes = l * 80 * 64 * tdt.itemsize
        raw = ops.buffer(pl, "cpu")
        parts = ops.scratch_views(pl, raw)
        assert list(pl.scratch_layout) == ["y", "states", "s_last", "s_in"]
        assert pl.scratch_layout["y"] == (0, y_bytes)
        assert parts["y"].shape == (1, l, 80, 64)
        assert sum(n for _, n in pl.scratch_layout.values()) == \
            chunks * per_chunk + y_bytes
        assert raw.dtype == tdt
        assert raw.numel() * tdt.itemsize == pl.scratch_bytes < \
            chunks * per_chunk + y_bytes + 768
        for name, (offset, n) in pl.scratch_layout.items():
            assert offset % 256 == 0
            if name != "y":
                assert parts[name].shape == shapes[name][0]
            assert parts[name].data_ptr() - raw.data_ptr() == offset

    def test_serve_scratch_fits_in_l2(self):
        """At 1,024 tokens the float32 chunk states of the bfloat16
        instance take 21 MB, well inside the H100's 50 MB L2."""
        pl = ops.plan(1, 1024, 80, 64, 128, torch.bfloat16, sms=132)
        shape, dtype = pl.scratch_shapes()["states"]
        assert int(np.prod(shape)) * dtype.itemsize == 20_971_520

    @pytest.mark.parametrize("p,n", [(p, n) for p in ops.HEAD_DIMS
                                     for n in ops.STATE_DIMS])
    def test_groups(self, p, n):
        pl = ops.plan(2, 4096, 80, p, n, torch.bfloat16, sms=114)
        assert pl.group == ops.MAX_GROUP        # 32 x 80 x 2 units
        short = ops.plan(1, 5, 3, p, n, torch.float32, sms=132)
        assert (short.chunks, short.group, short.grid) == (1, 1, (1, 3, 1))
        empty = ops.plan(1, 0, 3, p, n, torch.float32, sms=132)
        assert empty.chunks == 0 and empty.device_launches == 0
        assert empty.scratch_bytes == 0

    def test_vector_loads(self):
        """16-byte loads only where the start and the row strides allow
        them: the model's packed xBC slices do, a slice one element in
        does not."""
        xbc = torch.zeros((2, 10, 5376), dtype=torch.bfloat16)
        x = xbc[..., :5120].reshape(2, 10, 80, 64)
        b, c = xbc[..., 5120:5248], xbc[..., 5248:]
        assert vector_loads(x, b, c)
        assert not vector_loads(x, xbc[..., 1:129], c)
        odd = torch.zeros((2, 10, 5377), dtype=torch.bfloat16)
        assert not vector_loads(odd[..., :5120].reshape(2, 10, 80, 64),
                                odd[..., 5120:5248], odd[..., 5248:5376])

    @pytest.mark.parametrize("width", [5376, 5377])
    def test_packed_args(self, width):
        """The arguments packed as ssd_scan.cu's `Args` (224 bytes): the
        strides and sizes once per plan and layout, with the row-stride
        part of the 16-byte check."""
        assert ops._POINTERS.size + ops._LAYOUT.size == 224
        xbc = torch.zeros((2, 10, width), dtype=torch.bfloat16)
        x = xbc[..., :5120].unflatten(-1, (80, 64))
        b, c = xbc[..., 5120:5248], xbc[..., 5248:5376]
        dt = torch.zeros((2, 10, 80))
        y = torch.zeros((2, 10, 80, 64), dtype=torch.bfloat16)
        pl = ops.plan(2, 10, 80, 64, 128, torch.bfloat16, sms=132)
        strides = (x.stride(), dt.stride(), b.stride(), c.stride(),
                   y.stride())
        tail, rows = ops._layout_args(pl, *strides)
        assert rows == (width == 5376) == vector_loads(x, b, c)
        assert ops._layout_args(pl, *strides) == (tail, rows)
        fields = ops._LAYOUT.unpack(tail)
        assert fields[:13] == (width * 10, width, 64, 10 * 80, 80, 1,
                               width * 10, width, width * 10, width,
                               10 * 80 * 64, 80 * 64, 64)
        assert fields[13:] == (2, 10, 80, 64, 128, 1, 128, pl.group)
