"""Attention of the port against the reference, on the CPU.

- The plain versions of the two kernels (`kernels/flash_attention/ref.py`,
  `kernels/decode_attention/ref.py`, which their wrappers run on CPU
  tensors) against the reference's jnp oracles and its Pallas kernels in
  interpret mode, on the shapes of `tests/test_kernels.py`
  (`TestFlashAttentionKernel`, `TestDecodeAttentionKernel`) at its
  tolerances (`tol`: 2e-2 for bfloat16, 2e-5 for float32).
- The port's `models.attention` functions against `repro.models.attention`.

Inputs are drawn with numpy from a seed and handed to both sides; a
bfloat16 input is the same float32 draw rounded by each framework (both
round to nearest even, so the bits agree). Decode positions are drawn in
[1, S): a row with no visible key (pos = 0) is excluded by construction,
as the engine never asks for one (see `decode_attention.cu`).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as ref_dec_ops
from repro.kernels.decode_attention.ref import (
    decode_attention_ref_explicit as jnp_decode_oracle)
from repro.kernels.flash_attention import ops as ref_fa_ops
from repro.kernels.flash_attention.ref import (
    flash_attention_ref as jnp_flash_oracle)
from repro.models import attention as ref_attn
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_ref_explicit)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import attention as attn

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
FLASH_SHAPES = [(1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 1, 128, 128),
                (2, 2, 2, 192, 64)]
DECODE_SHAPES = [(1, 4, 4, 512, 64), (4, 8, 2, 1024, 64),
                 (2, 8, 1, 512, 128), (2, 4, 4, 640, 64)]


def tol(dtype: str) -> dict:
    """`tests/test_kernels.py::tol`."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(a: np.ndarray, dtype: str):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **kw)


class TestFlashAttentionPlain:
    """B2's plain version vs the jnp oracle and the Pallas kernel."""

    def _case(self, b, h, hkv, s, d, dtype, window=0, seed=0, causal=True):
        q, k, v = _draw(seed, (b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))
        (tq, jq), (tk, jk), (tv, jv) = (_both(x, dtype) for x in (q, k, v))
        before = fa_ops.KERNEL.launches, dict(fa_ops.KERNEL.variant_launches)
        port = fa_ops.attention_bhsd(tq, tk, tv, causal=causal,
                                     window=window)
        # CPU: the plain version, no launch counted
        assert (fa_ops.KERNEL.launches,
                dict(fa_ops.KERNEL.variant_launches)) == before
        oracle = jnp.swapaxes(jnp_flash_oracle(
            jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
            jnp.swapaxes(jv, 1, 2), causal=causal, window=window), 1, 2)
        pallas = ref_fa_ops.attention_bhsd(jq, jk, jv, causal=causal,
                                           window=window, interpret=True)
        _close(port, oracle, **tol(dtype))
        _close(port, pallas, **tol(dtype))

    @pytest.mark.parametrize("b,h,hkv,s,d", FLASH_SHAPES)
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_causal(self, b, h, hkv, s, d, dtype):
        self._case(b, h, hkv, s, d, dtype)

    @pytest.mark.parametrize("window", [32, 128])
    def test_sliding_window(self, window):
        self._case(1, 2, 2, 256, 64, "float32", window=window, seed=1)

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_zamba2_head_dim(self, dtype):
        """Zamba2's shared block: head dim 112, heads over as many KV
        heads."""
        self._case(1, 4, 4, 200, 112, dtype, seed=4)

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_bidirectional(self, dtype):
        """An encoder's attention (Seamless): every key visible (S a
        multiple of the reference's block, which it pads only when
        causal)."""
        self._case(2, 4, 4, 256, 64, dtype, seed=5, causal=False)

    def test_length_not_a_block_multiple(self):
        """S = 200: the reference pads to its 128 block, the port masks
        keys by length."""
        self._case(1, 8, 2, 200, 64, "float32", seed=2)

    def test_ref_takes_offsets_and_scale(self):
        """A query block at offset 70 of a 90-key sequence equals the
        last 20 rows of the full causal attention; `scale` overrides
        D ** -0.5."""
        q, k, v = (torch.from_numpy(x).transpose(1, 2) for x in
                   _draw(3, (1, 90, 4, 32), (1, 90, 2, 32),
                         (1, 90, 2, 32)))
        full = flash_attention_ref(q, k, v)
        tail = flash_attention_ref(q[:, :, 70:], k, v, q_offset=70)
        torch.testing.assert_close(tail, full[:, :, 70:])
        scaled = flash_attention_ref(q, k, v, scale=0.1)
        same = flash_attention_ref(q * (0.1 / 32 ** -0.5), k, v)
        torch.testing.assert_close(scaled, same, rtol=1e-5, atol=1e-5)


class TestDecodeAttentionPlain:
    """B3's plain version vs the jnp oracle and the Pallas kernel."""

    def _case(self, b, h, hkv, s, d, dtype, window=0, pos=None, seed=0):
        q, kc, vc = _draw(seed, (b, h, d), (b, s, hkv, d), (b, s, hkv, d))
        (tq, jq), (tk, jk), (tv, jv) = (_both(x, dtype)
                                        for x in (q, kc, vc))
        if pos is None:
            pos = np.random.default_rng(seed).integers(1, s, b)
        pos = np.asarray(pos, np.int32)
        before = dec_ops.KERNEL.launches
        port = dec_ops.decode_bhd(tq, tk, tv, torch.from_numpy(pos),
                                  window=window)
        assert dec_ops.KERNEL.launches == before
        oracle = jnp_decode_oracle(jq, jk, jv, jnp.asarray(pos),
                                   window=window)
        pallas = ref_dec_ops.decode_bhd(jq, jk, jv, jnp.asarray(pos),
                                        window=window, interpret=True)
        _close(port, oracle, **tol(dtype))
        _close(port, pallas, **tol(dtype))

    @pytest.mark.parametrize("b,h,hkv,s,d", DECODE_SHAPES)
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_matches(self, b, h, hkv, s, d, dtype):
        self._case(b, h, hkv, s, d, dtype)

    def test_sliding_window(self):
        self._case(2, 4, 4, 512, 64, "float32", window=128,
                   pos=[300, 500], seed=1)

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_zamba2_head_dim(self, dtype):
        """Zamba2's shared block: q (B, 32, 112) against caches of as many
        heads, here 8 over 8."""
        self._case(2, 8, 8, 512, 112, dtype, pos=[511, 37], seed=2)

    def test_scalar_pos_broadcasts(self):
        q, kc, vc = (torch.from_numpy(x) for x in
                     _draw(4, (3, 4, 32), (3, 50, 2, 32), (3, 50, 2, 32)))
        vec = dec_ops.decode_bhd(q, kc, vc, torch.tensor([17, 17, 17]))
        torch.testing.assert_close(dec_ops.decode_bhd(q, kc, vc, 17), vec)
        torch.testing.assert_close(
            dec_ops.decode_bhd(q, kc, vc, torch.tensor(17)), vec)

    def test_model_math_ref(self):
        """`decode_attention_ref` (the model's plain math) agrees with
        the explicit oracle at float32."""
        q, kc, vc = (torch.from_numpy(x) for x in
                     _draw(5, (2, 8, 64), (2, 96, 2, 64), (2, 96, 2, 64)))
        pos = torch.tensor([40, 96])
        torch.testing.assert_close(
            decode_attention_ref(q, kc, vc, pos, window=16),
            decode_attention_ref_explicit(q, kc, vc, pos, window=16),
            rtol=2e-5, atol=2e-5)


class TestWrappers:
    def test_no_kernel_off_cuda(self):
        q = torch.zeros(1, 4, 2, 32, device="meta")
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fa_ops.attention_bhsd(q, q, q)
        with pytest.raises(ValueError, match="no kernel for device meta"):
            dec_ops.decode_bhd(q[:, 0], q, q, 1)

    def test_checks_shapes_and_devices(self):
        q = torch.zeros(1, 4, 3, 32)
        kv = torch.zeros(1, 4, 2, 32)
        with pytest.raises(ValueError, match="do not group"):
            fa_ops.attention_bhsd(q, kv, kv)
        with pytest.raises(TypeError, match="is torch.bfloat16"):
            fa_ops.attention_bhsd(kv, kv.bfloat16(), kv)
        with pytest.raises(ValueError, match=r"pos must be \(\) or \(1,\)"):
            dec_ops.decode_bhd(kv[:, 0], kv, kv, torch.tensor([1, 2]))

    @pytest.mark.parametrize("b,hkv,s,want", [(1, 8, 1536, 12),
                                              (4, 8, 1536, 8),
                                              (4, 8, 100, 1),
                                              (64, 8, 1536, 1)])
    def test_split_count(self, b, hkv, s, want):
        """At most two CTAs per SM (132 SMs), at least 128 cache rows per
        slice; (4, 8, 1536) is Llama-3-8B's decode in the serve cell."""
        assert dec_ops.n_splits(b, hkv, s) == want

    @pytest.mark.parametrize("b,hkv,s,want", [(1, 1, 127, 1), (1, 1, 128, 1),
                                              (1, 1, 256, 2),
                                              (2, 8, 100_000, 16),
                                              (33, 8, 4096, 1),
                                              (0, 8, 1536, 12),
                                              (1, 1, 100_000, 64)])
    def test_split_count_edges(self, b, hkv, s, want):
        assert dec_ops.n_splits(b, hkv, s) == want

    def test_split_slices_hold_enough_keys(self):
        for b in (1, 2, 4, 8, 16):
            for s in (128, 1000, 1536, 8192):
                split = dec_ops.n_splits(b, 8, s)
                assert split == 1 or s // split >= dec_ops.SLICE_KEYS
                # the most slices within WAVES CTAs per SM
                assert split == 1 or \
                    b * 8 * split <= dec_ops.WAVES * dec_ops.SMS
                assert split <= dec_ops.MAX_SPLITS

    def test_counters_cached_and_grown_per_device(self, monkeypatch):
        monkeypatch.setattr(dec_ops, "_COUNTERS", {})
        first = dec_ops.counters("cpu", 32)
        assert first.dtype == torch.int32 and first.numel() == 32
        assert int(first.abs().sum()) == 0
        assert dec_ops.counters(torch.device("cpu"), 32) is first
        assert dec_ops.counters("cpu", 8) is first       # kept, not shrunk
        first[3] = 7          # a buffer that is kept is not zeroed again
        assert int(dec_ops.counters("cpu", 32)[3]) == 7
        grown = dec_ops.counters("cpu", 40)
        assert grown is not first and grown.numel() == 64
        assert int(grown.abs().sum()) == 0
        assert dec_ops.counters("cpu", 40) is grown
        meta = dec_ops.counters("meta", 4)
        assert meta.device.type == "meta" and meta.numel() == 4
        assert dec_ops.counters("cpu", 40) is grown

    @pytest.mark.parametrize("d", [32, 64, 128])
    def test_tensor_map_geometry_of_packed_qkv(self, d):
        """q, k and v as the model slices them from one packed (B, S,
        H + 2 Hkv, D) projection: strides in bytes, 16-byte multiples;
        the box one swizzle row wide."""
        b, s, h, hkv = 2, 77, 8, 2
        qkv = torch.zeros(b, s, h + 2 * hkv, d, dtype=torch.bfloat16)
        q, k = qkv[:, :, :h], qkv[:, :, h:h + hkv]
        row = (h + 2 * hkv) * d * 2
        cols = min(d, 64)
        assert fa_ops.tensor_map_geometry(q, fa_ops.BLOCK_Q) == (
            d, h, s, b, d * 2, row, row * s, cols, 1, 128, 1)
        assert fa_ops.tensor_map_geometry(k, fa_ops.BLOCK_KV) == (
            d, hkv, s, b, d * 2, row, row * s, cols, 1, 64, 1)
        for t in (q, k):
            geo = fa_ops.tensor_map_geometry(t, 64)
            assert all(x % 16 == 0 for x in geo[4:7])
            assert geo[7] * 2 in (64, 128)

    def test_tensor_map_geometry_of_mla_heads(self):
        """MiniCPM3's prefill: q and k rows of 96 bf16 values take a
        64-byte swizzle (boxes of 32 columns, three to a row), v its own
        D of 64 with the 128-byte swizzle."""
        b, s, h = 1, 1024, 40
        q = torch.zeros(b, s, h, 96, dtype=torch.bfloat16)
        v = torch.zeros(b, s, h, 64, dtype=torch.bfloat16)
        assert fa_ops.tensor_map_geometry(q, fa_ops.BLOCK_Q) == (
            96, h, s, b, 192, h * 192, h * 192 * s, 32, 1, 128, 1)
        assert fa_ops.tensor_map_geometry(q, fa_ops.BLOCK_KV)[7:] == (
            32, 1, 64, 1)
        assert fa_ops.tensor_map_geometry(v, fa_ops.BLOCK_KV) == (
            64, h, s, b, 128, h * 128, h * 128 * s, 64, 1, 64, 1)

    def test_tensor_map_geometry_of_zamba2_heads(self):
        """Zamba2's rows of 112 bf16 values (224 bytes) take the 128-byte
        swizzle over two boxes of 64 columns; the map's D stays 112, so
        TMA fills the tile's columns 112 to 127 with zeros."""
        b, s, h = 1, 1024, 32
        t = torch.zeros(b, s, h, 112, dtype=torch.bfloat16)
        assert fa_ops.tensor_map_geometry(t, fa_ops.BLOCK_Q) == (
            112, h, s, b, 224, h * 224, h * 224 * s, 64, 1, 128, 1)
        assert fa_ops.tensor_map_geometry(t, fa_ops.BLOCK_KV)[7:] == (
            64, 1, 64, 1)
        qkv = torch.zeros(2, 77, 3 * 8, 112, dtype=torch.bfloat16)
        geo = fa_ops.tensor_map_geometry(qkv[:, :, 8:16], fa_ops.BLOCK_KV)
        assert geo == (112, 8, 77, 2, 224, 24 * 224, 24 * 224 * 77, 64, 1,
                       64, 1)
        assert all(x % 16 == 0 for x in geo[4:7])

    def test_instances_of_the_cuda_kernels(self):
        """The CUDA wrappers' checks: the five (q/k, v) pairs in both
        dtypes pass, Zamba2's (112, 112) among them; any other pair or
        dtype is refused."""
        for d, dv in ((32, 32), (64, 64), (128, 128), (96, 64), (112, 112)):
            for dtype in (torch.float32, torch.bfloat16):
                fa_ops.check_instance("attention_bhsd", dtype, d, dv)
        for d, dv in ((112, 64), (96, 96), (64, 96), (48, 48)):
            with pytest.raises(ValueError, match=r"head dims in"):
                fa_ops.check_instance("decode_bhd", torch.bfloat16, d, dv)
        with pytest.raises(ValueError, match="float16"):
            fa_ops.check_instance("attention_bhsd", torch.float16, 96, 64)

    def test_tensor_map_geometry_of_unit_dims(self):
        """Size-1 dims get packed strides, whatever the view says."""
        t = torch.zeros(1, 300, 16, 128, dtype=torch.bfloat16)[:, :, 3:4]
        assert t.stride() == (300 * 16 * 128, 16 * 128, 128, 1)
        assert fa_ops.tensor_map_geometry(t, 64) == (
            128, 1, 300, 1, 256, 16 * 128 * 2, 16 * 128 * 2 * 300, 64, 1,
            64, 1)
        one = torch.zeros(3, 1, 4, 64, dtype=torch.bfloat16)
        assert fa_ops.tensor_map_geometry(one, 128) == (
            64, 4, 1, 3, 128, 512, 512, 64, 1, 128, 1)


class TestModelAttention:
    """`repro_torch.models.attention` vs `repro.models.attention`."""

    def test_causal_mask(self):
        for window, off in ((0, 0), (3, 0), (4, 5)):
            np.testing.assert_array_equal(
                attn.causal_mask(8, 13, window, off).numpy(),
                np.asarray(ref_attn.causal_mask(8, 13, window, off)))

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("window", [0, 5])
    def test_self_attention(self, dtype, window):
        q, k, v = _draw(6, (2, 24, 8, 32), (2, 24, 2, 32), (2, 24, 2, 32))
        (tq, jq), (tk, jk), (tv, jv) = (_both(x, dtype) for x in (q, k, v))
        _close(attn.self_attention(tq, tk, tv, window=window),
               ref_attn.self_attention(jq, jk, jv, window=window),
               **tol(dtype))

    @pytest.mark.parametrize("chunk", [0, 16])
    def test_bidirectional_window(self, chunk):
        """As in the reference, a window masks a bidirectional attention
        only in the blocked formulation (chunk < keys)."""
        q, k, v = _draw(9, (1, 40, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16))
        kw = dict(causal=False, window=7, chunk=chunk)
        _close(attn.self_attention(*map(torch.from_numpy, (q, k, v)), **kw),
               ref_attn.self_attention(*map(jnp.asarray, (q, k, v)), **kw),
               **tol("float32"))

    def test_attention_unmasked_and_cross(self):
        q, k, v = _draw(7, (2, 5, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16))
        _close(attn.cross_attention(*map(torch.from_numpy, (q, k, v))),
               ref_attn.cross_attention(*map(jnp.asarray, (q, k, v))),
               **tol("float32"))

    @pytest.mark.parametrize("causal,window", [(True, 0), (True, 7),
                                               (False, 0)])
    def test_chunked(self, causal, window):
        """40 keys in chunks of 16: the reference pads the last chunk."""
        q, k, v = _draw(8, (1, 40, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16))
        kw = dict(causal=causal, window=window, chunk=16)
        port = attn.chunked_self_attention(*map(torch.from_numpy, (q, k, v)),
                                           **kw)
        _close(port, ref_attn.chunked_self_attention(
            *map(jnp.asarray, (q, k, v)), **kw), **tol("float32"))
        _close(attn.self_attention(*map(torch.from_numpy, (q, k, v)), **kw),
               port, **tol("float32"))

    @pytest.mark.parametrize("pos", [11, [3, 20]], ids=["scalar", "slots"])
    @pytest.mark.parametrize("window", [0, 4])
    def test_decode_attention(self, pos, window):
        q, kc, vc = _draw(9, (2, 1, 8, 32), (2, 24, 2, 32), (2, 24, 2, 32))
        port = attn.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                                     torch.tensor(pos, dtype=torch.int32),
                                     window=window)
        ref = ref_attn.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                        jnp.asarray(pos, jnp.int32),
                                        window=window)
        _close(port, ref, **tol("float32"))
        # one GPU has no mesh: the length-sharded variant is plain decode
        _close(attn.decode_attention_length_sharded(
            *map(torch.from_numpy, (q, kc, vc)),
            torch.tensor(pos, dtype=torch.int32), window=window), port,
            rtol=0, atol=0)

    @pytest.mark.parametrize("pos", [6, [2, 9]], ids=["scalar", "slots"])
    def test_cache_update(self, pos):
        kc, vc, kn, vn = _draw(10, (2, 12, 2, 8), (2, 12, 2, 8),
                               (2, 1, 2, 8), (2, 1, 2, 8))
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        out_k, out_v = attn.cache_update(tk, tv, torch.from_numpy(kn),
                                         torch.from_numpy(vn),
                                         torch.tensor(pos))
        assert out_k is tk and out_v is tv          # written in place
        ref_k, ref_v = ref_attn.cache_update(
            *map(jnp.asarray, (kc, vc, kn, vn)), jnp.asarray(pos, jnp.int32))
        np.testing.assert_array_equal(out_k.numpy(), np.asarray(ref_k))
        np.testing.assert_array_equal(out_v.numpy(), np.asarray(ref_v))

    def test_self_attention_mla_head_dims(self):
        """F1: MLA's q/k head dim 96 with a v head dim of 64, causal."""
        q, k, v = _draw(12, (1, 8, 4, 96), (1, 8, 4, 96), (1, 8, 4, 64))
        port = attn.self_attention(*map(torch.from_numpy, (q, k, v)))
        assert port.shape == (1, 8, 4, 64)
        _close(port, ref_attn.self_attention(*map(jnp.asarray, (q, k, v))),
               **tol("float32"))

    @pytest.mark.parametrize("pos", [11, [3, 16]], ids=["scalar", "slots"])
    def test_decode_attention_mla_head_dims(self, pos):
        """F1: a (1, 16, 4, 96) k cache beside a (1, 16, 4, 64) v cache."""
        b = 1 if isinstance(pos, int) else 2
        q, kc, vc = _draw(13, (b, 1, 8, 96), (b, 16, 4, 96), (b, 16, 4, 64))
        port = attn.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                                     torch.tensor(pos, dtype=torch.int32))
        assert port.shape == (b, 1, 8, 64)
        ref = ref_attn.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                        jnp.asarray(pos, jnp.int32))
        _close(port, ref, **tol("float32"))

    def test_mla_head_dims_refused_off_the_cpu(self):
        """Off the CPU MLA's (96, 64) passes the wrappers' checks (here, on
        the meta device, it reaches the device check); a v head dim other
        than q's that is no instance of the kernels is refused, with or
        without the kernel, and never takes the plain route."""
        q = torch.zeros(1, 8, 4, 96, device="meta")
        v = torch.zeros(1, 8, 4, 64, device="meta")
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fa_ops.attention_bhsd(q, q, v)
        with pytest.raises(ValueError, match="no kernel for device meta"):
            dec_ops.decode_bhd(q[:, 0], q, v, 1)
        odd = torch.zeros(1, 8, 4, 32, device="meta")
        for use_kernel in (True, False):
            with pytest.raises(ValueError, match="no instance"):
                fa_ops.attention_bhsd(q, q, odd, use_kernel=use_kernel)
            with pytest.raises(ValueError, match="no instance"):
                dec_ops.decode_bhd(q[:, 0], q, odd, 1,
                                   use_kernel=use_kernel)

    def test_cpu_path_launches_no_kernel(self):
        q, k, v = (torch.from_numpy(x) for x in
                   _draw(11, (1, 16, 4, 32), (1, 16, 2, 32),
                         (1, 16, 2, 32)))
        before = (fa_ops.KERNEL.launches, dec_ops.KERNEL.launches)
        attn.self_attention(q, k, v)
        attn.decode_attention(q[:, :1], k, v, torch.tensor(5))
        assert (fa_ops.KERNEL.launches, dec_ops.KERNEL.launches) == before
