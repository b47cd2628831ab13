"""Models of the port (`repro_torch.models`, `repro_torch.configs`)
against the reference (`repro.models`, `repro.configs`), on the CPU.

The reference initialises its parameters (`Model.init`) and
`params_from_jax` hands them to the port, so both compute the same
function. Logits are compared at float32 to rtol/atol 1e-4, and at
bfloat16 to the reference's own `test_decode_matches_prefill` bound
(rtol 0.08, atol 0.15); the bfloat16 paths round at other places in the
two frameworks (for one, XLA and PyTorch fuse SiLU differently). On the
CPU the Mamba2 prefill's scan is `mamba2.ssd_chunked`, what the
reference's model computes; its CUDA kernel is held on the card
(`tests/test_torch_cuda.py`). The mixture-of-experts models
(granite-moe-3b-a800m, mixtral-8x22b) and MLA (minicpm3-4b, with
`mla_absorb` off and on) are held the same way, and so are the hybrid
(zamba2-7b: Mamba2 layers and a shared attention block), the vision
frontend (internvl2-2b, with and without patch embeddings) and the
encoder-decoder (seamless-m4t-large-v2, over frame embeddings), every
cache tensor the reference keeps included.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_arch_names as ref_arch_names
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import Model as RefModel
from repro.models import layers as ref_layers
from repro_torch.configs import (PORT_ONLY, all_arch_names, get_config,
                                 get_smoke_config)
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.models import Model, params_from_jax
from repro_torch.models import layers

BOUNDS = {"float32": dict(rtol=1e-4, atol=1e-4),
          "bfloat16": dict(rtol=0.08, atol=0.15)}
DENSE = ["granite-3-8b", "llama3-8b", "phi3-medium-14b"]
MOE_MLA = ["granite-moe-3b-a800m", "mixtral-8x22b", "minicpm3-4b"]
# (arch, overrides): MLA's decode with and without the absorbed path
MOE_MLA_CASES = {"granite-moe-3b-a800m": ("granite-moe-3b-a800m", {}),
                 "mixtral-8x22b": ("mixtral-8x22b", {}),
                 "minicpm3-4b": ("minicpm3-4b", {}),
                 "minicpm3-4b-absorb": ("minicpm3-4b", {"mla_absorb": True})}
# the hybrid, vision-frontend and encoder-decoder families
FAMILIES = ["zamba2-7b", "internvl2-2b", "seamless-m4t-large-v2"]


def _embeds(cfg, batch: int, seed: int = 7) -> np.ndarray | None:
    """A frontend's embeddings (batch, frontend_tokens, d_model), normal at
    the embedding table's std, or None for a model without a frontend."""
    if cfg.frontend == "none":
        return None
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, cfg.frontend_tokens, cfg.d_model))
            * 0.02).astype(np.float32)


def _leaves(cache, prefix=()):
    """(path, tensor) of every tensor of a nested cache, "pos" included."""
    for key, val in cache.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        elif val is not None:
            yield prefix + (key,), val


def _at(cache, path):
    for key in path:
        cache = cache[key]
    return cache


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(arch: str, dtype: str, **overrides):
    """(reference model, its params, port model with the same params)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                              **overrides)
    ref_cfg = dataclasses.replace(ref_get_smoke_config(arch), dtype=dtype,
                                  **overrides)
    ref = RefModel(ref_cfg)
    params = ref.init(jax.random.key(0))
    port = Model(cfg, device="cpu")
    port.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray,
                                                           params)))
    return ref, params, port


def _own_fields_at_defaults(mine, theirs) -> dict:
    """The port's config as a dict of the reference's fields, after
    checking that every field only the port has is at its default (so the
    port computes what the reference's config describes)."""
    ours, ref = dataclasses.asdict(mine), dataclasses.asdict(theirs)
    own = {f.name: f.default for f in dataclasses.fields(mine)
           if f.name not in ref}
    assert {k: ours[k] for k in own} == own
    return {k: v for k, v in ours.items() if k in ref}


class TestConfigs:
    def test_arch_names(self):
        """The reference's ten architectures, in its order, then the
        port's own (`PORT_ONLY`), named."""
        assert all_arch_names() == ref_arch_names() + PORT_ONLY
        assert PORT_ONLY == ["deepseek-v2-lite"]

    @pytest.mark.parametrize("arch", ref_arch_names())
    def test_equal_to_reference(self, arch):
        for mine, theirs in ((get_config(arch), ref_get_config(arch)),
                             (get_smoke_config(arch),
                              ref_get_smoke_config(arch))):
            assert _own_fields_at_defaults(mine, theirs) == \
                dataclasses.asdict(theirs)
            assert mine.param_count() == theirs.param_count()
            assert mine.padded_vocab == theirs.padded_vocab


class TestLayers:
    def test_rms_norm(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 5, 64)).astype(np.float32)
        w = rng.standard_normal(64).astype(np.float32)
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            out = layers.rms_norm(torch.from_numpy(x).to(dt),
                                  torch.from_numpy(w).to(dt))
            ref = ref_layers.rms_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
            assert out.dtype == dt
            np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-2,
                                       atol=1e-2 if dt == torch.bfloat16
                                       else 1e-6)

    def test_rope(self):
        np.testing.assert_allclose(
            layers.rope_frequencies(128, 500000.0).numpy(),
            np.asarray(ref_layers.rope_frequencies(128, 500000.0)),
            rtol=1e-6)
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
        pos = np.arange(7)[None, :] + np.array([[0], [40]])
        out = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                10000.0)
        ref = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                    10000.0)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)

    def test_swiglu_embed_unembed(self):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 3, 16)).astype(np.float32)
        wg, wu = (rng.standard_normal((16, 40)).astype(np.float32) * 0.1
                  for _ in range(2))
        wd = rng.standard_normal((40, 16)).astype(np.float32) * 0.1
        np.testing.assert_allclose(
            layers.swiglu(*map(torch.from_numpy, (x, wg, wu, wd))).numpy(),
            np.asarray(ref_layers.swiglu(*map(jnp.asarray, (x, wg, wu, wd)))),
            rtol=1e-5, atol=1e-5)
        cfg = get_smoke_config("llama3-8b")
        table = rng.standard_normal((cfg.padded_vocab, 16)).astype(
            np.float32)
        toks = rng.integers(0, cfg.vocab_size, (2, 3))
        np.testing.assert_array_equal(
            layers.embed(torch.from_numpy(toks), torch.from_numpy(table)),
            np.asarray(ref_layers.embed(jnp.asarray(toks),
                                        jnp.asarray(table))))
        logits = layers.unembed(torch.from_numpy(x), torch.from_numpy(table),
                                cfg)
        ref = ref_layers.unembed(jnp.asarray(x), jnp.asarray(table), cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
        assert (logits[..., cfg.vocab_size:] ==
                torch.finfo(torch.float32).min).all()

    def test_cross_entropy(self):
        rng = np.random.default_rng(3)
        logits = rng.standard_normal((2, 6, 50)).astype(np.float32)
        labels = rng.integers(0, 50, (2, 6))
        mask = (rng.random((2, 6)) > 0.3).astype(np.float32)
        for m in (None, mask):
            out = layers.cross_entropy_loss(
                torch.from_numpy(logits), torch.from_numpy(labels),
                None if m is None else torch.from_numpy(m))
            ref = ref_layers.cross_entropy_loss(
                jnp.asarray(logits), jnp.asarray(labels),
                None if m is None else jnp.asarray(m))
            assert float(out) == pytest.approx(float(ref), rel=1e-6)


class TestLogitsMatchReference:
    """Prefill, then decode steps fed with the same tokens, through both
    models with the same parameters."""

    @pytest.mark.parametrize("arch", ["llama3-8b", "granite-3-8b"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_prefill_and_decode(self, arch, dtype):
        ref, params, port = _pair(arch, dtype)
        vocab = port.cfg.vocab_size
        rng = np.random.default_rng(4)
        toks = rng.integers(0, vocab, (2, 12))
        ref_logits, ref_cache = ref.prefill(params, jnp.asarray(toks,
                                                                jnp.int32),
                                            None, max_len=20)
        logits, cache = port.prefill(torch.from_numpy(toks), max_len=20)
        assert logits.shape == (2, 1, port.cfg.padded_vocab)
        np.testing.assert_allclose(_np(logits)[..., :vocab],
                                   _np(ref_logits)[..., :vocab],
                                   **BOUNDS[dtype])
        np.testing.assert_allclose(_np(cache["k"]), _np(ref_cache["k"]),
                                   **BOUNDS[dtype])
        for _ in range(4):
            tok = rng.integers(0, vocab, (2, 1))
            ref_logits, ref_cache = ref.decode_step(
                params, ref_cache, jnp.asarray(tok, jnp.int32))
            logits, cache = port.decode_step(cache, torch.from_numpy(tok))
            np.testing.assert_allclose(_np(logits)[..., :vocab],
                                       _np(ref_logits)[..., :vocab],
                                       **BOUNDS[dtype])
        assert int(cache["pos"]) == int(ref_cache["pos"]) == 16

    def test_per_slot_positions(self):
        """The engine's decode: a (B,) pos, one slot behind the other."""
        ref, params, port = _pair("llama3-8b", "float32")
        rng = np.random.default_rng(5)
        toks = rng.integers(0, 1000, (2, 9))
        ref_cache = ref.prefill(params, jnp.asarray(toks, jnp.int32), None,
                                max_len=16)[1]
        cache = port.prefill(torch.from_numpy(toks), max_len=16)[1]
        ref_cache["pos"] = jnp.asarray([9, 5], jnp.int32)
        cache["pos"] = torch.tensor([9, 5], dtype=torch.int32)
        for _ in range(3):
            tok = rng.integers(0, 1000, (2, 1))
            ref_logits, ref_cache = ref.decode_step(
                params, ref_cache, jnp.asarray(tok, jnp.int32))
            logits, cache = port.decode_step(cache, torch.from_numpy(tok))
            np.testing.assert_allclose(_np(logits)[..., :1000],
                                       _np(ref_logits)[..., :1000],
                                       **BOUNDS["float32"])
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(ref_cache["pos"]))

    @pytest.mark.parametrize("case", sorted(MOE_MLA_CASES))
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_moe_and_mla(self, case, dtype):
        """Prefill, then four decode steps with a per-slot pos (one slot
        five tokens behind the other), every cache the reference keeps
        (MLA: the latent) and every logit at `BOUNDS`."""
        arch, overrides = MOE_MLA_CASES[case]
        ref, params, port = _pair(arch, dtype, **overrides)
        vocab = port.cfg.vocab_size
        rng = np.random.default_rng(4)
        toks = rng.integers(0, vocab, (2, 12))
        ref_logits, ref_cache = ref.prefill(
            params, jnp.asarray(toks, jnp.int32), None, max_len=20)
        logits, cache = port.prefill(torch.from_numpy(toks), max_len=20)
        assert set(cache) == set(ref_cache)
        np.testing.assert_allclose(_np(logits)[..., :vocab],
                                   _np(ref_logits)[..., :vocab],
                                   **BOUNDS[dtype])
        for key in set(cache) - {"pos"}:
            assert cache[key].shape == ref_cache[key].shape
            np.testing.assert_allclose(_np(cache[key]), _np(ref_cache[key]),
                                       **BOUNDS[dtype])
        ref_cache["pos"] = jnp.asarray([12, 7], jnp.int32)
        cache["pos"] = torch.tensor([12, 7], dtype=torch.int32)
        for _ in range(4):
            tok = rng.integers(0, vocab, (2, 1))
            ref_logits, ref_cache = ref.decode_step(
                params, ref_cache, jnp.asarray(tok, jnp.int32))
            logits, cache = port.decode_step(cache, torch.from_numpy(tok))
            np.testing.assert_allclose(_np(logits)[..., :vocab],
                                       _np(ref_logits)[..., :vocab],
                                       **BOUNDS[dtype])
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(ref_cache["pos"]))

    @pytest.mark.parametrize("arch", FAMILIES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_hybrid_vlm_and_encdec(self, arch, dtype):
        """Zamba2, InternVL2 (with its patch embeddings) and Seamless (over
        its frame embeddings): prefill logits and every cache tensor the
        reference keeps (the hybrid's groups and tail, the encoder
        memory's keys and values), then four decode steps with a
        per-slot pos (one slot five tokens behind the other), all at
        `BOUNDS`."""
        ref, params, port = _pair(arch, dtype)
        cfg = port.cfg
        vocab = cfg.vocab_size
        rng = np.random.default_rng(4)
        toks = rng.integers(0, vocab, (2, 12))
        emb = _embeds(cfg, 2)
        max_len = 20 + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
        ref_logits, ref_cache = ref.prefill(
            params, jnp.asarray(toks, jnp.int32),
            None if emb is None else jnp.asarray(emb), max_len=max_len)
        logits, cache = port.prefill(
            torch.from_numpy(toks), max_len=max_len,
            embeds=None if emb is None else torch.from_numpy(emb))
        np.testing.assert_allclose(_np(logits)[..., :vocab],
                                   _np(ref_logits)[..., :vocab],
                                   **BOUNDS[dtype])
        ref_leaves = dict(_leaves(ref_cache))
        assert {path for path, _ in _leaves(cache)} == set(ref_leaves)
        for path, want in ref_leaves.items():
            got = _at(cache, path)
            assert tuple(got.shape) == tuple(want.shape), path
            np.testing.assert_allclose(_np(got), _np(want), **BOUNDS[dtype],
                                       err_msg=str(path))
        s = int(ref_cache["pos"])
        ref_cache["pos"] = jnp.asarray([s, s - 5], jnp.int32)
        cache["pos"] = torch.tensor([s, s - 5], dtype=torch.int32)
        for _ in range(4):
            tok = rng.integers(0, vocab, (2, 1))
            ref_logits, ref_cache = ref.decode_step(
                params, ref_cache, jnp.asarray(tok, jnp.int32))
            logits, cache = port.decode_step(cache, torch.from_numpy(tok))
            np.testing.assert_allclose(_np(logits)[..., :vocab],
                                       _np(ref_logits)[..., :vocab],
                                       **BOUNDS[dtype])
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(ref_cache["pos"]))
        for path, want in _leaves(ref_cache):
            np.testing.assert_allclose(_np(_at(cache, path)), _np(want),
                                       **BOUNDS[dtype], err_msg=str(path))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_vision_model_reads_text_alone(self, dtype):
        """InternVL2 without patch embeddings, as the engine prefills it:
        the token embeddings alone, positions from 0."""
        ref, params, port = _pair("internvl2-2b", dtype)
        toks = np.random.default_rng(9).integers(0, 1000, (2, 10))
        ref_logits, ref_cache = ref.prefill(
            params, jnp.asarray(toks, jnp.int32), None, max_len=16)
        logits, cache = port.prefill(torch.from_numpy(toks), max_len=16)
        assert int(cache["pos"]) == int(ref_cache["pos"]) == 10
        np.testing.assert_allclose(_np(logits)[..., :1000],
                                   _np(ref_logits)[..., :1000],
                                   **BOUNDS[dtype])
        np.testing.assert_allclose(_np(cache["k"]), _np(ref_cache["k"]),
                                   **BOUNDS[dtype])

    @pytest.mark.parametrize("ring", [False, True], ids=["window", "ring"])
    def test_sliding_window(self, ring):
        """A window of 8 over 12 prompt tokens and 6 decode steps, as a
        masked full cache and as the `swa_ring` ring buffer."""
        ref, params, port = _pair("llama3-8b", "float32", sliding_window=8,
                                  swa_ring=ring)
        rng = np.random.default_rng(6)
        toks = rng.integers(0, 1000, (1, 12))
        ref_logits, ref_cache = ref.prefill(
            params, jnp.asarray(toks, jnp.int32), None, max_len=20)
        logits, cache = port.prefill(torch.from_numpy(toks), max_len=20)
        assert cache["k"].shape[2] == (8 if ring else 20)
        for _ in range(6):
            np.testing.assert_allclose(_np(logits)[..., :1000],
                                       _np(ref_logits)[..., :1000],
                                       **BOUNDS["float32"])
            tok = rng.integers(0, 1000, (1, 1))
            ref_logits, ref_cache = ref.decode_step(
                params, ref_cache, jnp.asarray(tok, jnp.int32))
            logits, cache = port.decode_step(cache, torch.from_numpy(tok))


@pytest.mark.parametrize("arch", DENSE + ["mamba2-2.7b"] + MOE_MLA
                         + FAMILIES)
def test_decode_matches_prefill(arch):
    """`tests/test_models.py::test_decode_matches_prefill` on the port:
    decoding token t with the cache of tokens [0..t) reproduces the
    full-prefill logits at t (the smoke configs are bfloat16). As there,
    MoE's capacity drops depend on the sequence length, so its capacity
    factor is raised to the expert count, where none drop. A frontend's
    embeddings go into both prefills alike."""
    cfg = get_smoke_config(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=float(cfg.num_experts))
    model = Model(cfg, device="cpu", seed=2)
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)))
    emb = _embeds(cfg, 2)
    emb = None if emb is None else torch.from_numpy(emb)
    max_len = 16 + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    full_logits, _ = model.prefill(tokens, max_len=max_len, embeds=emb)
    _, cache = model.prefill(tokens[:, :12], max_len=max_len, embeds=emb)
    for i in range(12, 16):
        logits, cache = model.decode_step(cache, tokens[:, i:i + 1])
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full_logits[:, 0]),
                               rtol=0.08, atol=0.15)


@pytest.mark.parametrize("arch,absorb", [("minicpm3-4b", False),
                                         ("minicpm3-4b", True),
                                         ("llama3-8b", False)])
def test_decode_gives_mla_rope_part_apart(arch, absorb):
    """Each MLA layer of a decode step gives B3 K's rope part apart, read
    from the latent cache: `num_layers` counted calls a step; none with
    `mla_absorb` (no B3) and none for GQA. The prefill makes none."""
    cfg = dataclasses.replace(get_smoke_config(arch), mla_absorb=absorb)
    model = Model(cfg, device="cpu", seed=3)
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 6)))
    before = dec_ops.rope_apart_calls
    _, cache = model.prefill(tokens[:, :4], max_len=8)
    assert dec_ops.rope_apart_calls == before
    for i in range(4, 6):
        _, cache = model.decode_step(cache, tokens[:, i:i + 1])
    apart = cfg.attn_type == "mla" and not absorb
    assert dec_ops.rope_apart_calls - before == \
        (2 * cfg.num_layers if apart else 0)


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-2.7b", "minicpm3-4b"]
                         + FAMILIES)
def test_cache_batch_dim(arch):
    """`Model.cache_batch_dim` names the axis on which the caches of
    single sequences stack into the cache of their batch: the only axis
    where `empty_cache` of 1 and of 3 sequences differ, and the one on
    which two prefills of one sequence each equal a prefill of both."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = Model(cfg, device="cpu", seed=3)
    one, three = model.empty_cache(1, 8), model.empty_cache(3, 8)
    for path, t in _leaves(one):
        dim = model.cache_batch_dim(path[0])
        want = list(t.shape)
        want[dim] = 3
        assert list(_at(three, path).shape) == want, path
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 6)))
    emb = _embeds(cfg, 2)
    emb = None if emb is None else torch.from_numpy(emb)
    max_len = 8 + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    _, both = model.prefill(tokens, max_len=max_len, embeds=emb)
    singles = [model.prefill(tokens[i:i + 1], max_len=max_len,
                             embeds=None if emb is None else emb[i:i + 1])[1]
               for i in range(2)]
    for path, t in _leaves(both):
        if path == ("pos",):
            continue
        stacked = torch.cat([_at(c, path) for c in singles],
                            dim=model.cache_batch_dim(path[0]))
        np.testing.assert_allclose(_np(stacked), _np(t), **BOUNDS["float32"],
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", ["zamba2-7b", "seamless-m4t-large-v2"])
def test_engine_refuses_hybrid_and_encdec(arch):
    """The model runs them; the engine refuses them, in the reference's
    words (`repro.serving.engine`): drive them through `Model`."""
    from repro_torch.serving.engine import InferenceEngine
    model = Model(get_smoke_config(arch), device="cpu")
    with pytest.raises(NotImplementedError,
                       match=r"engine batching supports decoder-only "
                             r"families \(dense/moe/vlm/ssm\); use "
                             r"Model.decode_step directly"):
        InferenceEngine(model, max_batch=2, max_len=16)


def test_encdec_prefill_needs_frame_embeddings():
    model = Model(get_smoke_config("seamless-m4t-large-v2"), device="cpu")
    with pytest.raises(ValueError, match="frame embeddings"):
        model.prefill(torch.zeros((1, 4), dtype=torch.int64))


def test_state_dict_names_match_params_from_jax():
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              dtype="float32")
    params = RefModel(cfg).init(jax.random.key(0))
    state = params_from_jax(cfg, jax.tree.map(np.asarray, params))
    model = Model(cfg, device="cpu")
    assert state.keys() == model.state_dict().keys()
    for name, t in model.state_dict().items():
        assert state[name].shape == t.shape, name


@pytest.mark.parametrize("arch", MOE_MLA)
def test_moe_and_mla_state_dict_names_match_params_from_jax(arch):
    """The reference's MoE (router, stacked experts) and MLA (low-rank
    projections) trees convert name for name, shape for shape and dtype
    for dtype (the router stays float32 in a bfloat16 model)."""
    cfg = get_smoke_config(arch)
    params = RefModel(cfg).init(jax.random.key(0))
    state = params_from_jax(cfg, jax.tree.map(np.asarray, params))
    model = Model(cfg, device="cpu")
    assert state.keys() == model.state_dict().keys()
    for name, t in model.state_dict().items():
        assert state[name].shape == t.shape, name
        assert state[name].dtype == t.dtype, name
    if cfg.num_experts:
        assert model.layers[0].mlp["router"].dtype == torch.float32
        assert model.layers[0].mlp["w_gate"].shape == (
            cfg.num_experts, cfg.d_model, cfg.d_ff)
    else:
        assert "kv_down" in model.layers[0].attn


@pytest.mark.parametrize("arch", FAMILIES)
def test_hybrid_vlm_and_encdec_state_dict_names_match_params_from_jax(arch):
    """The hybrid's Mamba2 layers and `shared` block, InternVL2's decoder
    and Seamless's decoder (`ln_x`, `xattn`), `enc_layers` and
    `enc_final_ln` convert name for name, shape for shape and dtype for
    dtype."""
    cfg = get_smoke_config(arch)
    params = RefModel(cfg).init(jax.random.key(0))
    state = params_from_jax(cfg, jax.tree.map(np.asarray, params))
    model = Model(cfg, device="cpu")
    assert state.keys() == model.state_dict().keys()
    for name, t in model.state_dict().items():
        assert state[name].shape == t.shape, name
        assert state[name].dtype == t.dtype, name
    if cfg.family == "hybrid":
        assert "shared.attn.wq" in state and "layers.0.w_z" in state
    if cfg.is_encdec:
        assert f"enc_layers.{cfg.encoder_layers - 1}.mlp.w_up" in state
        assert "layers.0.xattn.wk" in state and "enc_final_ln" in state


@pytest.mark.parametrize("arch", MOE_MLA + FAMILIES)
def test_full_moe_and_mla_configs_are_ported(arch, monkeypatch):
    """The full configs pass the port's check (mixtral-8x22b's 281 GB
    fit no single card: it is held at its smoke size) and, without a
    card, refuse at the device before allocating anything."""
    from repro_torch.models.model import check_supported
    check_supported(get_config(arch))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(get_config(arch))


def test_bfloat16_params_convert_bit_for_bit():
    cfg = get_smoke_config("llama3-8b")
    params = RefModel(cfg).init(jax.random.key(1))
    state = params_from_jax(cfg, jax.tree.map(np.asarray, params))
    assert state["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        state["embed"].view(torch.int16).numpy(),
        np.asarray(params["embed"]).view(np.int16))


def test_init_is_seeded_and_in_the_config_dtype():
    cfg = get_smoke_config("llama3-8b")
    a, b = Model(cfg, device="cpu", seed=3), Model(cfg, device="cpu", seed=3)
    c = Model(cfg, device="cpu", seed=4)
    assert a.embed.dtype == torch.bfloat16
    assert torch.equal(a.layers[1].mlp["w_up"], b.layers[1].mlp["w_up"])
    assert not torch.equal(a.embed, c.embed)
    std = float(a.layers[0].attn["wq"].float().std())
    assert 0.018 < std < 0.022


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(get_smoke_config("llama3-8b"))


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-7b"])
def test_training_is_not_ported(arch, monkeypatch):
    """No kernel has a backward, in the reference or in the port, so the
    training forward is not ported to the kernels: `loss` asks each
    attention for its plain version (`use_kernel=False`) and calls
    neither kernel wrapper it could reach (the prefill attention's, the
    SSD scan's). (`tests/test_torch_training.py` holds `loss` against the
    reference.)"""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import attention
    asked = []
    real = attention.self_attention

    def spy(*args, use_kernel=True, **kw):
        asked.append(use_kernel)
        return real(*args, use_kernel=use_kernel, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the training forward called a kernel's "
                             "wrapper")
    monkeypatch.setattr(attention, "self_attention", spy)
    monkeypatch.setattr(attention, "attention_bhsd", refuse)
    monkeypatch.setattr(ssd_ops, "ssd", refuse)
    cfg = get_smoke_config(arch)
    loss = Model(cfg, device="cpu").loss(
        {"tokens": np.arange(24).reshape(2, 12) % cfg.vocab_size})
    assert torch.isfinite(loss)
    assert asked and not any(asked)


class TestMamba2:
    """The ssm family: Mamba2's smoke config through both models."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_prefill_and_decode(self, dtype):
        ref, params, port = _pair("mamba2-2.7b", dtype)
        vocab = port.cfg.vocab_size
        rng = np.random.default_rng(4)
        toks = rng.integers(0, vocab, (2, 12))
        ref_logits, ref_cache = ref.prefill(
            params, jnp.asarray(toks, jnp.int32), None, max_len=20)
        logits, cache = port.prefill(torch.from_numpy(toks), max_len=20)
        cfg = port.cfg
        assert cache["conv"].shape == (cfg.num_layers, 2,
                                       cfg.ssm_conv_width - 1,
                                       cfg.d_inner + 2 * cfg.ssm_state)
        assert cache["conv"].dtype == port.dtype
        assert cache["state"].dtype == torch.float32
        np.testing.assert_allclose(_np(logits)[..., :vocab],
                                   _np(ref_logits)[..., :vocab],
                                   **BOUNDS[dtype])
        for key in ("conv", "state"):
            np.testing.assert_allclose(_np(cache[key]), _np(ref_cache[key]),
                                       **BOUNDS[dtype])
        for _ in range(4):
            tok = rng.integers(0, vocab, (2, 1))
            ref_logits, ref_cache = ref.decode_step(
                params, ref_cache, jnp.asarray(tok, jnp.int32))
            logits, cache = port.decode_step(cache, torch.from_numpy(tok))
            np.testing.assert_allclose(_np(logits)[..., :vocab],
                                       _np(ref_logits)[..., :vocab],
                                       **BOUNDS[dtype])
        np.testing.assert_allclose(_np(cache["state"]),
                                   _np(ref_cache["state"]),
                                   **BOUNDS[dtype])
        assert int(cache["pos"]) == int(ref_cache["pos"]) == 16

    @pytest.mark.parametrize("prompt", [1, 2])
    def test_short_prompt_then_decode(self, prompt):
        """ROADMAP R6: after a prompt shorter than the conv window (W - 1
        = 3 tokens), decoding reproduces the port's own full-prefill
        logits at every next position; the reference raises here. The
        smoke config is bfloat16: the bound of test_decode_matches_prefill."""
        cfg = get_smoke_config("mamba2-2.7b")
        model = Model(cfg, device="cpu", seed=2)
        tokens = torch.from_numpy(
            np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 6)))
        _, cache = model.prefill(tokens[:, :prompt])
        assert cache["conv"].shape[2] == cfg.ssm_conv_width - 1
        for i in range(prompt, 6):
            logits, cache = model.decode_step(cache, tokens[:, i:i + 1])
            full, _ = model.prefill(tokens[:, :i + 1])
            np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, 0]),
                                       rtol=0.08, atol=0.15)

    @pytest.mark.parametrize("prompt", [1, 2])
    def test_hybrid_short_prompt_then_decode(self, prompt):
        """Zamba2 after a prompt shorter than the conv window: its Mamba2
        layers keep W - 1 rows of history, zero-padded (ROADMAP R6), and
        decoding reproduces the port's own full-prefill logits."""
        cfg = get_smoke_config("zamba2-7b")
        model = Model(cfg, device="cpu", seed=2)
        tokens = torch.from_numpy(
            np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 6)))
        _, cache = model.prefill(tokens[:, :prompt], max_len=6)
        assert cache["ssm"]["conv"].shape[3] == cfg.ssm_conv_width - 1
        assert cache["tail"]["conv"].shape[2] == cfg.ssm_conv_width - 1
        for i in range(prompt, 6):
            logits, cache = model.decode_step(cache, tokens[:, i:i + 1])
            full, _ = model.prefill(tokens[:, :i + 1])
            np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, 0]),
                                       rtol=0.08, atol=0.15)

    def test_state_dict_names_match_params_from_jax(self):
        cfg = dataclasses.replace(get_smoke_config("mamba2-2.7b"),
                                  dtype="float32")
        params = RefModel(cfg).init(jax.random.key(0))
        state = params_from_jax(cfg, jax.tree.map(np.asarray, params))
        model = Model(cfg, device="cpu")
        assert state.keys() == model.state_dict().keys()
        for name, t in model.state_dict().items():
            assert state[name].shape == t.shape, name
            assert state[name].dtype == t.dtype, name

    def test_init_constants_and_dtypes(self):
        """`_init_mamba`: a_log zeros, d_skip ones and dt_bias zeros in
        float32; conv with std 0.2, the rest in the model's dtype."""
        cfg = get_smoke_config("mamba2-2.7b")
        blk = Model(cfg, device="cpu", seed=3).layers[0]
        for name in ("a_log", "dt_bias", "d_skip"):
            assert blk[name].dtype == torch.float32
        assert torch.equal(blk.a_log, torch.zeros(cfg.ssm_heads))
        assert torch.equal(blk.d_skip, torch.ones(cfg.ssm_heads))
        assert blk.conv.shape == (cfg.ssm_conv_width,
                                  cfg.d_inner + 2 * cfg.ssm_state)
        assert blk.conv.dtype == blk.w_z.dtype == torch.bfloat16
        assert 0.18 < float(blk.conv.float().std()) < 0.22
        assert 0.018 < float(blk.w_x.float().std()) < 0.022

    def test_full_size_without_cuda_raises(self, monkeypatch):
        """The full-width model runs on the card by default and refuses,
        before allocating anything, when there is none."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Model(get_config("mamba2-2.7b"))
