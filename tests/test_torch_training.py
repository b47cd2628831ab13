"""Training in the port (`repro_torch.data`, `repro_torch.training`,
`Model.loss`, `repro_torch.launch.train`) against the reference
(`repro.data`, `repro.training`, `repro.models`, `repro.launch.train`),
in-process on the CPU.

- The data pipeline's batches equal the reference's bit for bit.
- AdamW: the reference's `TestAdamW` cases on the port; `lr_schedule`
  equal to the reference's float32 values; three `apply_updates` steps on
  the smoke Llama's params leaf for leaf against the reference's (float32
  to 1e-6: the global norm sums in another order; bfloat16 exactly), and
  one step of each family's smoke params, which holds the decay of the
  per-layer vectors that the reference stacks into matrices.
- `Model.loss` and every gradient against `jax.value_and_grad(
  Model.loss)` for each family's smoke config in float32, at
  `tests/test_torch_models.py`'s bounds, with `remat` on and off.
- Resume: the reference's train steps and store to step 2, the port's to
  step 4, against the reference's 4 steps (and the other way round), at
  the float32 bounds; the port's own resume bit for bit; the trainer's
  command line trains, and resumes a run the reference's saved.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticTokens as RefSyntheticTokens
from repro.data.pipeline import batches as ref_batches
from repro.launch.train import make_train_step as ref_make_train_step
from repro.models import Model as RefModel
from repro.training import optimizer as ref_opt
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, batches
from repro_torch.launch.train import (make_train_step, restore_checkpoint,
                                      save_checkpoint)
from repro_torch.models import Model, params_from_jax, params_to_jax
from repro_torch.training import optimizer as opt

REPO = Path(__file__).resolve().parents[1]
BOUNDS = {"float32": dict(rtol=1e-4, atol=1e-4),
          "bfloat16": dict(rtol=0.08, atol=0.15)}
FAMILIES = ["llama3-8b", "mamba2-2.7b", "granite-moe-3b-a800m",
            "minicpm3-4b", "zamba2-7b", "internvl2-2b",
            "seamless-m4t-large-v2"]
DATA = [dict(vocab_size=100, seq_len=16, global_batch=4, seed=3),
        dict(vocab_size=1000, seq_len=64, global_batch=2, seed=0),
        dict(vocab_size=50, seq_len=32, global_batch=8, seed=11,
             branching=4)]


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _batch(cfg, b: int = 2, s: int = 16, seed: int = 3) -> dict:
    """Seeded tokens, and a frontend's embeddings (normal at the
    embedding table's std) for a model with one."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.frontend != "none":
        out["embeds"] = (rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _port(cfg, tree) -> Model:
    """The port's model of `cfg` on the CPU with the reference's params."""
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray,
                                                            tree)))
    return model


def _configs(arch: str, dtype: str = "float32", **kw):
    return (dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(ref_get_smoke_config(arch), dtype=dtype,
                                **kw))


# ---------------------------------------------------------------------- #
# data
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", DATA, ids=lambda kw: f"seed{kw['seed']}")
def test_batches_equal_the_reference(kw):
    mine, theirs = SyntheticTokens(DataConfig(**kw)), \
        RefSyntheticTokens(RefDataConfig(**kw))
    for _ in range(5):
        a, b = next(mine)["tokens"], next(theirs)["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(batches(DataConfig(**kw), 3),
                    ref_batches(RefDataConfig(**kw), 3)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


# ---------------------------------------------------------------------- #
# AdamW: the reference's TestAdamW cases, on both packages
# ---------------------------------------------------------------------- #
def _small_params(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 8)).astype(np.float32),
            "b": np.zeros(8, np.float32),
            "nested.m": rng.standard_normal((4, 8)).astype(np.float32)}


def _ref_tree(flat: dict) -> dict:
    """`_small_params` as the reference's nested tree of jax arrays."""
    return {"w": jnp.asarray(flat["w"]), "b": jnp.asarray(flat["b"]),
            "nested": {"m": jnp.asarray(flat["nested.m"])}}


def _ref_flat(tree: dict) -> dict:
    return {"w": tree["w"], "b": tree["b"], "nested.m": tree["nested"]["m"]}


def _case_descends_quadratic():
    cfg = dict(lr=0.05, weight_decay=0.0, warmup_steps=0, total_steps=1000)
    flat = _small_params()
    params = {n: torch.tensor(a, requires_grad=True)
              for n, a in flat.items()}
    state = opt.init_state(params)

    def loss_fn(p):
        return sum(torch.sum(a ** 2) for a in p.values())
    l0 = loss_fn(params).item()
    for _ in range(50):
        grads = dict(zip(params, torch.autograd.grad(
            loss_fn(params), list(params.values()))))
        params, state, _ = opt.apply_updates(params, grads, state,
                                             opt.AdamWConfig(**cfg))
    assert loss_fn(params).item() < 0.1 * l0
    # the reference's 50 steps from the same params
    tree = _ref_tree(flat)
    rstate = ref_opt.init_state(tree)
    for _ in range(50):
        grads = jax.grad(lambda p: sum(jnp.sum(a ** 2)
                                       for a in jax.tree.leaves(p)))(tree)
        tree, rstate, _ = ref_opt.apply_updates(tree, grads, rstate,
                                                ref_opt.AdamWConfig(**cfg))
    for n, want in _ref_flat(tree).items():
        np.testing.assert_allclose(_np(params[n]), np.asarray(want),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def _case_grad_clip():
    clipped, norm = opt.clip_by_global_norm({"w": torch.full((4,), 100.0)},
                                            1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(torch.sqrt(sum(torch.sum(x ** 2)
                                for x in clipped.values()))) == \
        pytest.approx(1.0, rel=1e-5)
    theirs, _ = ref_opt.clip_by_global_norm({"w": jnp.full((4,), 100.0)},
                                            1.0)
    np.testing.assert_array_equal(clipped["w"].numpy(),
                                  np.asarray(theirs["w"]))


def _case_weight_decay_only_on_matrices():
    cfg = opt.AdamWConfig(lr=0.1, weight_decay=1.0, warmup_steps=0)
    params = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
    state = opt.init_state(params)
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    new, _, _ = opt.apply_updates(params, grads, state, cfg)
    assert float(new["w"][0, 0]) < 1.0   # decayed
    assert float(new["b"][0]) == 1.0     # not decayed


def _case_lr_schedule_shape():
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    lrs = [float(opt.lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 5, 10, 55, 100, 200)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, rel=1e-5)
    assert lrs[5] == pytest.approx(0.1, rel=1e-5)


def _case_update_is_finite():
    """The reference draws 20 (lr, seed) with hypothesis; here 20 seeded
    draws of the same ranges, each step held to the reference's."""
    rng = np.random.default_rng(0)
    for lr, seed in zip(rng.uniform(1e-5, 1e-2, 20),
                        rng.integers(0, 101, 20)):
        flat = _small_params(int(seed))
        grads = {n: np.random.default_rng(int(seed)).standard_normal(
            a.shape).astype(np.float32) for n, a in flat.items()}
        params = {n: torch.tensor(a) for n, a in flat.items()}
        new, _, _ = opt.apply_updates(
            params, {n: torch.tensor(g) for n, g in grads.items()},
            opt.init_state(params), opt.AdamWConfig(lr=float(lr),
                                                    warmup_steps=0))
        assert all(bool(torch.isfinite(t).all()) for t in new.values())
        tree = _ref_tree(flat)
        theirs, _, _ = ref_opt.apply_updates(
            tree, _ref_tree(grads), ref_opt.init_state(tree),
            ref_opt.AdamWConfig(lr=float(lr), warmup_steps=0))
        for n, want in _ref_flat(theirs).items():
            np.testing.assert_allclose(new[n].numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7, err_msg=n)


ADAMW_CASES = {"descends_quadratic": _case_descends_quadratic,
               "grad_clip": _case_grad_clip,
               "weight_decay_only_on_matrices":
                   _case_weight_decay_only_on_matrices,
               "lr_schedule_shape": _case_lr_schedule_shape,
               "update_is_finite": _case_update_is_finite}


@pytest.mark.parametrize("case", list(ADAMW_CASES))
def test_adamw_reference_case(case):
    ADAMW_CASES[case]()


@pytest.mark.parametrize("step", [0, 5, 10, 55, 100, 200])
def test_lr_schedule_equals_the_reference(step):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    mine = opt.lr_schedule(opt.AdamWConfig(**kw),
                           torch.tensor(step, dtype=torch.int32))
    theirs = ref_opt.lr_schedule(ref_opt.AdamWConfig(**kw), jnp.int32(step))
    assert mine.dtype == torch.float32
    assert mine.item() == float(theirs)


def _adamw_steps(arch: str, dtype: str, steps: int, ocfg: dict, grads_of):
    """`steps` AdamW steps of each package from the reference's smoke
    params of `arch`; the grads of step i are `grads_of(params, i)`. Returns
    (the port's params, state), (the reference's, as state dicts)."""
    cfg, ref_cfg = _configs(arch, dtype)
    tree = RefModel(ref_cfg).init(jax.random.key(0))
    state = ref_opt.init_state(tree)
    mine = {n: t.clone() for n, t in params_from_jax(
        cfg, jax.tree.map(np.asarray, tree)).items()}
    my_state = opt.init_state(mine)
    for i in range(steps):
        grads = grads_of(tree, i)
        tree, state, _ = ref_opt.apply_updates(
            tree, grads, state, ref_opt.AdamWConfig(**ocfg))
        _, my_state, _ = opt.apply_updates(
            mine, params_from_jax(cfg, jax.tree.map(np.asarray, grads)),
            my_state, opt.AdamWConfig(**ocfg))

    def flat(t):
        return params_from_jax(cfg, jax.tree.map(np.asarray, t))
    return (mine, my_state), (flat(tree), state.step, flat(state.mu),
                              flat(state.nu))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_steps_match_the_reference(dtype):
    """Seeded grads, clipped (norm 1.0 of some 1,280), warmup then cosine;
    weight decay 1.0 so that a leaf decayed by one package and not the
    other shows at once. float32 differs by the global norm's summation
    order; bfloat16 rounds that away."""
    rng = np.random.default_rng(0)

    def grads_of(tree, i):
        return jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
            p.shape).astype(np.float32)).astype(p.dtype), tree)
    (mine, state), (params, step, mu, nu) = _adamw_steps(
        "llama3-8b", dtype, 3, dict(lr=0.1, weight_decay=1.0,
                                    warmup_steps=2, total_steps=10),
        grads_of)
    assert int(state.step) == int(step) == 3
    tol = dict(rtol=1e-6, atol=1e-6)
    for name in mine:
        assert mine[name].dtype == params[name].dtype, name
        torch.testing.assert_close(mine[name], params[name], **tol,
                                   msg=name)
        torch.testing.assert_close(state.mu[name], mu[name], **tol, msg=name)
        torch.testing.assert_close(state.nu[name], nu[name], **tol, msg=name)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decay_follows_the_reference_layout(arch):
    """Zero grads, lr 0.1, decay 1.0: exactly the leaves the reference
    decays move (its stacked per-layer norms, Mamba2's per-head vectors,
    the encoder's; not `final_ln`, nor the hybrid's unstacked shared
    block's norms), by the reference's amount, bit for bit."""
    (mine, _), (params, *_) = _adamw_steps(
        arch, "float32", 1, dict(lr=0.1, weight_decay=1.0, warmup_steps=0),
        lambda tree, i: jax.tree.map(jnp.zeros_like, tree))
    for name in mine:
        np.testing.assert_array_equal(mine[name].numpy(),
                                      params[name].numpy(), err_msg=name)
    assert opt.decays("layers.0.ln1", mine["final_ln"])
    assert not opt.decays("final_ln", mine["final_ln"])
    if arch == "zamba2-7b":
        assert not opt.decays("shared.ln1", mine["shared.ln1"])
        assert (mine["shared.ln1"] == 1).all()


# ---------------------------------------------------------------------- #
# Model.loss and its gradients
# ---------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _reference_loss(arch: str):
    """(params, batch, loss, grads) of the reference's float32 smoke
    model of `arch`: `jax.value_and_grad(Model.loss)`."""
    _, ref_cfg = _configs(arch)
    model = RefModel(ref_cfg)
    params = model.init(jax.random.key(0))
    batch = _batch(ref_cfg)
    loss, grads = jax.value_and_grad(model.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return params, batch, float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_the_reference(arch, remat):
    params, batch, want, ref_grads = _reference_loss(arch)
    cfg, _ = _configs(arch, remat=remat)
    model = _port(cfg, params)
    model.requires_grad_(True)
    loss = model.loss(batch)
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), want, **BOUNDS["float32"])
    grads = params_from_jax(cfg, ref_grads)
    named = dict(model.named_parameters())
    assert named.keys() == grads.keys()
    for name, p in named.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   **BOUNDS["float32"], err_msg=name)


def test_remat_changes_no_bit():
    """`remat` recomputes each layer in the backward pass; the loss and
    gradients are those without it, bit for bit (the MoE family, whose
    routes are recomputed too)."""
    out = []
    for remat in (True, False):
        cfg, _ = _configs("granite-moe-3b-a800m", remat=remat)
        model = Model(cfg, device="cpu").requires_grad_(True)
        loss = model.loss(_batch(cfg))
        loss.backward()
        out.append((loss.item(), [p.grad for p in model.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_bfloat16_loss_and_grads_are_finite():
    """The bfloat16 smoke Llama at the reference's bfloat16 bound: the
    loss, and the update's direction (the grads agree in sign where they
    are large)."""
    cfg, ref_cfg = _configs("llama3-8b", "bfloat16")
    ref = RefModel(ref_cfg)
    params = ref.init(jax.random.key(0))
    batch = _batch(cfg)
    want, ref_grads = jax.value_and_grad(ref.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port(cfg, params).requires_grad_(True)
    loss = model.loss(batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want),
                               **BOUNDS["bfloat16"])
    grads = params_from_jax(cfg, jax.tree.map(np.asarray, ref_grads))
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.bfloat16, name
        assert bool(torch.isfinite(p.grad).all()), name
        g, r = p.grad.float(), grads[name].float()
        big = r.abs() > 0.5 * r.abs().max()
        assert bool((torch.sign(g[big]) == torch.sign(r[big])).all()), name


def test_bfloat16_grad_norm_bias_is_the_reference_s():
    """bfloat16 shrinks the whole backward signal alike: at 4 layers of
    d_model 1,024 (Llama-3-8B's layout, vocab 32,000, 4 x 256 tokens) the
    bfloat16 grad norm sits some 2.3e-3 below the float32 one on the same
    weights, in the reference and in the port, and the two packages'
    bfloat16 grad norms agree far closer than that (the smoke's bfloat16
    hold on the card allows for this bias)."""
    kw = dict(num_layers=4, d_model=1024, num_heads=8, num_kv_heads=2,
              head_dim=128, d_ff=3584, vocab_size=32000)
    cfg, _ = _configs("llama3-8b", "bfloat16", **kw)
    tokens = next(SyntheticTokens(DataConfig(
        vocab_size=32000, seq_len=256, global_batch=4, seed=0)))["tokens"]
    tree = params_to_jax(cfg, Model(cfg, device="cpu").state_dict())
    norms = {}
    for dtype in ("bfloat16", "float32"):
        cfg, ref_cfg = _configs("llama3-8b", dtype, **kw)
        model = Model(cfg, device="cpu")
        model.load_state_dict(params_from_jax(cfg, tree))
        model.requires_grad_(True)
        model.loss({"tokens": tokens}).backward()
        mine = opt.global_norm({n: p.grad for n, p in
                                model.named_parameters()}).item()
        params = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
            jnp.float32 if t.dtype == torch.float32 else ref_cfg.dtype),
            tree)
        grads = jax.grad(RefModel(ref_cfg).loss)(
            params, {"tokens": jnp.asarray(tokens)})
        theirs = float(jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(
            jnp.float32))) for g in jax.tree.leaves(grads))))
        norms[dtype] = mine, theirs
    (bf_port, bf_ref), (f_port, f_ref) = norms["bfloat16"], norms["float32"]
    assert abs(f_port - f_ref) <= 1e-5 * f_ref
    for bf in (bf_port, bf_ref):
        assert -4e-3 < (bf - f_ref) / f_ref < -1e-3
    assert abs(bf_port - bf_ref) <= 5e-4 * bf_ref


def test_serving_paths_take_no_grad():
    """Params that require grad leave `prefill` and `decode_step` without
    a graph (they run under no_grad)."""
    cfg = get_smoke_config("llama3-8b")
    model = Model(cfg, device="cpu").requires_grad_(True)
    logits, cache = model.prefill(torch.tensor([[1, 2, 3]]), max_len=8)
    assert not logits.requires_grad
    logits, _ = model.decode_step(cache, torch.tensor([[4]]))
    assert not logits.requires_grad


# ---------------------------------------------------------------------- #
# the train step, checkpoints and resume
# ---------------------------------------------------------------------- #
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=4)


def _data(cfg, steps: int) -> list[dict]:
    it = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=2, seed=0))
    return [next(it) for _ in range(steps)]


def _ref_run(ref_cfg, params, state, data):
    """The reference's train steps over `data`: (params, state, losses)."""
    step = ref_make_train_step(RefModel(ref_cfg), ref_opt.AdamWConfig(**OCFG))
    losses = []
    for batch in data:
        params, state, loss, _ = step(params, state,
                                      {"tokens": jnp.asarray(batch["tokens"])})
        losses.append(float(loss))
    return params, state, losses


def _port_run(model, state, data):
    step = make_train_step(model, opt.AdamWConfig(**OCFG))
    losses = []
    for batch in data:
        state, loss, _ = step(state, batch)
        losses.append(loss.item())
    return state, losses


def _ref_templates(ref_cfg):
    params = RefModel(ref_cfg).init(jax.random.key(1))
    return params, ref_opt.init_state(params)


def _assert_params_close(cfg, model, ref_params):
    want = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   **BOUNDS["float32"], err_msg=name)


@pytest.mark.parametrize("first", ["reference", "port"])
def test_resume_across_packages(tmp_path, first):
    """Two steps by one package, saved; two more by the other after its
    restore; held against the reference's uninterrupted four steps (with
    the port first, against the port's own four too)."""
    cfg, ref_cfg = _configs("llama3-8b")
    data = _data(cfg, 4)
    params = RefModel(ref_cfg).init(jax.random.key(0))
    ref_params, _, ref_losses = _ref_run(
        ref_cfg, jax.tree.map(jnp.copy, params),
        ref_opt.init_state(params), data)
    if first == "reference":
        p2, s2, losses = _ref_run(ref_cfg, jax.tree.map(jnp.copy, params),
                                  ref_opt.init_state(params), data[:2])
        ref_store.save(str(tmp_path), 2, p2, s2)
        model = Model(cfg, device="cpu", seed=5)
        state = restore_checkpoint(str(tmp_path), model,
                                   opt.init_state(dict(
                                       model.named_parameters())))
        assert int(state.step) == 2
        state, more = _port_run(model, state, data[2:])
        assert int(state.step) == 4
        _assert_params_close(cfg, model, ref_params)
    else:
        model = _port(cfg, params)
        state = opt.init_state(dict(model.named_parameters()))
        state, losses = _port_run(model, state, data[:2])
        save_checkpoint(str(tmp_path), 2, model, state)
        tpl_params, tpl_state = _ref_templates(ref_cfg)
        p2 = ref_store.restore(str(tmp_path), tpl_params)
        s2 = ref_store.restore(str(tmp_path), tpl_state,
                               name="opt_state.npz")
        assert int(s2.step) == 2
        p4, s4, more = _ref_run(ref_cfg, p2, s2, data[2:])
        assert int(s4.step) == 4
        for a, b in zip(jax.tree.leaves(p4), jax.tree.leaves(ref_params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       **BOUNDS["float32"])
        _, port_losses = _port_run(model, state, data[2:])
        np.testing.assert_allclose(more, port_losses, **BOUNDS["float32"])
        _assert_params_close(cfg, model, p4)
    np.testing.assert_allclose(losses + more, ref_losses,
                               **BOUNDS["float32"])


def test_port_resume_is_bit_exact(tmp_path):
    """The port's four steps, against two steps, a save, a new model's
    restore and two more: the same losses, params and moments, bit for
    bit (bfloat16 params, float32 moments)."""
    cfg = get_smoke_config("llama3-8b")
    data = _data(cfg, 4)
    model = Model(cfg, device="cpu", seed=0)
    state, losses = _port_run(model, opt.init_state(dict(
        model.named_parameters())), data)
    first = Model(cfg, device="cpu", seed=0)
    s2, head = _port_run(first, opt.init_state(dict(
        first.named_parameters())), data[:2])
    save_checkpoint(str(tmp_path), 2, first, s2)
    second = Model(cfg, device="cpu", seed=9)
    s = restore_checkpoint(str(tmp_path), second, opt.init_state(dict(
        second.named_parameters())))
    s, tail = _port_run(second, s, data[2:])
    assert head + tail == losses
    assert int(s.step) == int(state.step) == 4
    for (name, a), b in zip(model.named_parameters(), second.parameters()):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b), name
        assert torch.equal(state.mu[name], s.mu[name]), name
        assert torch.equal(state.nu[name], s.nu[name]), name


def test_train_step_on_every_family_lowers_the_loss():
    """Ten steps of `make_train_step` on one batch of each family's smoke
    model (bfloat16, with its frontend's zero embeddings, as the trainer
    feeds them): the loss falls."""
    for arch in FAMILIES:
        cfg = get_smoke_config(arch)
        model = Model(cfg, device="cpu")
        batch = {"tokens": _batch(cfg)["tokens"]}
        if cfg.frontend != "none":
            batch["embeds"] = np.zeros((2, cfg.frontend_tokens, cfg.d_model),
                                       np.float32)
        step = make_train_step(model, opt.AdamWConfig(lr=1e-2,
                                                      warmup_steps=0))
        state = opt.init_state(dict(model.named_parameters()))
        losses = []
        for _ in range(10):
            state, loss, _ = step(state, batch)
            losses.append(loss.item())
        assert losses[-1] < losses[0], (arch, losses)


def _cli(module: str, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", module, "--arch", "llama3-8b", "--smoke",
         *args], capture_output=True,
        text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 JAX_PLATFORMS="cpu"))


def test_cli_trains():
    """The command line at its default batch (8 x 128 tokens)."""
    proc = _cli("repro_torch.launch.train", "--device", "cpu", "--steps",
                "30")
    assert proc.returncode == 0, proc.stderr
    assert "arch=llama3-8b params=1,639,680" in proc.stdout
    assert "loss improved" in proc.stdout
    assert "step    30 loss" in proc.stdout


def test_cli_resumes_the_reference_run_and_saves_its_layout(tmp_path):
    """The reference's trainer saves step 2; the port's resumes it to 4
    and saves in the reference's layout, which the reference's store
    restores."""
    ckpt = str(tmp_path)
    small = ("--batch", "2", "--seq", "16", "--ckpt-dir", ckpt,
             "--ckpt-every", "2", "--log-every", "1")
    ref = _cli("repro.launch.train", "--steps", "2", *small)
    assert ref.returncode == 0, ref.stderr
    proc = _cli("repro_torch.launch.train", "--device", "cpu", "--steps",
                "4", *small)
    assert proc.returncode == 0, proc.stderr
    assert f"restored step 2 from {ckpt}" in proc.stdout
    assert "step     4 loss" in proc.stdout
    assert ref_store.latest_step(ckpt) == 4
    _, ref_cfg = _configs("llama3-8b", "bfloat16")
    tpl_params, tpl_state = _ref_templates(ref_cfg)
    params = ref_store.restore(ckpt, tpl_params)
    state = ref_store.restore(ckpt, tpl_state, name="opt_state.npz")
    assert int(state.step) == 4
    assert jax.tree.structure(params) == jax.tree.structure(tpl_params)
    assert params["layers"]["attn"]["wq"].dtype == jnp.bfloat16
    assert state.mu["embed"].dtype == jnp.float32
    assert float(jnp.abs(state.nu["layers"]["ln1"]).sum()) > 0
