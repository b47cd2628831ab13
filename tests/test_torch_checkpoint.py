"""The port's checkpoint store (`repro_torch.checkpoint.store`) and the
fleet engine's checkpoints, against the reference, on the CPU.

- The store is held against `repro.checkpoint.store`, which imports in
  this process: the same operations on the same seeded trees give the
  same keys, arrays, warnings and errors, and the files of either store
  restore through the other with equal bits, bfloat16 included.
- Fleet kill-and-resume is the reference's `tests/test_fleetsim.py::
  TestCheckpointResume` config (60 s, a checkpoint every 20 s, the
  steps after the first deleted): the resumed run equals the
  uninterrupted one exactly, on the numpy backend, on the torch backend
  (CPU), and across packages in both directions on numpy (the reference
  runs in a child interpreter, `torch_harness`, ROADMAP R1).
"""
from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_harness import run_reference

from repro.checkpoint import store as ref_store
from repro_torch.checkpoint import store
from repro_torch.sim import ExperimentConfig, FleetEngine, run_experiment

# tests/test_fleetsim.py::TestCheckpointResume
RESUME_KW = {"duration_s": 60.0}
EVERY_S = 20.0


def _tree(seed: int = 0) -> dict:
    """A nested tree of numpy and torch leaves from a seeded generator."""
    rng = np.random.default_rng(seed)
    return {
        "dvth": rng.random((3, 4)),
        "gated": rng.random((3, 4)) > 0.5,
        "macro": np.asarray(7, dtype=np.int64),
        "layers": [
            {"w": torch.tensor(rng.standard_normal((2, 3)),
                               dtype=torch.float32),
             "b": torch.tensor(rng.standard_normal(3), dtype=torch.bfloat16)},
            # int32: jax's default integer width (x64 off)
            (torch.tensor(rng.integers(0, 9, 4), dtype=torch.int32), None),
        ],
    }


def _ref_tree(tree: dict) -> dict:
    """`_tree` with its tensors as jax arrays (for the reference store)."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            if x.dtype == torch.bfloat16:
                bits = x.view(torch.int16).numpy().view(np.uint16)
                return jnp.asarray(bits).view(jnp.bfloat16)
            return jnp.asarray(x.numpy())
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return x
    return conv(tree)


def _assert_same_leaves(a, b):
    """Two trees of the port hold the same keys, dtypes and bits."""
    fa, fb = store._flatten(a), store._flatten(b)
    assert fa.keys() == fb.keys()
    for key in fa:
        assert fa[key].dtype == fb[key].dtype, key
        np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)


class TestStore:
    def test_keys_and_bits_equal_the_reference(self):
        tree = _tree()
        port, ref = store._flatten(tree), ref_store._flatten(_ref_tree(tree))
        assert list(port) == list(ref) == [
            "dvth", "gated", "layers::#0::b", "layers::#0::w",
            "layers::#1::#0", "macro"]
        for key in ref:
            assert port[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
        assert port["layers::#0::b"].dtype == np.uint16

    def test_round_trip(self, tmp_path):
        tree = _tree(1)
        store.save(str(tmp_path), 3, tree, extra={"config": "abc"})
        assert sorted(os.listdir(tmp_path)) == ["step_00000003"]
        template = _tree(2)
        back = store.restore(str(tmp_path), template)
        assert isinstance(back["dvth"], np.ndarray)
        assert back["dvth"].dtype == np.float64
        assert isinstance(back["layers"][1], tuple)
        assert back["layers"][1][1] is None
        b = back["layers"][0]["b"]
        assert isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16
        _assert_same_leaves(back, tree)
        assert store.meta(str(tmp_path))["config"] == "abc"

    def test_tensor_template_keeps_dtype_and_device(self, tmp_path):
        store.save(str(tmp_path), 0, {"x": np.arange(4.0)})
        template = {"x": torch.zeros(4, dtype=torch.int32)}
        back = store.restore(str(tmp_path), template)
        assert back["x"].dtype == torch.int32
        assert back["x"].device == torch.device("cpu")
        assert back["x"].tolist() == [0, 1, 2, 3]

    def test_truncated_newest_falls_back_as_the_reference(self, tmp_path):
        messages = []
        for mod, name in ((store, "port"), (ref_store, "ref")):
            d = str(tmp_path / name)
            tree = {"w": np.arange(6.0)}
            mod.save(d, 1, tree)
            mod.save(d, 2, {"w": tree["w"] + 1})
            path = os.path.join(d, "step_00000002", "params.npz")
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) // 2)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                back = mod.restore(d, tree)
            np.testing.assert_array_equal(back["w"], tree["w"])
            assert [w.category for w in caught] == [RuntimeWarning]
            messages.append(str(caught[0].message).replace(d, "<dir>"))
            with pytest.raises(ValueError) as info:
                mod.restore(d, tree, step=2)
            messages.append(str(info.value).replace(d, "<dir>"))
        assert messages[0] == messages[2]
        assert messages[1] == messages[3]
        assert "falling back to step 1" in messages[0]

    def test_keep_and_latest_step(self, tmp_path):
        kept = []
        for mod, name in ((store, "port"), (ref_store, "ref")):
            d = str(tmp_path / name)
            assert mod.latest_step(d) is None
            for step in range(6):
                mod.save(d, step, {"w": np.zeros(2)}, keep=2)
            kept.append((sorted(os.listdir(d)), mod.latest_step(d)))
            with pytest.raises(FileNotFoundError):
                mod.restore(str(tmp_path / f"{name}-empty"), {"w": 0})
        assert kept[0] == kept[1] == (["step_00000004", "step_00000005"], 5)


class TestCrossPackage:
    def test_port_files_restore_through_the_reference(self, tmp_path):
        tree = _tree(3)
        store.save(str(tmp_path), 4, tree)
        back = ref_store.restore(str(tmp_path), _ref_tree(_tree(4)))
        assert back["layers"][0]["b"].dtype == jnp.bfloat16
        for key, want in store._flatten(tree).items():
            got = ref_store._flatten(back)[key]
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)

    def test_reference_files_restore_through_the_port(self, tmp_path):
        tree = _tree(5)
        ref_store.save(str(tmp_path), 4, _ref_tree(tree),
                       opt_state={"m": np.arange(3.0)})
        back = store.restore(str(tmp_path), _tree(6))
        _assert_same_leaves(back, tree)
        opt = store.restore(str(tmp_path), {"m": torch.zeros(3)},
                            name="opt_state.npz")
        assert opt["m"].tolist() == [0.0, 1.0, 2.0]

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_named_tuple_crosses_packages(self, tmp_path, writer):
        """A NamedTuple's fields are keyed by name (`.step`, `.mu::w`),
        as jax's `GetAttrKey` is, so either store restores the other's
        file of one, field for field."""
        state = State(torch.tensor(3, dtype=torch.int32),
                      {"w": torch.arange(4, dtype=torch.float32)},
                      {"w": torch.ones(4, dtype=torch.bfloat16)})
        params = {"w": torch.zeros(4)}
        if writer == "port":
            store.save(str(tmp_path), 1, params, state)
            back = ref_store.restore(str(tmp_path), _to_jax(_zeros(state)),
                                     name="opt_state.npz")
        else:
            ref_store.save(str(tmp_path), 1, _to_jax(params),
                           _to_jax(state))
            back = store.restore(str(tmp_path), _zeros(state),
                                 name="opt_state.npz")
        with np.load(tmp_path / "step_00000001" / "opt_state.npz") as data:
            assert sorted(data.files) == [".mu::w", ".nu::w", ".step"]
        assert type(back) is State
        _assert_equal(back, state)

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_adamw_state_crosses_packages(self, tmp_path, writer):
        """The smoke Llama's params and `AdamWState` after one step of
        each package's AdamW on the same params and grads: a file written
        by either package restores through the other's store, keys and
        values equal."""
        ref_params, ref_state, port_params, port_state = _adamw_pair()
        if writer == "port":
            store.save(str(tmp_path), 1, port_params, port_state)
            back = ref_store.restore(str(tmp_path), ref_state,
                                     name="opt_state.npz")
            params = ref_store.restore(str(tmp_path), ref_params)
        else:
            ref_store.save(str(tmp_path), 1, ref_params, ref_state)
            back = store.restore(str(tmp_path), _zeros(port_state),
                                 name="opt_state.npz")
            params = store.restore(str(tmp_path), _zeros(port_params))
        with np.load(tmp_path / "step_00000001" / "opt_state.npz") as data:
            keys = sorted(data.files)
        assert keys[-1] == ".step"
        assert ".mu::layers::attn::wq" in keys
        assert ".nu::final_ln" in keys
        assert keys == sorted(ref_store._flatten(ref_state))
        assert int(back.step) == 1
        _assert_equal(back, port_state)
        _assert_equal(params, port_params)


class State(NamedTuple):
    """Shaped like the AdamW state of both packages."""
    step: torch.Tensor
    mu: dict
    nu: dict


def _to_jax(tree):
    """A tree of tensors as one of jax arrays, NamedTuples kept."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_to_jax(v) for v in tree))
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.view(torch.int16).numpy().view(
            np.uint16)).view(jnp.bfloat16)
    return jnp.asarray(tree.numpy())


def _zeros(tree):
    """`tree` with zeros of each leaf's dtype: a template to restore."""
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_zeros(v) for v in tree))
    return torch.zeros_like(tree)


def _assert_equal(got, want):
    """Every leaf of `got` (either package's) equals `want`'s, bit for
    bit, in its dtype."""
    flat_got = (ref_store._flatten(got) if not isinstance(
        jax.tree.leaves(got)[0], torch.Tensor) else store._flatten(got))
    flat_want = store._flatten(want)
    assert flat_got.keys() == flat_want.keys()
    for key, arr in flat_want.items():
        assert flat_got[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(flat_got[key], arr, err_msg=key)


def _adamw_pair():
    """(reference params, reference AdamWState, the port's both in the
    reference's layout) of the smoke Llama (bfloat16) after one AdamW
    step of each package on the same params and seeded grads."""
    from repro.configs import get_smoke_config
    from repro.models import Model as RefModel
    from repro.training import optimizer as ref_opt
    from repro_torch.models import params_from_jax, params_to_jax
    from repro_torch.training import optimizer as opt

    cfg = get_smoke_config("llama3-8b")
    params = RefModel(cfg).init(jax.random.key(0))
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
        p.shape), p.dtype), params)
    ocfg = ref_opt.AdamWConfig(warmup_steps=0)
    ref_params, ref_state, _ = ref_opt.apply_updates(
        params, grads, ref_opt.init_state(params), ocfg)
    mine = params_from_jax(cfg, jax.tree.map(np.asarray, params))
    mine = {n: t.clone() for n, t in mine.items()}
    state = opt.init_state(mine)
    _, state, _ = opt.apply_updates(
        mine, params_from_jax(cfg, jax.tree.map(np.asarray, grads)), state,
        opt.AdamWConfig(warmup_steps=0))
    port_state = opt.AdamWState(state.step, params_to_jax(cfg, state.mu),
                                params_to_jax(cfg, state.nu))
    return ref_params, ref_state, params_to_jax(cfg, mine), port_state


# ---------------------------------------------------------------------- #
# fleet checkpoints
# ---------------------------------------------------------------------- #
def _fleet_cfg(ckpt, **engine) -> ExperimentConfig:
    kw = dict(RESUME_KW)
    kw.update(engine.pop("cfg_kw", {}))
    return ExperimentConfig(**kw).with_engine(
        "fleet", checkpoint_dir=str(ckpt), checkpoint_every_s=EVERY_S,
        **engine)


def _drop_after_first(ckpt) -> list[str]:
    """Simulate the interruption: keep only the first checkpoint."""
    steps = sorted(d for d in os.listdir(ckpt) if d.startswith("step_"))
    assert len(steps) >= 2, "expected several periodic checkpoints"
    for d in steps[1:]:
        shutil.rmtree(os.path.join(ckpt, d))
    return steps


def _canonical(d: dict) -> str:
    """JSON with the package version dropped: string equality is then
    bit equality of every float, NaN included."""
    d = json.loads(json.dumps(d))
    d["provenance"].pop("package_version")
    return json.dumps(d, sort_keys=True)


_CHILD = r'''
import os, shutil
from repro.sim import ExperimentConfig, run_experiment

def cfg(ckpt):
    return ExperimentConfig(**job["kw"]).with_engine(
        "fleet", backend="numpy", checkpoint_dir=ckpt,
        checkpoint_every_s=job["every"])

out = {"uninterrupted": run_experiment(cfg(job["ref_dir"])).to_dict()}
# resume from the port's first checkpoint
out["resumed_from_port"] = run_experiment(cfg(job["port_dir"])).to_dict()
json.dump(out, sys.stdout)
'''


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The port writes checkpoints and keeps the first; the reference
    writes its own and resumes from the port's."""
    port_dir = tmp_path_factory.mktemp("port_ckpt")
    port = run_experiment(_fleet_cfg(port_dir, backend="numpy"))
    _drop_after_first(port_dir)
    ref_dir = tmp_path_factory.mktemp("ref_ckpt")
    out = run_reference(_CHILD, {"kw": RESUME_KW, "every": EVERY_S,
                                 "port_dir": str(port_dir),
                                 "ref_dir": str(ref_dir)})
    return {"port": port.to_dict(), "ref_dir": ref_dir, **out}


class TestFleetResume:
    @pytest.mark.parametrize("engine", [
        {"backend": "numpy"},
        {"backend": "numpy", "cfg_kw": {"fault_model": "guardband",
                                        "fault_opts": {"margin": 0.012}}},
        {"backend": "torch", "device": "cpu"},
        {"backend": "torch", "device": "cpu",
         "cfg_kw": {"fault_model": "guardband",
                    "fault_opts": {"margin": 0.012}}},
        {"backend": "torch", "device": "cpu",
         "cfg_kw": {"fleet": "xeon-28c:5+epyc-64c:rest"}},
    ], ids=["numpy", "numpy-guardband", "torch", "torch-guardband",
            "torch-mixed"])
    def test_resume_is_exact(self, tmp_path, engine):
        cfg = _fleet_cfg(tmp_path / "ckpt", **engine)
        uninterrupted = run_experiment(cfg)
        steps = _drop_after_first(tmp_path / "ckpt")
        eng = FleetEngine(cfg)
        resumed = run_experiment(cfg)
        assert _canonical(resumed.to_dict()) == \
            _canonical(uninterrupted.to_dict())
        meta = store.meta(str(tmp_path / "ckpt"), int(steps[0][5:]))
        assert meta["backend"] == eng.backend
        assert meta["config"] == cfg.fingerprint()

    def test_resumed_from_and_checkpoint_steps(self, tmp_path):
        cfg = _fleet_cfg(tmp_path / "ckpt", backend="torch", device="cpu")
        eng = FleetEngine(cfg)
        per = int(round(EVERY_S / cfg.idling_period_s))
        reqs = _requests(cfg)
        eng.run(reqs)
        assert eng.resumed_from is None
        assert sorted(os.listdir(tmp_path / "ckpt")) == [
            f"step_{per * k:08d}" for k in (1, 2)]
        _drop_after_first(tmp_path / "ckpt")
        again = FleetEngine(cfg)
        again.run(reqs)
        assert again.resumed_from == per
        for key, want in eng.state.items():
            np.testing.assert_array_equal(again.state[key], want,
                                          err_msg=key)

    @pytest.mark.parametrize("opts", [{"backend": "numpy"},
                                      {"backend": "torch", "device": "cpu"}],
                             ids=["numpy", "torch"])
    def test_refuses_a_different_experiment(self, tmp_path, opts):
        ckpt = tmp_path / "ckpt"
        run_experiment(_fleet_cfg(ckpt, **opts))
        other = _fleet_cfg(ckpt, cfg_kw={"seed": 7}, **opts)
        with pytest.raises(ValueError, match="refusing to resume a "
                                             "different experiment"):
            run_experiment(other)

    def test_port_resumes_reference_checkpoints(self, cross):
        """The reference's numpy checkpoints resume in the port and give
        the reference's uninterrupted result, `config_hash` included
        (the fingerprint holds `checkpoint_dir`, so the port resumes in
        the reference's directory)."""
        _drop_after_first(cross["ref_dir"])
        eng_cfg = _fleet_cfg(cross["ref_dir"], backend="numpy")
        resumed = run_experiment(eng_cfg)
        assert _canonical(resumed.to_dict()) == \
            _canonical(cross["uninterrupted"])

    def test_reference_resumes_port_checkpoints(self, cross):
        assert _canonical(cross["resumed_from_port"]) == \
            _canonical(cross["port"])


def _requests(cfg):
    from repro_torch.workloads import get_scenario
    return get_scenario(cfg.scenario).generate(
        rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed)
