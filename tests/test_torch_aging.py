"""Aging physics and the aging_update kernel of the port against the
reference, in this process.

`src/repro/core/aging.py`, `temperature.py` and `variation.py` import
only numpy, so they are loaded by file path: importing the package
`repro.core` would run its `__init__`, which fails on Python 3.12
(ROADMAP R1). The reference's kernel package
`repro.kernels.aging_update` imports cleanly; its Pallas kernel runs in
interpret mode on the CPU, as the reference's own tests run it.

Tolerances: the host-side numpy copies must be bit-identical. The
float32 versions of the kernel hold at rtol 1e-6 / atol 1e-9 (the
reference's kernel-vs-oracle bound: a few float32 ulps over the exp/pow
chain) and at rel 1e-5 against the float64 scalar path.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.aging_update import ops as ref_ops
from repro.kernels.aging_update.ref import aging_update_ref as jnp_ref
from repro_torch.core import aging, temperature, variation
from repro_torch.kernels.aging_update import ops
from repro_torch.kernels.aging_update.ref import aging_update_ref

REF_CORE = Path(__file__).resolve().parents[1] / "src" / "repro" / "core"
NS = (1, 7, 128, 1024, 5000)


def _load(name: str):
    """A reference module of `repro/core` by file path, under a private
    name (dataclasses need it in `sys.modules` while they are built)."""
    mod_name = f"_reference_core_{name}"
    if mod_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            mod_name, REF_CORE / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[mod_name]


ref_aging = _load("aging")
ref_temperature = _load("temperature")
ref_variation = _load("variation")


def _inputs(n: int):
    """The draws of the reference's TestAgingUpdateKernel, float32."""
    rng = np.random.default_rng(n)
    return [a.astype(np.float32) for a in (
        rng.uniform(0, 0.05, n),
        rng.choice([48.0, 51.08, 54.0], n),
        rng.choice([0.0, 1.0], n),
        rng.uniform(0, 1e5, n))]


class TestHostCopies:
    @pytest.mark.parametrize(
        "field", [f.name for f in dataclasses.fields(aging.AgingParams)])
    def test_default_params_field(self, field):
        port = getattr(aging.DEFAULT_PARAMS, field)
        ref = getattr(ref_aging.DEFAULT_PARAMS, field)
        assert type(port) is type(ref) and port == ref

    def test_adf_and_advance_bit_identical(self):
        rng = np.random.default_rng(3)
        temp = rng.choice([48.0, 51.08, 54.0], 4096)
        stress = rng.choice([0.0, 0.5, 1.0], 4096)
        dvth = rng.uniform(0, 0.1, 4096)
        tau = rng.uniform(-1.0, 1e6, 4096)
        p, r = aging.DEFAULT_PARAMS, ref_aging.DEFAULT_PARAMS
        a_port, a_ref = aging.adf(p, temp, stress), ref_aging.adf(r, temp,
                                                                  stress)
        np.testing.assert_array_equal(a_port, a_ref)
        np.testing.assert_array_equal(aging.advance_dvth(p, dvth, a_port, tau),
                                      ref_aging.advance_dvth(r, dvth, a_ref,
                                                             tau))
        for i in range(0, 4096, 97):
            assert aging.advance_dvth_scalar(p, dvth[i], a_port[i], tau[i]) \
                == ref_aging.advance_dvth_scalar(r, dvth[i], a_ref[i], tau[i])
        assert aging.dvth_after(p, 54.0, 1.0, 3600.0) == \
            ref_aging.dvth_after(r, 54.0, 1.0, 3600.0)

    def test_temperature_and_variation(self):
        for name in ("TEMP_ACTIVE_ALLOCATED_C", "TEMP_ACTIVE_UNALLOCATED_C",
                     "TEMP_DEEP_IDLE_C", "STRESS_ACTIVE", "STRESS_DEEP_IDLE"):
            assert getattr(temperature, name) == \
                getattr(ref_temperature, name)
        for seed in (0, 1, 7):
            port = variation.sample_initial_frequencies(
                variation.VariationParams(), 40,
                np.random.default_rng(seed))
            ref = ref_variation.sample_initial_frequencies(
                ref_variation.VariationParams(), 40,
                np.random.default_rng(seed))
            np.testing.assert_array_equal(port, ref)


class TestPlainVersion:
    @pytest.mark.parametrize("n", NS)
    def test_matches_jnp_oracle(self, n):
        args = _inputs(n)
        want = np.asarray(jnp_ref(*map(jnp.asarray, args),
                                  ref_aging.DEFAULT_PARAMS))
        got = aging_update_ref(*map(torch.from_numpy, args),
                               aging.DEFAULT_PARAMS)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)

    @pytest.mark.parametrize("n", NS)
    def test_wrapper_matches_pallas_kernel(self, n):
        """On CPU tensors `advance_fleet` runs the plain version; it is
        held against the Pallas kernel in interpret mode."""
        args = _inputs(n)
        want = np.asarray(ref_ops.advance_fleet(
            *args, ref_aging.DEFAULT_PARAMS, interpret=True))
        got = ops.advance_fleet(*map(torch.from_numpy, args),
                                aging.DEFAULT_PARAMS)
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)

    def test_matches_scalar_float64_path(self):
        rng = np.random.default_rng(0)
        n = 64
        dvth = rng.uniform(0, 0.05, n)
        temp = rng.choice([48.0, 51.08, 54.0], n)
        stress = rng.choice([0.0, 1.0], n)
        tau = rng.uniform(1.0, 1e5, n)
        out = ops.advance_fleet(
            *(torch.tensor(a, dtype=torch.float32)
              for a in (dvth, temp, stress, tau)), aging.DEFAULT_PARAMS)
        for i in range(n):
            a = float(ref_aging.adf(ref_aging.DEFAULT_PARAMS, temp[i],
                                    stress[i]))
            want = ref_aging.advance_dvth_scalar(ref_aging.DEFAULT_PARAMS,
                                                 dvth[i], a, tau[i])
            assert float(out[i]) == pytest.approx(want, rel=1e-5)


class TestWrapperChecks:
    def _args(self, n=8):
        return [torch.from_numpy(a) for a in _inputs(n)]

    def test_rejects_float64(self):
        args = self._args()
        args[1] = args[1].double()
        with pytest.raises(TypeError, match="float32"):
            ops.advance_fleet(*args, aging.DEFAULT_PARAMS)

    def test_rejects_unequal_lengths(self):
        args = self._args()
        args[3] = args[3][:5]
        with pytest.raises(ValueError, match="one length"):
            ops.advance_fleet(*args, aging.DEFAULT_PARAMS)

    def test_rejects_non_contiguous(self):
        args = [torch.from_numpy(a)[::2] for a in _inputs(16)]
        with pytest.raises(ValueError, match="contiguous"):
            ops.advance_fleet(*args, aging.DEFAULT_PARAMS)

    def test_rejects_arrays(self):
        with pytest.raises(TypeError, match="tensor"):
            ops.advance_fleet(*_inputs(8), aging.DEFAULT_PARAMS)

    def test_cpu_launches_no_kernel(self):
        before = ops.KERNEL.launches
        ops.advance_fleet(*self._args(), aging.DEFAULT_PARAMS)
        assert ops.KERNEL.launches == before
