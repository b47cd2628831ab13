"""The port on the card: each CUDA kernel against its plain PyTorch
version, the fleet engine on CUDA against the same engine on the CPU and,
under each fault model it vectorizes, against its numpy backend, the
event engine's torch settler on CUDA against its numpy settler (under
guardband faults too), a padded mixed fleet and a checkpoint resume on
CUDA, the checkpoint store onto the card, the dense, mixture-of-experts
and MLA models and serving engine through the attention kernels (MLA's
(96, 64) head dims an instance of both), the Mamba2 model and engine
through the SSD scan kernel, and the hybrid (Zamba2, its shared block at
head dim 112, an instance of both attention kernels), vision-frontend
(InternVL2) and encoder-decoder (Seamless, its encoder's attention
non-causal) models through the kernels of their paths. Every test here
needs an NVIDIA GPU and skips without one; this file imports neither jax
nor the reference, so it runs on a machine that has only the port's
dependencies:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_smoke_config
from repro_torch.core.aging import DEFAULT_PARAMS
from repro_torch.kernels.aging_update import ops
from repro_torch.kernels.aging_update.ref import aging_update_ref
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_phases, ssd_scan_ref
from repro_torch.models import Model, mamba2
from repro_torch.serving.engine import InferenceEngine
from repro_torch.sim import (Cluster, ExperimentConfig, FleetAgingSettler,
                             FleetEngine, collect, run_experiment)
from repro_torch.workloads import get_scenario

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("n", [1, 7, 128, 1024, 5000, 8000, 1_280_000])
def test_aging_kernel_matches_plain_version(cuda_device, n):
    """The draws of the reference's TestAgingUpdateKernel; its bound."""
    rng = np.random.default_rng(n)
    args = [torch.tensor(a, dtype=torch.float32, device=cuda_device)
            for a in (rng.uniform(0, 0.05, n),
                      rng.choice([48.0, 51.08, 54.0], n),
                      rng.choice([0.0, 1.0], n),
                      rng.uniform(0, 1e5, n))]
    before = ops.KERNEL.launches
    out = ops.advance_fleet(*args, DEFAULT_PARAMS)
    assert ops.KERNEL.launches == before + 1
    ref = aging_update_ref(*args, DEFAULT_PARAMS)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-9)


def _aging_args(device, n, seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in (rng.uniform(0, 0.05, n),
                      rng.choice([48.0, 51.08, 54.0], n),
                      rng.choice([0.0, 1.0], n),
                      rng.uniform(0, 1e5, n))]


@pytest.mark.parametrize("n", [3, 5, 4099, 1_280_003])
def test_aging_kernel_ragged_sizes(cuda_device, n):
    """Sizes that fill no whole block (3 to 4,099), and one past the grid
    of 16 blocks per SM, so threads take several elements (1,280,003)."""
    args = _aging_args(cuda_device, n, n)
    out = ops.advance_fleet(*args, DEFAULT_PARAMS)
    ref = aging_update_ref(*args, DEFAULT_PARAMS)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("n", [8000, 1_280_000])
def test_aging_kernel_on_offset_views(cuda_device, n):
    """Views one element into their storage, as flat views of the fleet
    state may be (no 16-byte alignment): read as they are."""
    args = [a[1:] for a in _aging_args(cuda_device, n + 1, 7)]
    assert all(a.data_ptr() % 16 for a in args)
    before = ops.KERNEL.launches
    out = ops.advance_fleet(*args, DEFAULT_PARAMS)
    assert ops.KERNEL.launches == before + 1
    ref = aging_update_ref(*args, DEFAULT_PARAMS)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-9)


def test_aging_kernel_rejects_mixed_devices(cuda_device):
    args = [torch.zeros(8, device=cuda_device) for _ in range(4)]
    args[2] = args[2].cpu()
    with pytest.raises(ValueError, match="is on cpu"):
        ops.advance_fleet(*args, DEFAULT_PARAMS)


def test_fleet_on_cuda_matches_cpu(cuda_device):
    """The torch backend through the CUDA kernel (two launches per
    idling period) agrees with the same backend on the CPU. Float32
    reductions run in another order on the card: 1e-5 relative."""
    cfg = ExperimentConfig(duration_s=60.0)
    ops.KERNEL.launches = 0
    on_gpu = run_experiment(cfg.with_engine("fleet", backend="torch"))
    assert ops.KERNEL.launches == 2 * 60
    on_cpu = run_experiment(cfg.with_engine("fleet", backend="torch",
                                            device="cpu"))
    assert on_gpu.completed == on_cpu.completed
    for a, b in ((on_gpu.mean_latency_s, on_cpu.mean_latency_s),
                 (on_gpu.fleet_yearly_kgco2eq, on_cpu.fleet_yearly_kgco2eq),
                 (on_gpu.mean_degradation_percentiles[50],
                  on_cpu.mean_degradation_percentiles[50])):
        assert _rel(a, b) < 1e-5


def _settled_cluster_state(settler_kw):
    """A mid-run event-engine cluster (22 machines x 40 cores, 5 s of the
    default config), then one more settle 0.7 s on by the given settler;
    returns the stacked dVth."""
    cfg = ExperimentConfig(duration_s=5.0)
    cluster = Cluster(cfg)
    trace = get_scenario(cfg.scenario).generate(
        rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed)
    cluster.run(trace, cfg.duration_s)
    managers = [m.manager for m in cluster.machines]
    FleetAgingSettler(managers, **settler_kw).settle(5.7)
    return np.stack([m.dvth for m in managers])


def test_event_settler_on_cuda_matches_numpy(cuda_device):
    """The torch settler through the CUDA aging kernel (one launch) on
    one identical fleet state, within the reference's TestJaxBackend
    bound."""
    want = _settled_cluster_state({})
    ops.KERNEL.launches = 0
    got = _settled_cluster_state({"backend": "torch", "device": "cuda"})
    assert ops.KERNEL.launches == 1
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-8)


# The reference's TestFleetEngineFaults config and options
# (tests/test_faults.py), and TestBackendAgreement's bounds
# (tests/test_fleetsim.py)
FAULT_CELLS = {"guardband": {"margin": 0.012},
               "machine-crash": {"mttf_s": 120.0},
               "transient-stall": {"rate_per_s": 0.1}}
BACKEND_BOUNDS = {"completed": 0.01, "mean_latency_s": 0.01,
                  "p50_degradation": 0.02, "fleet_yearly_kgco2eq": 0.05}


def _conserved(r) -> bool:
    return (r.completed + r.failed_requests + r.rejected_requests
            + r.pending_requests) == r.submitted


def _backend_deltas(res, ref) -> dict:
    return {"completed": _rel(res.completed, ref.completed),
            "mean_latency_s": _rel(res.mean_latency_s, ref.mean_latency_s),
            "p50_degradation": _rel(res.mean_degradation_percentiles[50],
                                    ref.mean_degradation_percentiles[50]),
            "fleet_yearly_kgco2eq": _rel(res.fleet_yearly_kgco2eq,
                                         ref.fleet_yearly_kgco2eq)}


@pytest.mark.parametrize("name", sorted(FAULT_CELLS))
def test_fleet_faults_on_cuda_match_numpy(cuda_device, name):
    """The torch backend on CUDA under each fault model the fleet engine
    vectorizes (failed cores reach the aging kernel as unstressed),
    against the port's numpy backend: the aging kernel launched twice a
    period; crashes, stalls and failed cores equal, retries within 1 and
    availability within 1e-3 relative (the reference's
    `test_backends_agree_on_counts`); the rest at TestBackendAgreement's
    bounds."""
    cfg = ExperimentConfig(policy="proposed", duration_s=60.0, seed=7,
                           fault_model=name, fault_opts=FAULT_CELLS[name])
    ops.KERNEL.launches = 0
    on_gpu = run_experiment(cfg.with_engine("fleet", backend="torch"))
    assert ops.KERNEL.launches == 2 * 60
    ref = run_experiment(cfg.with_engine("fleet", backend="numpy"))
    assert (on_gpu.machine_crashes, on_gpu.stalls, on_gpu.core_failures) \
        == (ref.machine_crashes, ref.stalls, ref.core_failures)
    assert abs(on_gpu.retries - ref.retries) <= 1
    assert _rel(on_gpu.availability, ref.availability) < 1e-3
    assert _conserved(on_gpu)
    for key, delta in _backend_deltas(on_gpu, ref).items():
        assert delta < BACKEND_BOUNDS[key], key


def test_mixed_fleet_on_cuda_matches_numpy(cuda_device):
    """A padded mixed fleet (5 machines of 28 cores, 17 of 64) on the
    card against the numpy backend at TestBackendAgreement's bounds: the
    padded lanes reach the aging kernel as unstressed and stay at dVth
    0.0 on both backends."""
    cfg = ExperimentConfig(duration_s=60.0,
                           fleet="xeon-28c:5+epyc-64c:rest")
    reqs = get_scenario(cfg.scenario).generate(
        rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed)
    engines = {}
    for backend in ("torch", "numpy"):
        ops.KERNEL.launches = 0
        eng = FleetEngine(cfg.with_engine("fleet", backend=backend))
        eng.run(reqs)
        engines[backend] = eng
        assert ops.KERNEL.launches == (2 * 60 if backend == "torch" else 0)
        pad = eng._pad
        assert pad.sum() == 5 * 36
        assert (eng.state["dvth"][pad] == 0.0).all()
        assert (eng.state["dvth"][~pad] > 0.0).all()
    on_gpu, ref = (engines[b].collect() for b in ("torch", "numpy"))
    for key, delta in _backend_deltas(on_gpu, ref).items():
        assert delta < BACKEND_BOUNDS[key], key


@pytest.mark.parametrize("fault", [None, "guardband"])
def test_fleet_resume_on_cuda_is_exact(cuda_device, tmp_path, fault):
    """Kill-and-resume on the card (60 s, a checkpoint every 20 s, the
    steps after the first deleted) equals the uninterrupted run exactly;
    the resumed run launches the aging kernel only for the periods it
    runs."""
    kw = {"fault_model": fault, "fault_opts": {"margin": 0.012}} \
        if fault else {}
    ckpt = tmp_path / "ckpt"
    cfg = ExperimentConfig(duration_s=60.0, **kw).with_engine(
        "fleet", backend="torch", checkpoint_dir=str(ckpt),
        checkpoint_every_s=20.0)
    uninterrupted = run_experiment(cfg).to_dict()
    steps = sorted(ckpt.iterdir())
    assert [p.name for p in steps] == ["step_00000020", "step_00000040"]
    for p in steps[1:]:
        for f in p.iterdir():
            f.unlink()
        p.rmdir()
    ops.KERNEL.launches = 0
    resumed = run_experiment(cfg).to_dict()
    assert ops.KERNEL.launches == 2 * 40
    for d in (uninterrupted, resumed):
        d["provenance"].pop("package_version", None)
    assert resumed == uninterrupted


def test_store_restores_onto_the_card(cuda_device, tmp_path):
    """A CUDA-tensor template restores as tensors of its dtypes on the
    card, bfloat16 bits included."""
    src = {"w": torch.randn(3, 4, generator=torch.Generator().manual_seed(0)),
           "b": torch.tensor([0.5, -1.25, 3.0], dtype=torch.bfloat16),
           "n": np.arange(5, dtype=np.int64)}
    store.save(str(tmp_path), 1, src)
    template = {"w": torch.zeros(3, 4, device=cuda_device),
                "b": torch.zeros(3, dtype=torch.bfloat16,
                                 device=cuda_device),
                "n": torch.zeros(5, dtype=torch.int32, device=cuda_device)}
    back = store.restore(str(tmp_path), template)
    for key in ("w", "b", "n"):
        assert back[key].device.type == "cuda", key
        assert back[key].dtype == template[key].dtype, key
    assert torch.equal(back["w"].cpu(), src["w"])
    assert torch.equal(back["b"].cpu().view(torch.int16),
                       src["b"].view(torch.int16))
    assert back["n"].tolist() == list(range(5))


def _guardband_pair(settler_kw):
    """The reference's TestGuardbandAcceptance pair (seed 3, 60 s, margin
    0.012) under linux and proposed, settled by the given settler."""
    base = ExperimentConfig(seed=3, duration_s=60.0, fault_model="guardband",
                            fault_opts=(("margin", 0.012),))
    out = {}
    for policy in ("linux", "proposed"):
        cfg = base.with_policy(policy)
        cluster = Cluster(cfg)
        if settler_kw:
            cluster.fleet_settler = FleetAgingSettler(
                [m.manager for m in cluster.machines], **settler_kw)
        trace = get_scenario(cfg.scenario).generate(
            rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed)
        cluster.run(trace, cfg.duration_s,
                    sample_period_s=cfg.sample_period_s)
        out[policy] = collect(cluster, cfg)
    return out


def test_event_settler_on_cuda_under_guardband(cuda_device):
    """The acceptance pair with the torch settler on the card: one aging
    launch per idling period (60 a run); proposed fails fewer cores and
    keeps higher availability than linux, requests are conserved, and
    each run is within TestBackendAgreement's bounds of the numpy
    settler's."""
    want = _guardband_pair({})
    ops.KERNEL.launches = 0
    got = _guardband_pair({"backend": "torch", "device": "cuda"})
    assert ops.KERNEL.launches == 2 * 60
    assert got["proposed"].core_failures < got["linux"].core_failures
    assert got["proposed"].availability > got["linux"].availability
    for policy, res in got.items():
        assert _conserved(res)
        for key, delta in _backend_deltas(res, want[policy]).items():
            assert delta < BACKEND_BOUNDS[key], (policy, key)


def test_attention_kernels_refuse_other_head_dim_pairs(cuda_device):
    """B2 and B3 have instances for equal head dims of 32, 64, 128 and 112
    and for MLA's (96, 64) only: on CUDA their wrappers raise for any
    other pair, launch nothing, and take no plain route for a v head dim
    other than q's."""
    q, v = _draw(cuda_device, torch.bfloat16, 0, (1, 8, 4, 96),
                 (1, 8, 4, 32))
    z = _draw(cuda_device, torch.bfloat16, 0, (1, 8, 4, 48))[0]
    before = (fa_ops.KERNEL.launches, dec_ops.KERNEL.launches)
    for use_kernel in (True, False):
        with pytest.raises(ValueError, match="no instance"):
            fa_ops.attention_bhsd(q, q, v, use_kernel=use_kernel)
        with pytest.raises(ValueError, match="no instance"):
            dec_ops.decode_bhd(q[:, 0], q, v, 4, use_kernel=use_kernel)
    with pytest.raises(ValueError, match="head dims in"):
        fa_ops.attention_bhsd(z, z, z)
    with pytest.raises(ValueError, match="head dims in"):
        dec_ops.decode_bhd(z[:, 0], z, z, 4)
    assert (fa_ops.KERNEL.launches, dec_ops.KERNEL.launches) == before


def _tol(dtype):
    """`tests/test_kernels.py::tol`."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


def _draw(device, dtype, seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                         device=device).to(dtype) for s in shapes]


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("b,h,hkv,s,d,window", [
    (1, 4, 4, 128, 64, 0), (2, 8, 2, 256, 64, 0), (1, 4, 1, 128, 128, 0),
    (2, 2, 2, 192, 64, 0), (1, 2, 2, 256, 64, 32), (1, 2, 2, 256, 64, 128),
    (1, 32, 8, 128, 128, 0), (1, 32, 8, 1000, 128, 0),
    (1, 32, 8, 1024, 128, 0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain_version(cuda_device, b, h, hkv, s, d,
                                            window, dtype):
    q, k, v = _draw(cuda_device, dtype, 0, (b, s, h, d), (b, s, hkv, d),
                    (b, s, hkv, d))
    before = fa_ops.KERNEL.launches
    out = fa_ops.attention_bhsd(q, k, v, window=window)
    assert fa_ops.KERNEL.launches == before + 1
    ref = fa_ops.attention_bhsd(q, k, v, window=window, use_kernel=False)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


@pytest.mark.parametrize("b,h,hkv,s,d,window", [
    (1, 4, 4, 512, 64, 0), (4, 8, 2, 1024, 64, 0), (2, 8, 1, 512, 128, 0),
    (2, 4, 4, 640, 64, 0), (2, 4, 4, 512, 64, 128),
    (4, 32, 8, 1536, 128, 0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain_version(cuda_device, b, h, hkv, s, d,
                                             window, dtype):
    q, kc, vc = _draw(cuda_device, dtype, 1, (b, h, d), (b, s, hkv, d),
                      (b, s, hkv, d))
    pos = torch.tensor(np.random.default_rng(s).integers(1, s + 1, b),
                       dtype=torch.int32, device=cuda_device)
    before = dec_ops.KERNEL.launches
    out = dec_ops.decode_bhd(q, kc, vc, pos, window=window)
    assert dec_ops.KERNEL.launches == before + 1
    ref = dec_ops.decode_bhd(q, kc, vc, pos, window=window,
                             use_kernel=False)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


def _flash_hold(device, b, h, hkv, sq, skv, d, seed=0, dv=None, **kw):
    """The bfloat16 (tensor-core) flash kernel against its plain version
    at the reference's bfloat16 tolerance; one launch."""
    q, k, v = _draw(device, torch.bfloat16, seed, (b, sq, h, d),
                    (b, skv, hkv, d), (b, skv, hkv, dv or d))
    before = fa_ops.KERNEL.launches
    out = fa_ops.attention_bhsd(q, k, v, **kw)
    assert fa_ops.KERNEL.launches == before + 1
    ref = fa_ops.attention_bhsd(q, k, v, use_kernel=False, **kw)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(),
                               **_tol(torch.bfloat16))


@pytest.mark.parametrize("s", [1, 63, 65, 129, 1000])
def test_flash_tc_ragged_lengths(cuda_device, s):
    """Lengths that are no multiple of the 128-query or 64-key tile: TMA
    fills the rows past S with zeros, the mask drops them."""
    _flash_hold(cuda_device, 2, 8, 2, s, s, 128)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_tc_head_dims(cuda_device, d):
    """Every head_dim the wrapper admits: 64-byte swizzle at 32, 128-byte
    at 64 and 128 (two boxes per row)."""
    _flash_hold(cuda_device, 1, 4, 2, 200, 200, d)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_flash_tc_gqa(cuda_device, group):
    _flash_hold(cuda_device, 1, 8, 8 // group, 300, 300, 128)


@pytest.mark.parametrize("window", [32, 128])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_tc_window(cuda_device, window, d):
    """Sliding windows: key tiles below the band are skipped, tiles on
    its edge masked."""
    _flash_hold(cuda_device, 2, 4, 2, 700, 700, d, window=window)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_flash_tc_q_offset(cuda_device, causal, window):
    """A chunk of queries after a longer prefix (Sq < Skv, q_offset > 0),
    and cross attention without a mask."""
    _flash_hold(cuda_device, 2, 8, 2, 100, 300, 128, causal=causal,
                window=window, q_offset=200 if causal else 0)


# Zamba2's shared block: head dim 112 (224-byte rows), 32 heads over 32
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("b,h,s,window", [(1, 32, 1024, 0), (2, 8, 300, 0),
                                          (1, 4, 129, 0), (2, 4, 700, 96)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_zamba2_head_dim(cuda_device, b, h, s, window, causal,
                                      dtype):
    """B2's (112, 112) instance against its plain version in both dtypes,
    causal and not, on q, k and v sliced from one packed (B, S, 3 H, 112)
    tensor (rows of 224 bytes, strides of 3 H of them): in bfloat16, tiles
    of 128 columns in shared memory whose columns 112 to 127 TMA fills
    with zeros (two boxes of 64 at the 128-byte swizzle), the output
    written on its 112 columns only (a head's row is followed by the
    next head's); the CUDA-core kernel in float32."""
    qkv = _draw(cuda_device, dtype, 7, (b, s, 3 * h, 112))[0]
    q, k, v = qkv[:, :, :h], qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]
    before = fa_ops.KERNEL.launches
    out = fa_ops.attention_bhsd(q, k, v, causal=causal, window=window)
    assert fa_ops.KERNEL.launches == before + 1
    assert out.shape == (b, s, h, 112)
    ref = fa_ops.attention_bhsd(q, k, v, causal=causal, window=window,
                                use_kernel=False)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_bidirectional_at_seamless_encoder(cuda_device, dtype):
    """Seamless's encoder: (1, 1,024 frames, 16 heads over 16, 64),
    non-causal, against the plain version."""
    qkv = _draw(cuda_device, dtype, 8, (1, 1024, 16, 64),
                (1, 1024, 16, 64), (1, 1024, 16, 64))
    counts = fa_ops.KERNEL.variant_launches
    before = fa_ops.KERNEL.launches, counts["noncausal"]
    out = fa_ops.attention_bhsd(*qkv, causal=False)
    assert (fa_ops.KERNEL.launches, counts["noncausal"]) == (
        before[0] + 1, before[1] + 1)
    fa_ops.attention_bhsd(*qkv, causal=True)
    assert (fa_ops.KERNEL.launches, counts["noncausal"]) == (
        before[0] + 2, before[1] + 1)
    ref = fa_ops.attention_bhsd(*qkv, causal=False, use_kernel=False)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


@pytest.mark.parametrize("lens", [[1536, 1, 700, 9], 1000],
                         ids=["slots", "scalar"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_zamba2_head_dim(cuda_device, lens, dtype):
    """B3's (112, 112) instance against its plain version: q (4, 32, 112)
    against caches (4, 1,536, 32, 112), a per-slot and a scalar pos; four
    elements a lane in lanes 0 to 27, none in 28 to 31."""
    b, h, s = 4, 32, 1536
    q, kc, vc = _draw(cuda_device, dtype, 9, (b, h, 112), (b, s, h, 112),
                      (b, s, h, 112))
    pos = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = dec_ops.KERNEL.launches
    out = dec_ops.decode_bhd(q, kc, vc, pos)
    assert dec_ops.KERNEL.launches == before + 1
    assert out.shape == (b, h, 112)
    ref = dec_ops.decode_bhd(q, kc, vc, pos, use_kernel=False)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


@pytest.mark.parametrize("hkv", [8, 2])
def test_decode_kernel_zamba2_head_dim_grouped(cuda_device, hkv):
    """The (112, 112) instance under the kG = 4 and 16 groupings too."""
    _decode_hold(cuda_device, 2, 32, hkv, 1024, 112, [999, 17])


def _decode_hold(device, b, h, hkv, s, d, lens, dtype=torch.bfloat16,
                 window=0, seed=1, dv=None):
    q, kc, vc = _draw(device, dtype, seed, (b, h, d), (b, s, hkv, d),
                      (b, s, hkv, dv or d))
    pos = torch.tensor(lens, dtype=torch.int32, device=device)
    before = dec_ops.KERNEL.launches
    out = dec_ops.decode_bhd(q, kc, vc, pos, window=window)
    assert dec_ops.KERNEL.launches == before + 1
    ref = dec_ops.decode_bhd(q, kc, vc, pos, window=window,
                             use_kernel=False)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_edge_positions(cuda_device, dtype):
    """pos = 1 (one visible row, most slices empty) and pos = max_len."""
    _decode_hold(cuda_device, 4, 32, 8, 1536, 128, [1, 1536, 1, 1536],
                 dtype=dtype)


@pytest.mark.parametrize("window", [64, 300])
def test_decode_kernel_bf16_window(cuda_device, window):
    _decode_hold(cuda_device, 4, 32, 8, 1536, 128, [1, 50, 700, 1536],
                 window=window)


def test_decode_kernel_batch_one(cuda_device):
    """One sequence: the most slices per (sequence, cache head)."""
    _decode_hold(cuda_device, 1, 32, 8, 1536, 128, [1234])


@pytest.mark.parametrize("d", [64, 128])
def test_decode_kernel_sixteen_heads_per_cache_head(cuda_device, d):
    _decode_hold(cuda_device, 2, 32, 2, 1024, d, [999, 17])


# MLA (MiniCPM3): q/k head dim 96 (qk_nope 64 + qk_rope 32), v head dim 64,
# 40 heads over 40
@pytest.mark.parametrize("b,h,s,window", [(1, 40, 1024, 0), (2, 8, 300, 0),
                                          (1, 4, 129, 0), (2, 4, 700, 96)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_mla_head_dims(cuda_device, b, h, s, window, dtype):
    """B2's (96, 64) instance, causal, against its plain version in both
    dtypes: the 64-byte swizzle of q and k (three boxes of 32 columns) and
    v's own 128-byte tile in bfloat16, the CUDA-core kernel in float32."""
    q, k, v = _draw(cuda_device, dtype, 5, (b, s, h, 96), (b, s, h, 96),
                    (b, s, h, 64))
    before = fa_ops.KERNEL.launches
    out = fa_ops.attention_bhsd(q, k, v, window=window)
    assert fa_ops.KERNEL.launches == before + 1
    assert out.shape == (b, s, h, 64)
    ref = fa_ops.attention_bhsd(q, k, v, window=window, use_kernel=False)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


def test_flash_tc_mla_q_offset_and_scale(cuda_device):
    """A chunk of queries after a prefix, MLA's scale (96 ** -0.5)."""
    _flash_hold(cuda_device, 1, 8, 8, 100, 300, 96, dv=64, q_offset=200,
                scale=96 ** -0.5)


@pytest.mark.parametrize("lens", [[1536, 1, 700, 9], 1000],
                         ids=["slots", "scalar"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_mla_head_dims(cuda_device, lens, dtype):
    """B3's (96, 64) instance against its plain version: q (4, 40, 96)
    against caches (4, 1,536, 40, 96) and (4, 1,536, 40, 64), with a
    per-slot and a scalar pos."""
    b, h, s = 4, 40, 1536
    q, kc, vc = _draw(cuda_device, dtype, 6, (b, h, 96), (b, s, h, 96),
                      (b, s, h, 64))
    pos = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = dec_ops.KERNEL.launches
    out = dec_ops.decode_bhd(q, kc, vc, pos, scale=96 ** -0.5)
    assert dec_ops.KERNEL.launches == before + 1
    assert out.shape == (b, h, 64)
    ref = dec_ops.decode_bhd(q, kc, vc, pos, scale=96 ** -0.5,
                             use_kernel=False)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


@pytest.mark.parametrize("lens", [[1536, 1, 700, 9], 1000],
                         ids=["slots", "scalar"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_mla_rope_apart(cuda_device, lens, dtype):
    """B3's (96, 64) instance with K in two parts, as MiniCPM3's decode
    gives it: each head's nope part k_nope (4, 1,536, 40, 64) and the rope
    part that all 40 share, the [..., 256:288] view of a (4, 1,536, 288)
    latent, read in place. Bit for bit B3 on the concatenated K, and the
    plain version within `test_decode_kernel_mla_head_dims`'s tolerances;
    one launch, counted as a rope-apart call."""
    b, h, s = 4, 40, 1536
    q, k_nope, vc, latent = _draw(cuda_device, dtype, 8, (b, h, 96),
                                  (b, s, h, 64), (b, s, h, 64), (b, s, 288))
    k_rope = latent[..., 256:288]
    pos = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = (dec_ops.KERNEL.launches, dec_ops.rope_apart_calls)
    out = dec_ops.decode_bhd(q, k_nope, vc, pos, scale=96 ** -0.5,
                             k_rope=k_rope)
    assert (dec_ops.KERNEL.launches, dec_ops.rope_apart_calls) == (
        before[0] + 1, before[1] + 1)
    assert out.shape == (b, h, 64)
    whole = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, 32)], -1)
    assert torch.equal(out, dec_ops.decode_bhd(q, whole, vc, pos,
                                               scale=96 ** -0.5))
    ref = dec_ops.decode_bhd(q, k_nope, vc, pos, scale=96 ** -0.5,
                             k_rope=k_rope, use_kernel=False)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


@pytest.mark.parametrize("hkv", [8, 2])
def test_decode_kernel_mla_head_dims_grouped(cuda_device, hkv):
    """The (96, 64) instance under the kG = 4 and 16 groupings too."""
    _decode_hold(cuda_device, 2, 32, hkv, 1024, 96, [999, 17], dv=64)


# MLA (DeepSeek-V2-Lite): q/k head dim 192 (qk_nope 128 + qk_rope 64), v
# head dim 128, 16 heads over 16
def _sdpa(q, k, v, scale, mask=None):
    """torch's SDPA over (B, S, H, D) tensors, causal without a mask."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=mask is None, scale=scale)
    return out.transpose(1, 2)


@pytest.mark.parametrize("b,h,s,window", [(1, 16, 4096, 0), (2, 16, 300, 0),
                                          (1, 4, 129, 0), (2, 4, 700, 96)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_deepseek_head_dims(cuda_device, b, h, s, window,
                                         dtype):
    """B2's (192, 128) instance, causal, against its plain version and
    SDPA in both dtypes: q and k as three 128-byte boxes of 64 columns,
    v as two, in bfloat16; the CUDA-core kernel in float32. DeepSeek's
    scale, 192 ** -0.5 times YaRN's mscale squared."""
    scale = 192 ** -0.5 * 1.2607945 ** 2
    q, k, v = _draw(cuda_device, dtype, 12, (b, s, h, 192), (b, s, h, 192),
                    (b, s, h, 128))
    before = fa_ops.KERNEL.launches
    out = fa_ops.attention_bhsd(q, k, v, window=window, scale=scale)
    assert fa_ops.KERNEL.launches == before + 1
    assert out.shape == (b, s, h, 128)
    ref = fa_ops.attention_bhsd(q, k, v, window=window, scale=scale,
                                use_kernel=False)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))
    if not window:
        torch.testing.assert_close(out.float(),
                                   _sdpa(q, k, v, scale).float(),
                                   **_tol(dtype))


def test_flash_tc_deepseek_q_offset(cuda_device):
    """A chunk of queries after a prefix at (192, 128)."""
    _flash_hold(cuda_device, 1, 16, 16, 100, 300, 192, dv=128,
                q_offset=200, scale=192 ** -0.5)


@pytest.mark.parametrize("lens", [[16388, 1, 7000, 9], 4096],
                         ids=["slots", "scalar"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_deepseek_head_dims(cuda_device, lens, dtype):
    """B3's (192, 128) instance against its plain version and SDPA: q (4,
    16, 192) against caches (4, 16,388, 16, 192) and (4, 16,388, 16, 128),
    the prefill-long cell's cache, with a per-slot and a scalar pos."""
    b, h, s = 4, 16, 16388
    scale = 192 ** -0.5
    q, kc, vc = _draw(cuda_device, dtype, 13, (b, h, 192), (b, s, h, 192),
                      (b, s, h, 128))
    pos = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = dec_ops.KERNEL.launches
    out = dec_ops.decode_bhd(q, kc, vc, pos, scale=scale)
    assert dec_ops.KERNEL.launches == before + 1
    assert out.shape == (b, h, 128)
    ref = dec_ops.decode_bhd(q, kc, vc, pos, scale=scale, use_kernel=False)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))
    mask = torch.arange(s, device=cuda_device)[None, None, None, :] < \
        pos.expand(b)[:, None, None, None]
    sdpa = _sdpa(q[:, None], kc, vc, scale, mask)[:, 0]
    torch.testing.assert_close(out.float(), sdpa.float(), **_tol(dtype))


@pytest.mark.parametrize("lens", [[16388, 1, 7000, 9], 4096],
                         ids=["slots", "scalar"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_deepseek_rope_apart(cuda_device, lens, dtype):
    """B3's (192, 128) instance with K in two parts, as DeepSeek-V2-Lite's
    decode gives it: each head's nope part (4, 16,388, 16, 128) and the
    rope part all 16 share, the [..., 512:576] view of a (4, 16,388, 576)
    latent, read in place. Bit for bit B3 on K written out whole, and the
    plain version within the bf16 bound; one launch, counted as a
    rope-apart call."""
    b, h, s = 4, 16, 16388
    q, k_nope, vc, latent = _draw(cuda_device, dtype, 14, (b, h, 192),
                                  (b, s, h, 128), (b, s, h, 128),
                                  (b, s, 576))
    k_rope = latent[..., 512:576]
    pos = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    scale = 192 ** -0.5
    before = (dec_ops.KERNEL.launches, dec_ops.rope_apart_calls)
    out = dec_ops.decode_bhd(q, k_nope, vc, pos, scale=scale, k_rope=k_rope)
    assert (dec_ops.KERNEL.launches, dec_ops.rope_apart_calls) == (
        before[0] + 1, before[1] + 1)
    whole = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, 64)], -1)
    assert torch.equal(out, dec_ops.decode_bhd(q, whole, vc, pos,
                                               scale=scale))
    ref = dec_ops.decode_bhd(q, k_nope, vc, pos, scale=scale, k_rope=k_rope,
                             use_kernel=False)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


@pytest.mark.parametrize("hkv", [8, 1])
def test_decode_kernel_deepseek_head_dims_grouped(cuda_device, hkv):
    """The (192, 128) instance under the kG = 4 and 16 groupings too."""
    _decode_hold(cuda_device, 2, 16, hkv, 1024, 192, [999, 17], dv=128)


def test_grouped_experts_on_the_card(cuda_device):
    """The dropless MoE's grouped product in bfloat16 (`torch._grouped_mm`,
    empty groups among them) against each group's product in float32, and
    a DeepSeek-V2-Lite expert layer at its published widths (2,048 wide,
    64 experts of 1,408, top 6, the shared experts) in bfloat16 against
    the same layer in float32 on the card's loop path, over 512 tokens
    (their values and weights rounded to bfloat16 alike)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(300, 256, device=cuda_device, generator=gen)
    w = torch.randn(6, 256, 128, device=cuda_device, generator=gen) / 16
    ends = torch.tensor([50, 50, 170, 170, 299, 300], device=cuda_device)
    got = moe.grouped_mm(a.bfloat16(), w.bfloat16(), ends)
    want = moe.grouped_mm(a, w, ends)
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    cfg = dataclasses.replace(get_config("deepseek-v2-lite"), num_layers=2)
    d, e, f, fs = cfg.d_model, cfg.num_experts, cfg.moe_d_ff, \
        cfg.moe_shared_d_ff
    params = {"router": torch.randn(d, e, device=cuda_device,
                                    generator=gen) * 0.02}
    for name, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                        ("w_down", (e, f, d))):
        params[name] = torch.randn(shape, device=cuda_device,
                                   generator=gen) * 0.02
    shared = {"w_gate": torch.randn(d, fs, device=cuda_device,
                                    generator=gen) * 0.02,
              "w_up": torch.randn(d, fs, device=cuda_device,
                                  generator=gen) * 0.02,
              "w_down": torch.randn(fs, d, device=cuda_device,
                                    generator=gen) * 0.02}
    # bf16 values on both sides, so both route alike (the router takes
    # the same float32 inputs)
    x = torch.randn(1, 512, d, device=cuda_device,
                    generator=gen).bfloat16()
    bf = {k: v if k == "router" else v.bfloat16() for k, v in params.items()}
    bf_shared = {k: v.bfloat16() for k, v in shared.items()}
    want, _ = moe.moe_ffn(x.float(), {k: v.float() for k, v in bf.items()},
                          cfg, {k: v.float() for k, v in bf_shared.items()})
    moe.reset_counters()
    got, _ = moe.moe_ffn(x, bf, cfg, bf_shared)
    counts = moe.counters()
    assert counts["calls"] == 1 and counts["routed_rows"] == 512 * 6
    assert counts["experts_touched"] == 64
    torch.testing.assert_close(got.float(), want, **_tol(torch.bfloat16))


def test_decode_kernel_replays_in_a_cuda_graph(cuda_device):
    """One launch per call, captured in a CUDA graph and replayed three
    times with other positions: each replay agrees with the plain
    version, so the kernel leaves its ticket counters at 0."""
    b, h, hkv, s, d = 4, 32, 8, 1536, 128
    q, kc, vc = _draw(cuda_device, torch.bfloat16, 2, (b, h, d),
                      (b, s, hkv, d), (b, s, hkv, d))
    pos = torch.ones(b, dtype=torch.int32, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up: build, make the counters
        dec_ops.decode_bhd(q, kc, vc, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dec_ops.KERNEL.launches
    with torch.cuda.graph(graph):
        out = dec_ops.decode_bhd(q, kc, vc, pos)
    assert dec_ops.KERNEL.launches == before + 1
    rng = np.random.default_rng(4)
    for _ in range(3):
        pos.copy_(torch.tensor(rng.integers(1, s + 1, b), dtype=torch.int32))
        graph.replay()
        ref = dec_ops.decode_bhd(q, kc, vc, pos, use_kernel=False)
        torch.testing.assert_close(out.float(), ref.float(),
                                   **_tol(torch.bfloat16))
    torch.cuda.synchronize()
    assert int(dec_ops.counters(cuda_device, b * hkv)[:b * hkv].abs().sum()) \
        == 0


def test_decode_kernel_is_one_launch(cuda_device):
    """The profiler sees one kernel on the device per call: the split
    pass merges its own slices."""
    from torch.profiler import ProfilerActivity, profile
    q, kc, vc = _draw(cuda_device, torch.bfloat16, 3, (4, 32, 128),
                      (4, 1536, 8, 128), (4, 1536, 8, 128))
    pos = torch.full((4,), 1000, dtype=torch.int32, device=cuda_device)
    dec_ops.decode_bhd(q, kc, vc, pos)     # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dec_ops.decode_bhd(q, kc, vc, pos)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "emory" not in e.name]
    assert kernels and all("decode_attention_kernel" in n for n in kernels)
    assert len(kernels) == 1


def test_model_goes_through_both_kernels(cuda_device):
    """Prefill: one flash launch per layer; decode: one decode launch per
    layer. The plain path agrees at float32 to the kernels' bound."""
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              dtype="float32")
    model = Model(cfg, device=cuda_device, seed=0)
    toks = torch.tensor(np.random.default_rng(2).integers(0, 1000, (2, 40)),
                        device=cuda_device)
    fa_ops.KERNEL.launches = dec_ops.KERNEL.launches = 0
    logits, cache = model.prefill(toks, max_len=48)
    plain, plain_cache = model.prefill(toks, max_len=48, use_kernel=False)
    tok = toks[:, -1:]
    for _ in range(3):
        logits, cache = model.decode_step(cache, tok)
        plain, plain_cache = model.decode_step(plain_cache, tok,
                                               use_kernel=False)
        torch.testing.assert_close(logits, plain, rtol=1e-4, atol=1e-4)
    assert fa_ops.KERNEL.launches == cfg.num_layers
    assert dec_ops.KERNEL.launches == 3 * cfg.num_layers


def test_engine_on_cuda_matches_cpu(cuda_device):
    """Same weights, same prompts: the engine on the card (through both
    kernels) gives the CPU engine's greedy tokens at float32."""
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              dtype="float32")
    on_cpu = Model(cfg, device="cpu", seed=0)
    on_gpu = Model(cfg, device=cuda_device, seed=0)
    on_gpu.load_state_dict(on_cpu.state_dict())
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 999, n).tolist() for n in (5, 12, 7, 9)]
    outputs = []
    for model in (on_cpu, on_gpu):
        eng = InferenceEngine(model, max_batch=2, max_len=32,
                              clock=lambda: 0.0)
        reqs = []
        for p in prompts:
            eng.submit(p, 5)
            reqs.append(eng.pending[-1])
        eng.run_until_drained()
        outputs.append([r.output for r in reqs])
    assert outputs[0] == outputs[1]


# MiniCPM3's smoke config at MLA's head dims of the full model (qk_nope 64
# + qk_rope 32, v 64), the instance the kernels have; the smoke's own
# 16 + 8 / 16 are no instance
MLA_SMOKE = dict(qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64)
# DeepSeek-V2-Lite's smoke config at its full head dims (128 + 64, v 128)
DEEPSEEK_SMOKE = dict(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128)
MOE_MLA = {"granite-moe-3b-a800m": {}, "minicpm3-4b": MLA_SMOKE,
           "minicpm3-4b-absorb": dict(MLA_SMOKE, mla_absorb=True),
           "deepseek-v2-lite": DEEPSEEK_SMOKE}


def _moe_mla_cfg(name):
    return dataclasses.replace(get_smoke_config(name.replace("-absorb", "")),
                               dtype="float32", **MOE_MLA[name])


@pytest.mark.parametrize("name", sorted(MOE_MLA))
def test_moe_and_mla_models_go_through_both_kernels(cuda_device, name):
    """granite-moe (GQA at head dim 32, experts in torch) and minicpm3
    (MLA at (96, 64)) smoke models at float32: prefill one flash launch
    per layer, decode one decode launch per layer (none with
    `mla_absorb`, whose attention is plain PyTorch); the kernel path
    agrees with the plain path to the kernels' float32 bound."""
    cfg = _moe_mla_cfg(name)
    model = Model(cfg, device=cuda_device, seed=0)
    toks = torch.tensor(np.random.default_rng(2).integers(0, 1000, (2, 40)),
                        device=cuda_device)
    fa_ops.KERNEL.launches = dec_ops.KERNEL.launches = 0
    logits, cache = model.prefill(toks, max_len=48)
    plain, plain_cache = model.prefill(toks, max_len=48, use_kernel=False)
    torch.testing.assert_close(logits, plain, rtol=1e-4, atol=1e-4)
    cache["pos"] = plain_cache["pos"] = torch.tensor(
        [40, 33], dtype=torch.int32, device=cuda_device)
    tok = toks[:, -1:]
    for _ in range(3):
        logits, cache = model.decode_step(cache, tok)
        plain, plain_cache = model.decode_step(plain_cache, tok,
                                               use_kernel=False)
        torch.testing.assert_close(logits, plain, rtol=1e-4, atol=1e-4)
    assert fa_ops.KERNEL.launches == cfg.num_layers
    assert dec_ops.KERNEL.launches == (0 if cfg.mla_absorb
                                       else 3 * cfg.num_layers)


def test_deepseek_rope_apart_calls_per_decode_step(cuda_device):
    """DeepSeek-V2-Lite's 27 layers (smoke widths, its head dims) in
    bfloat16: each decode step gives B3 K's rope part apart once a layer,
    27 calls and 27 launches a step; and the step's logits equal those of
    the same step with K written out whole (`attn.whole_key`) bit for
    bit."""
    from repro_torch.models import attention as attn
    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-lite"),
                              num_layers=27, **DEEPSEEK_SMOKE)
    model = Model(cfg, device=cuda_device, seed=0)
    toks = torch.tensor(np.random.default_rng(2).integers(0, 1000, (4, 40)),
                        device=cuda_device)
    _, cache = model.prefill(toks, max_len=48)
    cache["pos"] = torch.tensor([40, 33, 21, 9], dtype=torch.int32,
                                device=cuda_device)
    kept = {k: v.clone() for k, v in cache.items()}
    before = (dec_ops.rope_apart_calls, dec_ops.KERNEL.launches)
    apart, _ = model.decode_step(cache, toks[:, -1:])
    assert (dec_ops.rope_apart_calls - before[0],
            dec_ops.KERNEL.launches - before[1]) == (27, 27)
    decode = attn.decode_attention

    def whole(q, k, v, pos, window=0, scale=None, use_kernel=True,
              k_rope=None):
        if k_rope is not None:
            k = attn.whole_key(k, k_rope)
        return decode(q, k, v, pos, window, scale, use_kernel)
    attn.decode_attention = whole
    try:
        written, _ = model.decode_step(kept, toks[:, -1:])
    finally:
        attn.decode_attention = decode
    assert torch.equal(apart, written)


@pytest.mark.parametrize("name", sorted(MOE_MLA))
def test_moe_and_mla_engine_on_cuda_matches_cpu(cuda_device, name):
    """Same weights, same prompts: the engine on the card gives the CPU
    engine's greedy tokens at float32."""
    cfg = _moe_mla_cfg(name)
    on_cpu = Model(cfg, device="cpu", seed=0)
    on_gpu = Model(cfg, device=cuda_device, seed=0)
    on_gpu.load_state_dict(on_cpu.state_dict())
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 999, n).tolist() for n in (5, 12, 7, 9)]
    outputs = []
    for model in (on_cpu, on_gpu):
        eng = InferenceEngine(model, max_batch=2, max_len=32,
                              clock=lambda: 0.0)
        reqs = []
        for p in prompts:
            eng.submit(p, 5)
            reqs.append(eng.pending[-1])
        eng.run_until_drained()
        outputs.append([r.output for r in reqs])
    assert outputs[0] == outputs[1]


# the smoke configs of the new families at instances of the kernels:
# Zamba2's shared block at its full head dim of 112 and an SSD state of 32
# (the smoke's 16 is no instance of B4)
FAMILY_SMOKE = {"zamba2-7b": dict(head_dim=112, ssm_state=32),
                "internvl2-2b": {}, "seamless-m4t-large-v2": {}}


def _family_run(model, toks, embeds, use_kernel):
    """Prefill, then three decode steps with a per-slot pos (one slot
    five tokens behind): the logits of each."""
    cfg = model.cfg
    max_len = 48 + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    logits, cache = model.prefill(toks, max_len=max_len, embeds=embeds,
                                  use_kernel=use_kernel)
    out = [logits]
    s = int(cache["pos"])
    cache["pos"] = torch.tensor([s, s - 5], dtype=torch.int32,
                                device=toks.device)
    for _ in range(3):
        logits, cache = model.decode_step(cache, toks[:, -1:],
                                          use_kernel=use_kernel)
        out.append(logits)
    return out


@pytest.mark.parametrize("arch", sorted(FAMILY_SMOKE))
def test_hybrid_vlm_and_encdec_models_go_through_the_kernels(cuda_device,
                                                            arch):
    """Zamba2, InternVL2 (with patch embeddings) and Seamless (over frame
    embeddings) smoke models at float32: each prefill launches B4 once a
    Mamba2 layer and B2 once a shared-block use (Zamba2), B2 once a layer
    (InternVL2), once an encoder and once a decoder layer (Seamless);
    each decode step launches B3 once an attention; the kernel path
    agrees with the plain path to the kernels' float32 bound."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              **FAMILY_SMOKE[arch])
    model = Model(cfg, device=cuda_device, seed=0)
    rng = np.random.default_rng(2)
    toks = torch.tensor(rng.integers(0, 1000, (2, 40)), device=cuda_device)
    embeds = None
    if cfg.frontend != "none":
        embeds = torch.tensor(rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.d_model)) * 0.02,
            dtype=torch.float32, device=cuda_device)
    for k in (fa_ops.KERNEL, dec_ops.KERNEL, ssd_ops.KERNEL):
        k.launches = 0
    got = _family_run(model, toks, embeds, True)
    launches = (fa_ops.KERNEL.launches, dec_ops.KERNEL.launches,
                ssd_ops.KERNEL.launches)
    want = _family_run(model, toks, embeds, False)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    if cfg.family == "hybrid":
        uses = cfg.num_hybrid_groups
        assert launches == (uses, 3 * uses, cfg.num_layers)
    else:
        prefill = cfg.num_layers + cfg.encoder_layers
        assert launches == (prefill, 3 * cfg.num_layers, 0)


def test_vision_engine_on_cuda_matches_cpu(cuda_device):
    """Same weights, same prompts: the engine on the card serves
    InternVL2 (text only) with the CPU engine's greedy tokens at
    float32."""
    cfg = dataclasses.replace(get_smoke_config("internvl2-2b"),
                              dtype="float32")
    on_cpu = Model(cfg, device="cpu", seed=0)
    on_gpu = Model(cfg, device=cuda_device, seed=0)
    on_gpu.load_state_dict(on_cpu.state_dict())
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 999, n).tolist() for n in (5, 12, 7, 9)]
    outputs = []
    for model in (on_cpu, on_gpu):
        eng = InferenceEngine(model, max_batch=2, max_len=32,
                              clock=lambda: 0.0)
        reqs = []
        for p in prompts:
            eng.submit(p, 5)
            reqs.append(eng.pending[-1])
        eng.run_until_drained()
        outputs.append([r.output for r in reqs])
    assert outputs[0] == outputs[1]


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def _ssd_inputs(device, dtype, seed, b, l, h, p, n):
    rng = np.random.default_rng(seed)
    x, bb, cc = (torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                              device=device).to(dtype)
                 for s in ((b, l, h, p), (b, l, n), (b, l, n)))
    dt = torch.nn.functional.softplus(torch.tensor(
        rng.standard_normal((b, l, h)), dtype=torch.float32, device=device))
    a_log = torch.tensor(rng.standard_normal(h) * 0.5, dtype=torch.float32,
                         device=device)
    return x, dt, a_log, bb, cc


@pytest.mark.parametrize("b,l,h,p,n,chunk", [
    (1, 128, 2, 64, 128, 128), (2, 256, 4, 64, 64, 128),
    (1, 200, 2, 32, 64, 128), (2, 512, 1, 64, 128, 256),
    (1, 5, 3, 32, 32, 5)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_matches_plain_version(cuda_device, b, l, h, p, n, chunk,
                                          dtype):
    """tests/test_kernels.py::TestSSDScanKernel's shapes and tolerances
    (and a prompt shorter than one tile); the final state at 1e-3."""
    args = _ssd_inputs(cuda_device, dtype, l, b, l, h, p, n)
    before = ssd_ops.KERNEL.launches
    y, state = ssd_ops.ssd(*args, chunk=chunk, return_state=True)
    assert ssd_ops.KERNEL.launches == before + 1
    y_ref, state_ref = ssd_scan_ref(*args, return_state=True)
    rt = 4e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=rt,
                               atol=rt * 5)
    torch.testing.assert_close(state, state_ref, rtol=1e-3, atol=1e-3)


def test_ssd_kernel_rejects_what_it_does_not_take(cuda_device):
    args = _ssd_inputs(cuda_device, torch.float32, 0, 1, 8, 2, 16, 32)
    with pytest.raises(ValueError, match="P in"):
        ssd_ops.ssd(*args)
    x, dt, a_log, bb, cc = _ssd_inputs(cuda_device, torch.float32, 0, 1, 8,
                                       2, 32, 32)
    with pytest.raises(TypeError, match="one dtype"):
        ssd_ops.ssd(x, dt, a_log, bb.bfloat16(), cc)
    with pytest.raises(ValueError, match="is on cpu"):
        ssd_ops.ssd(x, dt.cpu(), a_log, bb, cc)


def test_mamba2_model_goes_through_ssd_kernel(cuda_device):
    """One ssd_scan launch per layer of each prefill; the kernel path's
    logits agree with the plain path (`ssd_chunked`) at float32."""
    cfg = dataclasses.replace(get_smoke_config("mamba2-2.7b"),
                              dtype="float32")
    model = Model(cfg, device=cuda_device, seed=0)
    toks = torch.tensor(np.random.default_rng(2).integers(0, 1000, (2, 40)),
                        device=cuda_device)
    ssd_ops.KERNEL.launches = 0
    logits, cache = model.prefill(toks)
    plain, plain_cache = model.prefill(toks, use_kernel=False)
    assert ssd_ops.KERNEL.launches == cfg.num_layers
    torch.testing.assert_close(logits, plain, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cache["state"], plain_cache["state"],
                               rtol=1e-3, atol=1e-3)
    tok = toks[:, -1:]
    for _ in range(3):
        logits, cache = model.decode_step(cache, tok)
        plain, plain_cache = model.decode_step(plain_cache, tok)
        torch.testing.assert_close(logits, plain, rtol=1e-4, atol=1e-4)
    assert ssd_ops.KERNEL.launches == cfg.num_layers


def test_ssd_kernel_matches_chunked_at_serve_width(cuda_device):
    """Mamba2-2.7B's shape (80 heads, P 64, N 128) at a length that is no
    multiple of a tile, in bfloat16, against the model's plain scan."""
    args = _ssd_inputs(cuda_device, torch.bfloat16, 3, 1, 891, 80, 64, 128)
    y, state = ssd_ops.ssd(*args, chunk=256, return_state=True)
    y_chk, h_chk = mamba2.ssd_chunked(*args, chunk=256)
    torch.testing.assert_close(y.float(), y_chk.float(), rtol=4e-2,
                               atol=2e-1)
    torch.testing.assert_close(state, h_chk, rtol=1e-3, atol=1e-3)


def test_mamba2_engine_on_cuda_matches_cpu(cuda_device):
    """Same weights, same prompts: the engine on the card (through the SSD
    kernel: layers x prompts launches) gives the CPU engine's greedy
    tokens at float32."""
    cfg = dataclasses.replace(get_smoke_config("mamba2-2.7b"),
                              dtype="float32")
    on_cpu = Model(cfg, device="cpu", seed=0)
    on_gpu = Model(cfg, device=cuda_device, seed=0)
    on_gpu.load_state_dict(on_cpu.state_dict())
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 999, n).tolist() for n in (5, 12, 2, 9)]
    outputs = []
    for model in (on_cpu, on_gpu):
        ssd_ops.KERNEL.launches = 0
        eng = InferenceEngine(model, max_batch=2, max_len=32,
                              clock=lambda: 0.0)
        reqs = []
        for p in prompts:
            eng.submit(p, 5)
            reqs.append(eng.pending[-1])
        eng.run_until_drained()
        outputs.append([r.output for r in reqs])
    assert ssd_ops.KERNEL.launches == cfg.num_layers * len(prompts)
    assert outputs[0] == outputs[1]


def _packed(device, dtype, seed, b, l, h, p, n, offset=0):
    """x, b and c as slices of one packed (B, L, H P + 2 N) tensor, as the
    model passes them, starting `offset` elements into it."""
    rng = np.random.default_rng(seed)
    width = h * p + 2 * n
    xbc = torch.tensor(rng.standard_normal((b, l, width + offset)),
                       dtype=torch.float32, device=device).to(dtype)
    xbc = xbc[..., offset:]
    x = xbc[..., :h * p].reshape(b, l, h, p)
    bb, cc = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.nn.functional.softplus(torch.tensor(
        rng.standard_normal((b, l, h)), dtype=torch.float32, device=device))
    a_log = torch.tensor(rng.standard_normal(h) * 0.5, dtype=torch.float32,
                         device=device)
    return x, dt, a_log, bb, cc


def _ssd_hold(args, dtype, y, state=None):
    y_ref, state_ref = ssd_scan_ref(*args, return_state=True)
    rt = 4e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=rt,
                               atol=rt * 5)
    if state is not None:
        torch.testing.assert_close(state, state_ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("l", [1, 63, 64, 65, 891])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_ragged_lengths(cuda_device, l, dtype):
    """Lengths below, at and past a tile of either instance, and the
    longest prompt of the serve cell."""
    args = _ssd_inputs(cuda_device, dtype, l, 1, l, 3, 64, 128)
    y, state = ssd_ops.ssd(*args, return_state=True)
    _ssd_hold(args, dtype, y, state)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_packed_slices(cuda_device, offset, dtype):
    """Batch 2, x, b and c strided slices of one packed tensor: read in
    place (16-byte copies), or element by element when the slices start
    one element in."""
    args = _packed(cuda_device, dtype, 5, 2, 300, 4, 64, 128, offset)
    x, dt, _, bb, cc = args
    pl = ssd_ops.plan(2, 300, 4, 64, 128, dtype, sms=_sms())
    _, rows = ssd_ops._layout_args(pl, x.stride(), dt.stride(), bb.stride(),
                                   cc.stride(), (300 * 256, 256, 64, 1))
    aligned = not any(t.data_ptr() % 16 for t in (x, bb, cc))
    assert (rows and aligned) == (offset == 0)
    y, state = ssd_ops.ssd(*args, return_state=True)
    again = ssd_ops.ssd(*(t.contiguous() for t in args), return_state=True)
    _ssd_hold(args, dtype, y, state)
    torch.testing.assert_close(y, again[0], rtol=0, atol=0)
    torch.testing.assert_close(state, again[1], rtol=0, atol=0)


@pytest.mark.parametrize("p", ssd_ops.HEAD_DIMS)
@pytest.mark.parametrize("n", ssd_ops.STATE_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_every_instance(cuda_device, p, n, dtype):
    """Every (P, N) the kernel takes, with and without the final state."""
    args = _ssd_inputs(cuda_device, dtype, p + n, 2, 200, 3, p, n)
    y, state = ssd_ops.ssd(*args, return_state=True)
    y_only = ssd_ops.ssd(*args)
    _ssd_hold(args, dtype, y, state)
    torch.testing.assert_close(y_only, y, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_scratch_matches_rehearsal(cuda_device, dtype):
    """The scratch of each phase against `ssd_phases` on the same inputs:
    the chunk states and their s_Q (phase A), the states entering each
    chunk (phase B, rounded to bf16 in the bfloat16 instance)."""
    args = _ssd_inputs(cuda_device, dtype, 21, 2, 300, 3, 64, 128)
    x, dt, a_log, bb, cc = args
    pl = ssd_ops.plan(2, 300, 3, 64, 128, dtype, sms=_sms())
    raw = ssd_ops.buffer(pl, cuda_device)
    work = ssd_ops.scratch_views(pl, raw)
    y = torch.empty_like(x)
    state = torch.empty((2, 3, 64, 128), device=cuda_device)
    err = ssd_ops.launch(*args, y, state, pl, raw,
                         stream=torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    _, _, ref = ssd_phases(*(t.cpu() for t in args), tile=pl.tile,
                           bf16_products=dtype == torch.bfloat16)
    torch.testing.assert_close(work["s_last"].cpu(), ref["s_last"],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(work["states"].cpu(), ref["states"],
                               rtol=1e-4, atol=1e-4)
    s_tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(work["s_in"].cpu().float(), ref["s_in"],
                               rtol=s_tol, atol=s_tol)


def test_ssd_kernel_replays_in_a_cuda_graph(cuda_device):
    """One ssd() call captured in a CUDA graph and replayed three times on
    new inputs: its scratch, allocated in the capture, is reused right
    each time."""
    args = _ssd_inputs(cuda_device, torch.bfloat16, 4, 1, 891, 80, 64, 128)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up: build, set smem limits
        ssd_ops.ssd(*args, return_state=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ssd_ops.KERNEL.launches
    with torch.cuda.graph(graph):
        y, state = ssd_ops.ssd(*args, return_state=True)
    assert ssd_ops.KERNEL.launches == before + 1
    for seed in (5, 6, 7):
        fresh = _ssd_inputs(cuda_device, torch.bfloat16, seed, 1, 891, 80,
                            64, 128)
        for dst, src in zip(args, fresh):
            dst.copy_(src)
        graph.replay()
        y_chk, h_chk = mamba2.ssd_chunked(*args, chunk=256)
        torch.testing.assert_close(y.float(), y_chk.float(), rtol=4e-2,
                                   atol=2e-1)
        torch.testing.assert_close(state, h_chk, rtol=1e-3, atol=1e-3)


_PHASES_CHILD = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.ssd_scan import ops
g = torch.Generator(device="cuda").manual_seed(8)
def draw(*shape):
    return torch.randn(shape, generator=g, device="cuda")
x, b, c = draw(1, 1024, 80, 64).bfloat16(), draw(1, 1024, 128).bfloat16(), \\
    draw(1, 1024, 128).bfloat16()
dt = torch.nn.functional.softplus(draw(1, 1024, 80))
a_log = draw(80) * 0.5
ops.ssd(x, dt, a_log, b, c, return_state=True)          # warm-up
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    torch.ones(1, device="cuda").add_(1)
    for _ in range(3):
        ops.ssd(x, dt, a_log, b, c, return_state=True)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


def test_ssd_kernel_counts_one_launch_per_call(cuda_device):
    """Each ssd() call counts once in KERNEL.launches; the profiler sees
    its three phases on the device, once each (`Plan.device_launches`).
    The profiler runs in a child process, since a second profiling
    session in one process may record no device events, and an unrelated
    kernel opens its window, whose first kernel it may miss."""
    import json
    import os
    import subprocess
    import sys
    args = _ssd_inputs(cuda_device, torch.bfloat16, 8, 1, 1024, 80, 64, 128)
    before = ssd_ops.KERNEL.launches
    for _ in range(3):
        ssd_ops.ssd(*args, return_state=True)
    assert ssd_ops.KERNEL.launches == before + 3
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    child = subprocess.run([sys.executable, "-c", _PHASES_CHILD], env=env,
                           capture_output=True, text=True, timeout=300)
    assert child.returncode == 0, child.stderr[-2000:]
    kernels = json.loads(child.stdout.strip().splitlines()[-1])
    phases = ("chunk_state", "state_pass", "chunk_scan")
    counts = {k: sum(k in n for n in kernels) for k in phases}
    pl = ssd_ops.plan(1, 1024, 80, 64, 128, torch.bfloat16, sms=_sms())
    assert pl.device_launches == len(phases) == 3
    assert counts == {k: 3 for k in phases}, kernels


# ---------------------------------------------------------------------- #
# training: the plain math under autograd on the card
# ---------------------------------------------------------------------- #
TRAIN_FAMILIES = ["llama3-8b", "mamba2-2.7b", "granite-moe-3b-a800m",
                  "minicpm3-4b", "zamba2-7b", "internvl2-2b",
                  "seamless-m4t-large-v2"]
KERNELS = (ops.KERNEL, fa_ops.KERNEL, dec_ops.KERNEL, ssd_ops.KERNEL)


def _train_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24))}
    if cfg.frontend != "none":
        batch["embeds"] = (rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def _loss_grads(model, batch):
    model.requires_grad_(True)
    loss = model.loss(batch)
    loss.backward()
    return loss.detach().cpu(), {n: p.grad.cpu()
                                 for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_loss_and_grads_on_cuda_match_cpu(cuda_device, arch):
    """Float32, the same weights and batch: the card's loss and every
    gradient within the CPU tests' float32 bound of the CPU's, with no
    kernel launched (the training forward asks for the plain math)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    on_cpu = Model(cfg, device="cpu", seed=0)
    on_gpu = Model(cfg, device=cuda_device, seed=0)
    on_gpu.load_state_dict(on_cpu.state_dict())
    batch = _train_batch(cfg)
    before = [k.launches for k in KERNELS]
    got, got_g = _loss_grads(on_gpu, batch)
    assert [k.launches for k in KERNELS] == before
    want, want_g = _loss_grads(on_cpu, batch)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert got_g.keys() == want_g.keys()
    for name in want_g:
        torch.testing.assert_close(got_g[name], want_g[name], rtol=1e-4,
                                   atol=1e-4, msg=name)


def test_train_step_on_cuda_matches_cpu(cuda_device):
    """One `make_train_step` of the float32 smoke Llama on each device
    from the same weights: the loss, the updated params and the first
    moments within the float32 bound."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.training import optimizer as opt
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              dtype="float32")
    out = []
    state_dict = Model(cfg, device="cpu", seed=0).state_dict()
    batch = _train_batch(cfg)
    for device in ("cpu", cuda_device):
        model = Model(cfg, device=device, seed=0)
        model.load_state_dict(state_dict)
        state = opt.init_state(dict(model.named_parameters()))
        step = make_train_step(model, opt.AdamWConfig(warmup_steps=0))
        state, loss, metrics = step(state, batch)
        assert int(state.step) == 1
        out.append((loss.cpu(), {n: p.detach().cpu()
                                 for n, p in model.named_parameters()},
                    {n: m.cpu() for n, m in state.mu.items()}))
    (l_cpu, p_cpu, m_cpu), (l_gpu, p_gpu, m_gpu) = out
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-4, atol=1e-4)
    for name in p_cpu:
        torch.testing.assert_close(p_gpu[name], p_cpu[name], rtol=1e-4,
                                   atol=1e-4, msg=name)
        torch.testing.assert_close(m_gpu[name], m_cpu[name], rtol=1e-4,
                                   atol=1e-6, msg=name)


def test_train_step_launches_no_kernel(cuda_device):
    """A full train step (loss, backward, AdamW) of the Mamba2 and Llama
    smoke models launches none of the four kernels."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.training import optimizer as opt
    for arch in ("llama3-8b", "mamba2-2.7b"):
        model = Model(get_smoke_config(arch), device=cuda_device, seed=0)
        step = make_train_step(model, opt.AdamWConfig())
        before = [k.launches for k in KERNELS]
        state, loss, _ = step(opt.init_state(dict(model.named_parameters())),
                              _train_batch(model.cfg))
        assert bool(torch.isfinite(loss))
        assert [k.launches for k in KERNELS] == before


def test_train_resume_through_the_store_on_cuda(cuda_device, tmp_path):
    """Four steps of the bfloat16 smoke Llama on the card, against two,
    the trainer's checkpoint (the store's files), a new model's restore
    and two more: the same losses at the float32 bound, the restored
    step and the moments on the card."""
    from repro_torch.launch.train import (make_train_step,
                                          restore_checkpoint,
                                          save_checkpoint)
    from repro_torch.training import optimizer as opt
    cfg = get_smoke_config("llama3-8b")
    batches = [_train_batch(cfg, seed) for seed in range(4)]
    ocfg = opt.AdamWConfig(warmup_steps=2, total_steps=4)

    def run(model, state, part):
        step, losses = make_train_step(model, ocfg), []
        for batch in part:
            state, loss, _ = step(state, batch)
            losses.append(loss.item())
        return state, losses
    model = Model(cfg, device=cuda_device, seed=0)
    _, whole = run(model, opt.init_state(dict(model.named_parameters())),
                   batches)
    model = Model(cfg, device=cuda_device, seed=0)
    state, head = run(model, opt.init_state(dict(model.named_parameters())),
                      batches[:2])
    save_checkpoint(str(tmp_path), 2, model, state)
    model = Model(cfg, device=cuda_device, seed=1)
    state = restore_checkpoint(str(tmp_path), model, opt.init_state(dict(
        model.named_parameters())))
    assert int(state.step) == 2 and state.step.device.type == "cuda"
    assert all(m.device.type == "cuda" for m in state.mu.values())
    _, tail = run(model, state, batches[2:])
    np.testing.assert_allclose(head + tail, whole, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- #
# F3: the distribution layer on the card's torch (2.11), whose DTensor
# refused these steps before the repair; counted on `meta` DTensors over
# a fake process group, so they hold on whatever torch the card has. One
# step for each failure; `chip_smoke.py` runs the whole F3 set on both
# meshes
# --------------------------------------------------------------------- #
F3_STEPS = [("llama3-8b", "train_4k"), ("mamba2-2.7b", "train_4k"),
            ("minicpm3-4b", "decode_32k")]


@pytest.mark.parametrize("arch,shape", F3_STEPS)
def test_f3_step_on_a_fake_mesh(cuda_device, arch, shape):
    """The step at 2 layers (`dryrun.cut_depth`) on the (16, 16) production
    mesh: a train step's forward, backward and AdamW (torch 2.11 failed
    the label pad's layout, then Mamba2's scan's einsum backward), or
    MLA's decode step (2.11 refused flattening (B, S) with S sharded)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    with dryrun.fake_group(256):
        mesh = mesh_lib.make_production_mesh()
        cfg = dryrun.cut_depth(dryrun.resolve_config(arch, shape), 2)
        cost = dryrun.step_cost(arch, shape, mesh, cfg)
    assert cost["flops"] > 0 and cost["peak_bytes"] > 0
    assert cost["coll"]["total"] > 0


def test_f3_mla_latent_expansion_under_a_mesh(cuda_device):
    """MLA's K and V expanded from a length-sharded latent (S over
    `model`): each device expands its own rows with the up-projections
    gathered whole (`sharding.rows_times`), so K's nope part and V keep
    the latent's split of S (torch 2.11 refused DTensor's flatten of (B,
    S) with S split), as do K's rope part, the latent's own columns, and
    K written out whole from the two (`attention.whole_key`, which the
    decode makes on DTensors)."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import attention as attn
    cfg = dataclasses.replace(get_smoke_config("minicpm3-4b"),
                              num_heads=32)
    with dryrun.fake_group(256):
        mesh = mesh_lib.make_production_mesh()
        model = Model(cfg, device="meta")
        shd.distribute(model, mesh, shd.param_specs(model, mesh))
        latent = shd.distribute(
            {"x": torch.empty(32, 64, cfg.kv_lora_rank + cfg.qk_rope_dim,
                              dtype=torch.bfloat16, device="meta")},
            mesh, {"x": shd.P("data", "model", None)})["x"]
        assert latent.placements == (Shard(0), Shard(1))
        k_nope, v, k_rope = model._mla_kv_from_latent(latent,
                                                      model.layers[0].attn)
        k = attn.whole_key(k_nope, k_rope)
    assert k_nope.shape == (32, 64, 32, cfg.qk_nope_dim)
    assert k_rope.shape == (32, 64, cfg.qk_rope_dim)
    assert v.shape == (32, 64, 32, cfg.v_head_dim)
    assert k.shape == (32, 64, 32, cfg.qk_nope_dim + cfg.qk_rope_dim)
    assert k_nope.placements == k_rope.placements == v.placements \
        == k.placements == (Shard(0), Shard(1))


def test_serve_cluster_demo_launches_the_attention_kernels(cuda_device,
                                                           capsys):
    """`examples_torch/serve_cluster.py`'s serving demo on the card: the
    smoke Llama-3-8B prefills each of its 12 requests through
    flash_attention (once per layer) and decodes through decode_attention
    once per layer and step: 12 requests of 12 tokens in waves of 4
    slots, each prefill giving the first token, are 3 x 11 steps."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples_torch" \
        / "serve_cluster.py"
    spec = importlib.util.spec_from_file_location("serve_cluster_example",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    layers = get_smoke_config("llama3-8b").num_layers
    before = fa_ops.KERNEL.launches, dec_ops.KERNEL.launches
    mod.serve_demo()
    flash = fa_ops.KERNEL.launches - before[0]
    decode = dec_ops.KERNEL.launches - before[1]
    out = capsys.readouterr().out
    assert flash == layers * 12
    assert decode == layers * 3 * 11
    assert "12 requests x 12 tokens" in out and "host CPU: active" in out
