#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. Environment: Python, torch and CUDA versions, the card's name and
   power limit (nvidia-smi), and the build of every CUDA kernel of the
   port from the sources in this checkout (one nvcc per source, all
   started together; sm_90a).
2. The aging kernel against its plain PyTorch version on the card, at
   the shapes the fleet engine gives it and beyond. Its time (`ms`) is
   the device time per launch: 100 launches captured in one CUDA graph
   and replayed, timed with CUDA events; the plain version is timed the
   same way (`plain_ms`). Beside them stand the least time the card
   could take (`bound_ms`: the larger of bytes over 3.35 TB/s and
   operations over the peak rate of their type) and the rate of
   back-to-back eager calls from Python (`wrapper_ms`,
   `plain_eager_ms`), which the host's speed sets. Beside the kernel's
   time stands the floor of a launch of the same geometry: an empty
   kernel (`benchmarks_torch/launch_floor.cu`), timed the same way
   (`launch_floor_ms`).
2b. The two attention kernels against their plain versions, on the
   shapes of the reference's `TestFlashAttentionKernel` and
   `TestDecodeAttentionKernel` (float32 and bfloat16, its sliding windows
   in both) and on the shapes Llama-3-8B gives them in phase 4 (with and
   without a window) and MiniCPM3 gives them in phase 7 (MLA: q/k head
   dim 96, v head dim 64, 40 heads over 40; prefill q (1, 1,024, 40,
   96) causal, decode q (4, 40, 96) against caches (4, 1,536, 40, 96) and
   (4, 1,536, 40, 64); in bfloat16 K comes as phase 7's decode gives it:
   each head's (4, 1,536, 40, 64) nope part and the rope part all heads
   share, the [..., 256:288] view of a (4, 1,536, 288) latent), Zamba2-7B gives them in phase 8 (the shared
   block: head dim 112, 32 heads over 32; prefill q (1, 1,024, 32, 112)
   causal, decode q (4, 32, 112) against (4, 1,536, 32, 112) caches) and
   Seamless's encoder gives the prefill kernel in phase 10 ((1, 1,024,
   16, 64), bidirectional), in both dtypes, timed as in phase 2, and beside
   them one PyTorch call that computes the same function
   (`scaled_dot_product_attention`, `library_ms`, the backend it chose
   named), timed the same way and used nowhere in the port; each line
   gives the kernel's time over SDPA's. flash_attention runs its
   tensor-core kernel in bfloat16 and its CUDA-core kernel in float32.
2c. The SSD scan kernel against its plain versions: on the shapes of
   the reference's `TestSSDScanKernel` (float32 and bfloat16) against
   the sequential recurrence `ssd_scan_ref`, and on the shapes Mamba2-2.7B
   gives it in phase 5 and Zamba2-7B in phase 8 ((1, 1,024, 112 heads,
   P 64), N 64) against the model's chunked scan `ssd_chunked`,
   the final state included; timed as in phase 2, with `ssd_chunked` as
   `plain_ms` (no single PyTorch call computes the scan: `library_ms`
   is null) and the recurrence, a Python loop of L steps, timed eagerly
   at the reference's shapes only. Each line gives the kernel's plan:
   its chunk tile, the heads each CTA takes, and its launches on the
   device per call (three phases; one count in its `launches`).
3. The fleet engine end to end on CUDA through `run_experiment`: the
   headline row of `benchmarks/bench_sim.py` `fleet_scale`, 200 machines
   x 40 cores x 1 h of conversation-poisson at 545.455 rps, with the
   launch count of every kernel of that path read right after it. The
   port's float64 numpy backend runs the same trace as the reference for
   the result, held at the bounds of `TestBackendAgreement` in
   `tests/test_fleetsim.py`.
3b. The event engine (`engine="event"`, the reference's default) on the
   paper's Splitwise cluster, `ExperimentConfig()`: 22 machines (5
   prompt, 17 token) x 40 cores, 60 rps of conversation-poisson for
   120 s, policy "proposed", router "jsq", seed 0. It runs on the host
   in numpy float64 with the default numpy settler, through
   `run_experiment` and again step by step (trace, `Cluster`, `run`,
   `collect`), and the two results must be identical; it is held against
   the fleet engine's numpy backend on the same config at the bounds of
   the reference's `TestEventParity`. Then the aging settle goes to the
   card: one identical mid-run state is settled once by the numpy and
   once by the torch settler (`FleetAgingSettler(backend="torch")`, the
   aging kernel at N = 880) within `TestJaxBackend`'s bound, and the
   whole cell runs with the torch settler put in place of the numpy
   one, the aging kernel launched once per idling period, held against
   the numpy run at `TestBackendAgreement`'s bounds. Last, the cell's
   `Cluster.run` with each settler and a settle of each, timed in turns
   on the host's clock, beside the kernel's own time at N = 880 (CUDA graph, as in
   phase 2) and the launch floor.
3c. Fault injection on both engines, each cell driven through the entry
   points with the launch counts set to 0 just before it and read just
   after. fleet-200x1h-guardband (phase 3's config and trace, guardband
   faults at the reference's acceptance margin 0.012) and
   fleet-200x1h-crash (machine crashes, mttf 1,800 s, reboot 30 s) run on
   CUDA (failed cores reach the aging kernel as unstressed, two launches
   a period) and on the numpy backend, held against each other as the
   CPU tests hold them. event-22x60s-guardband is the reference's
   `TestGuardbandAcceptance` pair (seed 3, 60 s, margin 0.012, linux and
   proposed), run with the default numpy settler and again with the torch
   settler on the card (one launch a period): with both, proposed must
   fail fewer cores and keep higher availability than linux, and every
   request must be accounted for (completed + failed + rejected + pending
   == submitted).
3d. Telemetry, checkpoints and a mixed fleet. fleet-200x1h-telemetry-ckpt
   runs phase 3's config and trace on CUDA with a caller's
   `TelemetryHub` and a checkpoint every 600 simulated seconds into a
   temporary directory: its result must equal phase 3's torch result
   exactly (less `provenance`, which holds the fingerprint, and
   `telemetry_summary`); then the checkpoints after 1,800 s are dropped,
   the run resumes from 1,800 s and must give that result again.
   fleet-200x1h-mixed runs the same config and trace on a fleet halfway
   through a hardware refresh (100 machines of 40 cores, 100 of 64, the
   core axis padded to 64: 12,800 lanes, 2,400 padded) on CUDA and on
   numpy, held at `TestBackendAgreement`'s bounds; every padded lane's
   dVth must stay 0.0 on both. event-22x120s-telemetry runs phase 3b's
   cell with `with_telemetry(export_dir=...)` through `run_experiment`
   (numpy settler), whose result must equal phase 3b's and whose summary
   must equal the port's CPU run (`EVENT_TELEMETRY`), and through
   `Cluster(cfg, telemetry=hub)` with the torch settler on the card,
   whose result must equal phase 3b's torch-settled one.
4. Llama-3-8B at full width (32 layers, bfloat16, random weights from
   seed 0) served by the port's `InferenceEngine` and `CoreManager`: 8
   requests of 128 to 1,024 prompt tokens and 32 new tokens each, 4
   batch slots, policy "proposed" on 16 host cores. Prefill attention
   goes through the flash_attention kernel and decode attention through
   the decode_attention kernel; their launch counts are read right
   after. A `TelemetryHub` is attached to the engine: its counters must
   add up to the core manager's tasks and `prometheus_text()` must hold
   them. Then each request's tokens are fed again through the model on
   the kernel path and on the plain path: in bfloat16 the kernel path
   must stay within the noise floor of bfloat16 rounding at this depth,
   measured in the same run, and in float32 (the same architecture at
   full width) within 1e-3 of the plain path (`F32_RTOL`, `F32_ATOL`).
5. Mamba2-2.7B at full width (64 layers, bfloat16, random weights from
   seed 0) served the same way, with the same traffic: every prefill's
   SSD scan goes through the ssd_scan kernel (64 launches per request;
   the decode step has no kernel), and the same two holds of the kernel
   path against the plain path (`ssd_chunked`) follow.
6. Granite-MoE-3B-A800M at full width (32 layers, 40 experts top-8,
   bfloat16, seed 0) served the same way, with the same traffic: an MoE
   chat endpoint on one card. Attention goes through B2 and B3 (GQA at
   head dim 64), the experts through torch's batched products, as the
   reference leaves them to XLA. The same two holds follow; in float32
   the top-k routes of the two paths are compared (see F32_RTOL).
7. MiniCPM3-4B at full width (62 layers, MLA, bfloat16, seed 0) served
   the same way: B2 and B3 at MLA's (96, 64) instance, the latent cache
   expanded to K's nope part and V each decode step, B3 reading K's rope
   part from the latent in place (`mla_absorb=False`, the default). Then a short run on the same model and requests with
   `mla_absorb=True`, which attends against the latent in plain PyTorch:
   no B3 launch in its decode; its tokens are printed beside the default
   run's. The same two holds of the default path follow.
8. Zamba2-7B at full width (81 Mamba2 layers and one shared attention +
   MLP block after every 6 of them, 13 uses, head dim 112; bfloat16,
   seed 0) with the same traffic, driven through `Model.prefill` and
   `Model.decode_step` (the engine refuses the hybrid family, as the
   reference's does): each request prefilled alone, then 4 at a time
   decoded together with their caches stacked and a per-slot pos. Each
   prefill launches the SSD scan once per Mamba2 layer and the prefill
   attention once per use of the shared block; each decode step the
   decode attention once per use. The same two holds follow.
9. InternVL2-2B at full width (24 layers, bfloat16, seed 0) served through
   the engine with the same traffic, text only (the engine passes no
   frontend embeddings, as the reference's does); then 4 of the requests
   again through `Model.prefill` and `Model.decode_step`, each behind 256
   patch embeddings (normal, seed 1, at the embedding table's std), and
   the two holds on these, the noisy path perturbing the patches as it
   does the table.
10. SeamlessM4T-Large-v2 at full width (24 encoder and 24 decoder layers,
   bfloat16, seed 0): 8 requests of 1,024 frame embeddings (seed 2) and
   decoder prompts of 4 to 64 tokens, 32 new tokens each, driven as in
   phase 8 (the engine refuses encoder-decoder models). Each prefill
   launches the prefill attention once per encoder layer
   (bidirectional, counted apart by the wrapper as its "noncausal"
   variant) and once per decoder layer (causal); each decode step the
   decode attention once per decoder layer; cross-attention is plain
   PyTorch, as the reference's jnp. The same two holds follow, the noisy
   path perturbing the frames as it does the table (the floor of the
   table alone is printed beside it); then the encoder's memory (the
   cross-attention cache), kernel path against plain path, against a
   floor of its own: the plain path with the frames perturbed
   (`_hold_memory`).

11. Training (`[train]`), which launches no kernel: no Pallas kernel has
   a backward, so the training forward is the plain math, in the port as
   in the reference. Each family's smoke config in float32 (Llama,
   Mamba2, Granite-MoE, MiniCPM3, Zamba2, InternVL2 with zero patch
   embeddings, Seamless with seeded frames): the card's `Model.loss` and
   every gradient against the port's CPU result for the same weights and
   batch, at the CPU tests' float32 bound. The smoke Llama (bfloat16)
   trained 20 steps on the card and again with a checkpoint through the
   trainer's store at step 10, restored into a new model: the same
   losses. Then Llama-3-8B at its published widths with 16 of its 32
   layers (4.55 B parameters: bfloat16 params and grads and float32
   moments fill 54.5 GB; all 32 layers would need 96.4 GB), 20 steps of
   8 x 512 tokens of `SyntheticTokens` (seed 0) through `make_train_step`
   at the trainer's defaults: the loss must fall (mean of the last 5
   steps below the first 5); the checkpoint's trees taken at step 10 in
   the reference's layout (host memory), put back after step 20, and the
   steps run again to the same losses and grad norms; step 1's bfloat16
   loss and grad norm held against float32 on the same weights within
   noise floors measured in the same run (`TRAIN_GRAD_BIAS`); step time,
   tok/s and peak memory printed beside the card's name and power limit.

12. The distribution layer (`[distributed]`), which launches no kernel:
   the dry run's CLI (`python -m repro_torch.launch.dryrun --arch
   llama3-8b --shape decode_32k --mesh both`, 256 and 512 fake ranks, no
   device) in a child process, which must print ALL DRY-RUNS PASSED; then
   Llama-3-8B at full width (32 layers, bfloat16, seed 0) laid out over
   `make_host_mesh()` (a (1, 1) mesh over a one-rank nccl group) by
   `param_specs`, its cache by `cache_specs`: 4 seeded prompts of 1,024
   tokens prefilled into a cache of 1,536 and 8 greedy decode steps on the
   plain path, whose logits must equal the same weights' without DTensor
   bit for bit; then the dry run's per-device count of that prefill and
   of one decode step on a (1, 1) mesh: its FLOPs must equal
   `FlopCounterMode`'s on the card and its peak lie within 10% of
   `max_memory_allocated` (params and cache resident), printed beside
   the step's time, its roofline terms (launch/mesh.py's constants) and a
   measured bf16 GEMM rate and copy rate. The process group is destroyed
   before the phase returns; the phase must take at most 90 s. Beside it,
   in two more child processes, the dry run at 2 layers (`--layers 2`) of
   the set that failed on the card's torch 2.11 before F3's repair:
   train_4k of llama3-8b, granite-moe-3b-a800m, minicpm3-4b, mamba2-2.7b,
   zamba2-7b, internvl2-2b and seamless-m4t-large-v2, and minicpm3-4b's
   decode_32k, each on both meshes; it must pass, within its own budget
   (`DIST_F3_BUDGET_S`), timed apart from the phase's.
13. The examples (`[examples]`): each script of `examples_torch/` in a
   child process, as a user runs it (through `runpy`, which then prints
   the launch counts of the child's kernels). `quickstart.py`,
   `carbon_report.py` at its defaults with `--telemetry DIR` and
   `telemetry_report.py` on the proposed run's export: their report lines
   must equal the reference's (`tests/data/examples_expected.json`, host
   numpy, the same on any machine; the directory, fingerprints and wall
   times written apart). `serve_cluster.py` on the card: its serving demo
   (the smoke Llama-3-8B, 12 requests x 12 tokens) must launch the
   flash_attention kernel once per layer and request and the
   decode_attention kernel once per layer and decode step, 33 steps
   (path `example-serve-cluster`; phase 2 holds both kernels at the
   demo's shapes), its two cluster sweeps print the reference's lines.
   `train_small.py --steps 60`, and again with `--big`, on the card into
   a temporary checkpoint directory: the loss at the last log line must
   be below the first, and no kernel may launch; the small run's loss
   must fall by EXAMPLES_TRAIN_MIN_FALL, ten times the spread of its
   logged losses at fixed weights. `--big`'s 60 steps move its loss by
   less than that spread, so its hold shows only that the 100M run goes
   through on the card. Each script's
   wall, the demo's tok/s and the step times are printed beside the
   card's name and power limit; the host reports run beside the card's
   scripts, and the phase's budget is EXAMPLES_BUDGET_S.

Phases 3, 3b, 3c, 3d, each serving run, each training run and the
serving example set every
kernel's launch count to 0 just before each main run and read them all
just after: a kernel of the path must have run exactly as often as the
path calls it, and no other kernel at all.

The last two lines are one JSON object per kernel and the device line.
Without CUDA, or without `src/repro_torch` beside this file, it prints
no result and exits 1.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import platform
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): HBM3 bytes/s,
# float32 FLOP/s outside the tensor cores, bf16 FLOP/s of the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

KERNEL_NS = (1, 7, 128, 1024, 5000, 8000, 12_800, 1_280_000)
# the smoke fleet; its mixed cell (200 x 64 padded lanes); 10k x 128 cores
TIMED_NS = (8000, 12_800, 1_280_000)
RTOL, ATOL = 1e-6, 1e-9
# per element: 4 float32 loads + 1 store; 16 float ops (5 exp/pow)
AGING_BYTES, AGING_OPS = 20, 16

FLEET = dict(n_prompt=45, n_token=155, num_cores=40, rate_rps=545.455,
             duration_s=3600.0, policy="proposed")
# TestBackendAgreement bounds (reference tests/test_fleetsim.py)
BOUNDS = {"completed": 0.01, "mean_latency_s": 0.01,
          "p50_degradation": 0.02, "fleet_yearly_kgco2eq": 0.05}

# phase 3b: ExperimentConfig() itself, the reference's default cell
# (event-22x120s); TestEventParity bounds (reference tests/test_fleetsim.py)
EVENT_FLEET_BOUNDS = {"completed": 0.10, "mean_latency_s": 0.10,
                      "p99_latency_s": 0.10, "p50_degradation": 0.15,
                      "p50_freq_cv": 0.10, "fleet_yearly_kgco2eq": 0.15,
                      "fleet_energy_kwh": 0.05}
# phase 3c: fault injection. The fleet cells are FLEET under a fault
# model; the event cell is the reference's TestGuardbandAcceptance pair.
FLEET_GUARDBAND = dict(FLEET, fault_model="guardband",
                       fault_opts=(("margin", 0.012),))
FLEET_CRASH = dict(FLEET, fault_model="machine-crash")
EVENT_GUARDBAND = dict(seed=3, duration_s=60.0, fault_model="guardband",
                       fault_opts=(("margin", 0.012),))
# torch/CUDA against numpy under faults, beside BOUNDS: crashes, stalls
# and failed cores equal, availability within 1e-3 relative (the
# reference's TestFleetEngineFaults::test_backends_agree_on_counts).
AVAILABILITY_RTOL = 1e-3
# Retries are the fluid request mass re-dispatched at each of some 400
# crash onsets, summed in float32 on torch and float64 on numpy. The
# reference's counts test allows 1 at 60 s; over 3,600 periods the
# float32 queues drift from the float64 ones (fleet-200x1h's completed
# by 1.4e-4 relative on an H100), and 200 machines x 600 s on the CPU
# gave 29,748 against 29,741 (2.4e-4). So they are held at 1e-3 relative.
RETRIES_RTOL = 1e-3
# phase 3d: telemetry, checkpoints and a mixed fleet. FLEET halfway
# through a hardware refresh: 100 of the 40-core reference SKU and 100
# EPYC 64-core machines at one NBTI operating point, the core axis padded
# to 64 (10,400 real cores of 12,800 lanes).
FLEET_MIXED = dict(FLEET, fleet="xeon-40c:100+epyc-64c:rest")
CKPT_EVERY_S = 600.0
CKPT_RESUME_AT = 1800           # simulated s: later checkpoints are dropped
# event-22x120s with a hub: its summary as the CPU run of the port gives
# it (the event engine is host numpy float64, equal on every host). The
# ring of 200,000 events drops the run's first 5,876.
EVENT_TELEMETRY = {
    "events": 200_000, "events_dropped": 5_876,
    "event_kinds": {"assign": 53_509, "gate": 471, "oversub": 28_621,
                    "phase": 2, "promote": 25_106, "release": 82_129,
                    "route": 9_686, "wake": 476}}
# TestJaxBackend bound (reference tests/test_fleetstate.py) for one settle
SETTLE_TOL = dict(rtol=2e-6, atol=1e-8)
# the mid-run state settled by both settlers: run to T, settle at T + DT
SETTLE_T, SETTLE_DT = 5.0, 0.7
SETTLE_CALLS = 200

# (b, h, hkv, s, d, dv, window, dtype, causal): the reference's
# TestFlashAttentionKernel shapes in float32 and bfloat16, its windows in
# both dtypes (bfloat16 runs the tensor-core kernel, float32 the CUDA-core
# one), a window at the serve shape, Llama-3-8B's prefill (one request of S
# tokens: 32 heads over 8 KV heads, head_dim 128), MiniCPM3's (MLA: 40
# heads over 40, q/k head dim 96, v head dim 64) and Zamba2's shared block
# (32 heads over 32, head dim 112) in both dtypes, all causal; and
# Seamless's encoder (16 heads over 16, head dim 64, 1,024 frames),
# bidirectional; and the serving example's prefill (the smoke Llama-3-8B:
# one request of 24 tokens, 8 heads over 2, head dim 32)
FLASH_CASES = ([(b, h, hkv, s, d, d, 0, dt, True)
                for dt in ("float32", "bfloat16")
                for b, h, hkv, s, d in ((1, 4, 4, 128, 64), (2, 8, 2, 256, 64),
                                        (1, 4, 1, 128, 128),
                                        (2, 2, 2, 192, 64))]
               + [(1, 2, 2, 256, 64, 64, w, dt, True)
                  for dt in ("float32", "bfloat16") for w in (32, 128)]
               + [(1, 32, 8, 1000, 128, 128, 256, "bfloat16", True)]
               + [(1, 32, 8, s, 128, 128, 0, "bfloat16", True)
                  for s in (128, 1000, 1024)]
               + [(1, 40, 40, 1024, 96, 64, 0, dt, True)
                  for dt in ("float32", "bfloat16")]
               + [(1, 32, 32, 1024, 112, 112, 0, dt, True)
                  for dt in ("float32", "bfloat16")]
               + [(1, 16, 16, 1024, 64, 64, 0, dt, False)
                  for dt in ("float32", "bfloat16")]
               + [(1, 8, 2, 24, 32, 32, 0, "bfloat16", True)])
FLASH_MAIN = (1, 32, 8, 1024, 128, 128, 0, "bfloat16", True)
FLASH_MLA = (1, 40, 40, 1024, 96, 64, 0, "bfloat16", True)
FLASH_ZAMBA = (1, 32, 32, 1024, 112, 112, 0, "bfloat16", True)
FLASH_ENCODER = (1, 16, 16, 1024, 64, 64, 0, "bfloat16", False)
# (b, h, hkv, s, d, dv, window, dtype): the reference's
# TestDecodeAttentionKernel shapes and its window in both dtypes, a window
# at the serve shape, Llama-3-8B's decode (4 slots against the
# 1,536-position cache, pos drawn in [1, 1536]), MiniCPM3's (40 heads
# over 40, 96 / 64; in bfloat16 K's rope part apart, as its decode gives
# it) and Zamba2's shared block (32 heads over 32, 112) in
# both dtypes; and the serving example's decode (4 slots against its
# 96-position cache, 8 heads over 2, head dim 32)
DECODE_CASES = ([(b, h, hkv, s, d, d, 0, dt)
                 for dt in ("float32", "bfloat16")
                 for b, h, hkv, s, d in ((1, 4, 4, 512, 64),
                                         (4, 8, 2, 1024, 64),
                                         (2, 8, 1, 512, 128),
                                         (2, 4, 4, 640, 64))]
                + [(2, 4, 4, 512, 64, 64, 128, dt)
                   for dt in ("float32", "bfloat16")]
                + [(4, 32, 8, 1536, 128, 128, 300, "bfloat16"),
                   (4, 32, 8, 1536, 128, 128, 0, "bfloat16")]
                + [(4, 40, 40, 1536, 96, 64, 0, dt)
                   for dt in ("float32", "bfloat16")]
                + [(4, 32, 32, 1536, 112, 112, 0, dt)
                   for dt in ("float32", "bfloat16")]
                + [(4, 8, 2, 96, 32, 32, 0, "bfloat16")])
DECODE_MAIN = (4, 32, 8, 1536, 128, 128, 0, "bfloat16")
DECODE_MLA = (4, 40, 40, 1536, 96, 64, 0, "bfloat16")
# MiniCPM3's latent row: kv_lora_rank columns, then K's rope part
MLA_LATENT, MLA_ROPE = 256, 32
DECODE_ZAMBA = (4, 32, 32, 1536, 112, 112, 0, "bfloat16")


# (b, l, h, p, n, chunk, dtype): the reference's TestSSDScanKernel shapes
# in float32 and bfloat16, Mamba2-2.7B's prefill (one request of L
# tokens: 80 heads, P 64, N 128, bfloat16) at L = 1,024 and at 891, the
# longest prompt of phase 5 and no multiple of the kernel's tile, and
# Zamba2-7B's (112 heads, P 64, N 64) at L = 1,024
SSD_CASES = ([(b, l, h, p, n, chunk, dt)
              for dt in ("float32", "bfloat16")
              for b, l, h, p, n, chunk in ((1, 128, 2, 64, 128, 128),
                                           (2, 256, 4, 64, 64, 128),
                                           (1, 200, 2, 32, 64, 128),
                                           (2, 512, 1, 64, 128, 256))]
             + [(1, l, 80, 64, 128, 256, "bfloat16") for l in (1024, 891)]
             + [(1, 1024, 112, 64, 64, 256, "bfloat16")])
SSD_MAIN = (1, 1024, 80, 64, 128, 256, "bfloat16")
SSD_ZAMBA = (1, 1024, 112, 64, 64, 256, "bfloat16")
# the models' shapes, held against the model's chunked scan; the others
# against the sequential recurrence
SSD_SERVE = {c for c in SSD_CASES if c[2] in (SSD_MAIN[2], SSD_ZAMBA[2])}
# the final state, as tests/test_models.py::TestSSD holds h
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
# the tile at which the SSD scan's operations are counted for its bound:
# the smallest the kernel takes (its float32 instance's), fixed so that
# the bound does not follow the tile the kernel picks
SSD_TILE = 64


def ssd_tol(dtype: str) -> dict:
    """`tests/test_kernels.py::TestSSDScanKernel`'s tolerance for y."""
    return dict(rtol=4e-2, atol=2e-1) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=5e-4)


def attention_tol(dtype: str) -> dict:
    """`tests/test_kernels.py::tol` of the reference."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


# phases 4 to 7: the serving cells, one traffic for every model
SERVE = dict(arch="llama3-8b", seed=0, max_batch=4, max_len=1536,
             policy="proposed", host_cores=16, requests=8,
             prompt_lens=(128, 1024), new_tokens=32)
SERVE_MAMBA = dict(SERVE, arch="mamba2-2.7b")
SERVE_MOE = dict(SERVE, arch="granite-moe-3b-a800m")
SERVE_MLA = dict(SERVE, arch="minicpm3-4b")
# phase 7's run with mla_absorb=True: the same requests, fewer new tokens
ABSORB_NEW_TOKENS = 8
# phases 8 to 10: the hybrid, vision-frontend and encoder-decoder families
# with the same traffic; Seamless's decoder prompts are short (a
# translation's target prefix), its source the frame embeddings
SERVE_HYBRID = dict(SERVE, arch="zamba2-7b")
SERVE_VLM = dict(SERVE, arch="internvl2-2b")
SERVE_ENCDEC = dict(SERVE, arch="seamless-m4t-large-v2", prompt_lens=(4, 64))
# requests decoded together through Model.decode_step (per-slot pos), as
# the engine's 4 slots would
DIRECT_BATCH = 4
# phase 9's second run: PATCH_REQUESTS requests behind 256 patch
# embeddings (seed PATCH_SEED); phase 10's frame embeddings (seed
# FRAME_SEED), one set of 1,024 per request; both normal, scaled to the
# embedding table's std
PATCH_REQUESTS, PATCH_SEED, FRAME_SEED = 4, 1, 2
# Phase 4 holds the kernel path against the plain path (the kernels'
# plain versions, `use_kernel=False`) on the engine's tokens, two ways:
# - float32, the same architecture at full width (weights from seed 1) on
#   F32_REQUESTS of the requests: per logit |kernel - plain| <= atol +
#   rtol * |plain|. The kernels hold their float32 plain versions to 2e-5
#   per call (tests/test_kernels.py tol); 64 calls in a 32-layer pass
#   give 1e-3 on logits of magnitude up to about 7.
# - bfloat16, every request: the relative L2 distance of the kernel
#   path's logits from the plain path's, per step, may not exceed what
#   bfloat16 rounding alone makes of the plain path at this depth,
#   measured in the same run: the plain path again on the same model with
#   its embedding table perturbed by relative Gaussian noise of 2^-9
#   (seed 1), below one bfloat16 rounding. Both are maxima over all steps.
# Top-k routing (phase 6) is discontinuous: a float32 difference of about
# 1e-6 in h can swap a token's 8th and 9th expert, and a prefill pass
# takes some 110,000 routes. In bfloat16, where rounding decides such
# near-ties either way, the MoE kernel path and the noisy plain path
# replay the plain path's routes (`_Routes`), so that the noise-floor hold
# weighs numerics alone; the top-k the kernel path would take on those
# routes is counted against them and printed, not held. The MoE float32
# hold compares the routes of the two paths, (token, layer) by (token,
# layer), as expert sets:
# - a step (the prefill, or one decode step) is held at F32_RTOL/F32_ATOL
#   when every route it takes agrees; a step with a differing route is
#   counted and printed, not held;
# - the phase fails if more than ROUTE_FLIP_MAX of all routes differ, or
#   if no step is held.
# The dense, Mamba2 and MLA holds are the rules above, unchanged. A
# frontend's embeddings (patches, frames) are perturbed with the table;
# an encoder-decoder's memory is also held apart (`_hold_memory`), since
# its frames' noise, through 24 bidirectional layers, loosens the
# logits' floor.
F32_RTOL, F32_ATOL = 1e-3, 1e-3
ROUTE_FLIP_MAX = 1e-3
F32_REQUESTS = 2
NOISE_REL = 2.0 ** -9
# Phase 11 [train]. First each family's smoke config in float32, the
# card's `Model.loss` and every gradient held against the port's own CPU
# result for the same weights and batch at tests/test_torch_models.py's
# float32 bounds (the CPU path is held against JAX by the CPU tests).
# Then Llama-3-8B at its published widths with TRAIN_LAYERS of its 32
# layers (bfloat16 params and grads, float32 moments: 12 bytes a
# parameter, 54.5 GB for 4.54 B; all 32 would need 96.4 GB), trained
# TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens through
# `make_train_step` on `SyntheticTokens` (seed 0), at the trainer's
# defaults (lr 1e-3, warmup min(20, steps)).
TRAIN_FAMILIES = ("llama3-8b", "mamba2-2.7b", "granite-moe-3b-a800m",
                  "minicpm3-4b", "zamba2-7b", "internvl2-2b",
                  "seamless-m4t-large-v2")
TRAIN_F32 = dict(rtol=1e-4, atol=1e-4)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 8, 512, 20
# the checkpoint's trees taken after this step, restored, and run again
# to the end: the resumed losses and grad norms equal the uninterrupted
# ones at TRAIN_F32 (not bit for bit: the embedding's backward
# accumulates with atomics on CUDA). At full width the trees (45 GB in
# the reference's layout) stay in host memory: the store writes some 0.5
# GB/s and reads 0.3 GB/s on the card's host (benchmarks_torch/
# store_rate.py), four minutes for them. The store's files take the same
# trees, which `train_store_resume` writes and reads on the card with
# the smoke Llama.
TRAIN_SAVE_AT = 10
# the bfloat16 hold of step 1: its loss and grad norm against the same
# weights in float32 on the card, relative. The loss must lie within its
# noise floor: the largest relative move of the bfloat16 loss when every
# weight is perturbed by relative Gaussian noise of NOISE_REL (one draw
# per seed; the loss averages over 4,096 tokens, which washes out noise
# put into the embedding table alone, so unlike the serving holds every
# weight takes it). The grad norm must lie within its own such floor plus
# TRAIN_GRAD_BIAS: bfloat16 shrinks the whole backward signal alike (2.4e-3
# of the grad norm at 8 layers of d_model 1,024, every parameter group
# within 2.1e-3 to 2.6e-3 but final_ln: benchmarks_torch/
# bf16_grad_bias.py), as the reference's bfloat16 does
# (tests/test_torch_training.py pins the port's bfloat16 grad norm to the
# reference's), a bias that weight noise does not make (PERF.md §6);
# it may reach one unit roundoff of bfloat16.
TRAIN_NOISE_SEEDS = (1, 2, 3)
TRAIN_GRAD_BIAS = 2.0 ** -8
# Phase 12 [distributed]: the dry run's CLI in a child process (its
# budget DIST_CLI_S), then Llama-3-8B at full width laid out over a
# one-rank (1, 1) mesh: DIST_BATCH seeded prompts of DIST_PROMPT tokens
# prefilled into a cache of DIST_MAX_LEN (the serve cells' max_len) and
# DIST_STEPS decode steps on the plain path (`use_kernel=False`), whose
# logits must equal the plain model's bit for bit; then the dry run's
# count of that prefill and one decode step on a (1, 1) mesh: its FLOPs
# equal to `FlopCounterMode`'s on the card, its peak within DIST_PEAK_RTOL
# of `max_memory_allocated`. The phase's budget is DIST_BUDGET_S.
DIST_BATCH, DIST_PROMPT, DIST_MAX_LEN, DIST_STEPS = 4, 1024, 1536, 8
DIST_SEED = 5
DIST_PEAK_RTOL = 0.10
DIST_CLI_S = 300
DIST_BUDGET_S = 90.0
# ... and beside it the dry run of the set that failed on torch 2.11
# (ROADMAP F3) at DIST_F3_LAYERS layers, both meshes, in two child
# processes (its own budget DIST_F3_BUDGET_S; it takes about 60 s)
DIST_F3_TRAIN = ("llama3-8b", "granite-moe-3b-a800m", "minicpm3-4b",
                 "mamba2-2.7b", "zamba2-7b", "internvl2-2b",
                 "seamless-m4t-large-v2")
DIST_F3_DECODE = ("minicpm3-4b",)
DIST_F3_LAYERS = 2
DIST_F3_BUDGET_S = 240.0
# the measured rates printed beside launch/mesh.py's constants
GEMM_N, COPY_BYTES = 8192, 2 ** 30
# Phase 13 [examples]: the expected report lines (made from the
# reference's examples by tests/test_torch_examples_data.py), the serving
# demo's decode steps (12 requests of 12 tokens in waves of 4 slots, each
# prefill giving the first token), the training example's steps and the
# fall of its loss over them (at lr 0 the 6 logged losses of the small
# run span 6.9492 to 6.9812 on the CPU, a spread of 0.032; trained, they
# fall by 0.92 on the card), and the phase's budget (the host reports
# beside the card's scripts: about 90 s)
EXAMPLES_EXPECTED = Path("tests") / "data" / "examples_expected.json"
EXAMPLES_DEMO_DECODE_STEPS = 3 * 11
EXAMPLES_TRAIN_STEPS = 60
EXAMPLES_TRAIN_MIN_FALL = 0.3
EXAMPLES_BUDGET_S = 300.0


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def zero_launches(kernels) -> None:
    """Set the launch counts of `kernels` to 0, their variants' too."""
    for k in kernels:
        k.launches = 0
        k.variant_launches.clear()


def read_launches(kernels) -> dict:
    """The launch counts of `kernels` by name and, under "name/variant",
    each variant's count that is not 0 (flash_attention's "noncausal")."""
    out = {k.name: k.launches for k in kernels}
    for k in kernels:
        out.update({f"{k.name}/{v}": n for v, n in k.variant_launches.items()
                    if n})
    return out


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _median_ms(run, calls: int, trials: int) -> float:
    """Median over `trials` of the CUDA-event time of `run()` divided by
    the `calls` it makes."""
    import torch
    per = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / calls)
    per.sort()
    return per[len(per) // 2]


def eager_ms(fn, calls: int = 100, trials: int = 11) -> float:
    """Time per call of `calls` back-to-back eager calls of `fn` from
    Python: host-bound wherever the device work is short."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()
    return _median_ms(run, calls, trials)


def graph_ms(fn, calls: int = 100, trials: int = 11) -> float:
    """Device time per call of `fn`: `calls` calls captured in one CUDA
    graph and replayed, so no Python or launch cost of the host counts."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _median_ms(graph.replay, calls, trials)
    del graph
    torch.cuda.empty_cache()
    return ms


def phase_environment(torch, kernels) -> None:
    log(f"[env] python {platform.python_version()} torch {torch.__version__}"
        f" cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[env] card: {smi}")
    # float32 products in full float32, as the plain versions assume
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels._build import build_all, nvcc_path
    t0 = time.perf_counter()
    build_all(kernels)
    log(f"[build] {', '.join(k.name for k in kernels)} with {nvcc_path()} "
        f"in {time.perf_counter() - t0:.2f} s (in parallel)")
    for kernel in kernels:
        for line in kernel.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {kernel.name}: {line.strip()}")


def empty_launcher(torch, floor):
    """A function of n that launches the empty kernel `floor` with the
    geometry aging_update.cu gives n elements: blocks of 256, at most 16
    a SM."""
    empty = floor.function()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def empty_launch(n):
        err = empty(min(-(-n // 256), 16 * sms), 256,
                    torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty launch failed: CUDA error {err}")
    return empty_launch


def phase_aging_kernel(torch, np, params, floor):
    """advance_fleet (kernel) vs aging_update_ref (plain) on the card;
    `floor`: the `CudaKernel` of an empty launch, timed beside it."""
    from repro_torch.kernels.aging_update.ops import advance_fleet
    from repro_torch.kernels.aging_update.ref import aging_update_ref
    dev = torch.device("cuda")
    empty_launch = empty_launcher(torch, floor)
    row = {}
    for n in KERNEL_NS:
        rng = np.random.default_rng(n)
        args = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (
            rng.uniform(0, 0.05, n),
            rng.choice([48.0, 51.08, 54.0], n),
            rng.choice([0.0, 1.0], n),
            rng.uniform(0, 1e5, n))]
        out = advance_fleet(*args, params)
        ref = aging_update_ref(*args, params)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, rtol=RTOL, atol=ATOL))
        log(f"[aging_update] N={n}: max_abs_err {err:.3e} "
            f"(rtol {RTOL}, atol {ATOL}) {'ok' if ok else 'MISMATCH'}")
        if not ok or not torch.isfinite(out).all():
            raise AssertionError(f"aging_update disagrees at N={n}")
        if n in TIMED_NS:
            def kernel():
                return advance_fleet(*args, params)

            def plain():
                return aging_update_ref(*args, params)
            times = {"ms": graph_ms(kernel), "plain_ms": graph_ms(plain),
                     "wrapper_ms": eager_ms(kernel),
                     "plain_eager_ms": eager_ms(plain),
                     "launch_floor_ms": graph_ms(lambda: empty_launch(n))}
            bytes_ms = AGING_BYTES * n / HBM_BYTES_PER_S * 1e3
            ops_ms = AGING_OPS * n / F32_FLOP_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            log(f"[aging_update] N={n}: per launch on the device (CUDA "
                f"graph) kernel {times['ms'] * 1e3:.3f} us, plain "
                f"{times['plain_ms'] * 1e3:.3f} us; eager from Python "
                f"wrapper {times['wrapper_ms'] * 1e3:.2f} us, plain "
                f"{times['plain_eager_ms'] * 1e3:.2f} us; bound "
                f"{bound_ms * 1e3:.3f} us ({bound_by}); an empty kernel "
                f"of the same geometry {times['launch_floor_ms'] * 1e3:.3f}"
                f" us")
            if n == 8000:       # the shape the smoke fleet gives it
                row = dict(times, max_abs_err=err, bound_ms=bound_ms,
                           bound_by=bound_by)
    return row


def _peak(dtype: str) -> float:
    return BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S


def sdpa_backend(torch, q, k, v, mask, causal) -> str:
    """The name of the backend that `scaled_dot_product_attention` picks
    for these (B, H, S, D) inputs (the flash backend refuses a v head dim
    other than q's)."""
    try:
        from torch.nn.attention import SDPBackend
        choice = torch._fused_sdp_choice(q, k, v, mask, 0.0, causal,
                                         scale=None, enable_gqa=True)
        return SDPBackend(choice).name.lower()
    except (AttributeError, TypeError, ValueError, RuntimeError):
        return "not determined"


def _flash_case(torch, np, case):
    """(kernel, plain, library, SDPA's backend, bytes, operations) of one
    flash_attention case: three calls on the same inputs, each giving
    (B, S, H, Dv), and the work one call must do: q, k and v read once
    and the output written once; products of 2 * D and 2 * Dv operations
    for every (query, visible key) pair."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import attention_bhsd
    b, h, hkv, s, d, dv, window, dtype, causal = case
    rng = np.random.default_rng(s)
    q, k, v = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda").to(getattr(torch, dtype))
               for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, dv)))
    qb, kb, vb = (t.transpose(1, 2) for t in (q, k, v))
    pos = torch.arange(s, device="cuda")
    band = (pos[None, :] <= pos[:, None]) & (
        pos[None, :] > pos[:, None] - window) if window else None

    def library():
        return F.scaled_dot_product_attention(
            qb, kb, vb, attn_mask=band, is_causal=causal and band is None,
            enable_gqa=True).transpose(1, 2)

    size = 2 if dtype == "bfloat16" else 4
    visible = sum(min(i + 1, window) if window else i + 1 for i in range(s)) \
        if causal else s * s
    return (lambda: attention_bhsd(q, k, v, causal=causal, window=window),
            lambda: attention_bhsd(q, k, v, causal=causal, window=window,
                                   use_kernel=False),
            library,
            sdpa_backend(torch, qb, kb, vb, band, causal and band is None),
            (b * s * h * (d + dv) + b * s * hkv * (d + dv)) * size,
            2 * (d + dv) * b * h * visible)


def _decode_case(torch, np, case):
    """(kernel, plain, library, SDPA's backend, bytes, operations) of one
    decode_attention case, pos drawn in [1, S]: three calls on the same
    inputs, each giving (B, H, Dv), and the work one call must do: the
    visible K and V rows, q, pos and the output, each once; 2 * (D + Dv)
    operations per (head, visible position). DECODE_MLA is given as
    MiniCPM3's decode gives it: each head's K nope part (B, S, Hkv, 64)
    and the rope part all heads share, the [..., 256:288] view of a (B,
    S, 288) latent, its visible rows read once; SDPA gets K whole."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import decode_bhd
    from repro_torch.models.attention import whole_key
    b, h, hkv, s, d, dv, window, dtype = case
    rope = MLA_ROPE if case == DECODE_MLA else 0
    rng = np.random.default_rng(s)
    shapes = [(b, h, d), (b, s, hkv, d - rope), (b, s, hkv, dv)]
    q, kc, vc, *latent = (
        torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                     device="cuda").to(getattr(torch, dtype))
        for shape in shapes + ([(b, s, MLA_LATENT + rope)] if rope else []))
    k_rope = latent[0][..., MLA_LATENT:] if rope else None
    kw = dict(window=window, k_rope=k_rope)
    lens = rng.integers(1, s + 1, b)
    pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
    idx = torch.arange(s, device="cuda")[None, :]
    valid = idx < pos[:, None]
    if window:
        valid &= idx >= pos[:, None] - window
    mask = valid[:, None, None, :]
    k_whole = whole_key(kc, k_rope) if rope else kc
    qb, kb, vb = q[:, :, None], k_whole.transpose(1, 2), vc.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(
            qb, kb, vb, attn_mask=mask, enable_gqa=True)[:, :, 0]

    size = 2 if dtype == "bfloat16" else 4
    seen = int(sum(min(int(n), window) if window else int(n)
                   for n in lens))
    return (lambda: decode_bhd(q, kc, vc, pos, **kw),
            lambda: decode_bhd(q, kc, vc, pos, use_kernel=False, **kw),
            library, sdpa_backend(torch, qb, kb, vb, mask, False),
            (seen * (hkv * (d - rope + dv) + rope) + b * h * (d + dv))
            * size + 4 * b,
            2 * (d + dv) * h * seen)


def phase_attention_kernels(torch, np):
    """flash_attention and decode_attention (kernels) vs their plain
    versions on the card; SDPA timed beside them. Returns the kernels
    line rows of the main-path shapes: Llama-3-8B's under each kernel's
    name, MiniCPM3's (MLA) under "<name>/mla", Zamba2's under
    "<name>/zamba2", Seamless's encoder's under "flash_attention/encoder"."""
    rows = {}
    for name, cases, mains, make in (
            ("flash_attention", FLASH_CASES,
             {FLASH_MAIN: "", FLASH_MLA: "/mla", FLASH_ZAMBA: "/zamba2",
              FLASH_ENCODER: "/encoder"}, _flash_case),
            ("decode_attention", DECODE_CASES,
             {DECODE_MAIN: "", DECODE_MLA: "/mla", DECODE_ZAMBA: "/zamba2"},
             _decode_case)):
        for case in cases:
            b, h, hkv, s, d, dv, window, dtype = case[:8]
            causal = "" if len(case) == 8 else \
                (" causal" if case[8] else " bidirectional")
            if case == DECODE_MLA:
                causal = " K's rope part apart"
            kernel, plain, library, backend, nbytes, ops = make(torch, np,
                                                                case)
            out, ref, lib = kernel(), plain(), library()
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            ok = bool(torch.allclose(out.float(), ref.float(),
                                     **attention_tol(dtype)))
            if not ok or not torch.isfinite(out).all():
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at {case}: max_abs_err "
                                     f"{err:.3e}")
            lib_err = float((lib.float() - ref.float()).abs().max())
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / _peak(dtype) * 1e3
            row = {"ms": graph_ms(kernel), "plain_ms": graph_ms(plain),
                   "wrapper_ms": eager_ms(kernel),
                   "plain_eager_ms": eager_ms(plain),
                   "library_ms": graph_ms(library), "max_abs_err": err,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations", "library_backend": backend}
            log(f"[{name}] b={b} h={h} hkv={hkv} s={s} d={d} dv={dv} "
                f"window={window}{causal} {dtype}: max_abs_err {err:.3e} "
                f"({attention_tol(dtype)}) ok; per call on the device "
                f"(CUDA graph) kernel {row['ms'] * 1e3:.3f} us, plain "
                f"{row['plain_ms'] * 1e3:.3f} us, SDPA "
                f"{row['library_ms'] * 1e3:.3f} us (kernel / SDPA "
                f"{row['ms'] / row['library_ms']:.3f}; SDPA's backend "
                f"{backend}, its max_abs_err vs plain {lib_err:.3e}); eager "
                f"wrapper {row['wrapper_ms'] * 1e3:.2f} us; bound "
                f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")
            if case in mains:
                rows[name + mains[case]] = row
    return rows


def _ssd_inputs(torch, np, case):
    """x, dt, a_log, b, c of one ssd_scan case on the card, drawn as the
    reference's test draws them (dt = softplus(normal), a_log = 0.5
    normal)."""
    b, l, h, p, n, _, dtype = case
    rng = np.random.default_rng(l)
    x, bb, cc = (torch.tensor(rng.standard_normal(shape),
                              dtype=torch.float32,
                              device="cuda").to(getattr(torch, dtype))
                 for shape in ((b, l, h, p), (b, l, n), (b, l, n)))
    dt = torch.nn.functional.softplus(torch.tensor(
        rng.standard_normal((b, l, h)), dtype=torch.float32, device="cuda"))
    a_log = torch.tensor(rng.standard_normal(h) * 0.5, dtype=torch.float32,
                         device="cuda")
    return x, dt, a_log, bb, cc


def _ssd_work(case):
    """(bytes, operations) of one ssd_scan call: x read and y written, dt,
    a_log, b and c read and the float32 final state written, each once
    (the kernel's scratch of chunk states is not counted); the chunked
    algebra at the fixed tile Q = `SSD_TILE` over the L steps, with C B^T
    formed once for all heads: 2 L (Q N + H (Q P + 2 P N))."""
    b, l, h, p, n, _, dtype = case
    size = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * l * h * p * size + b * l * h * 4 + h * 4
              + 2 * b * l * n * size + b * h * p * n * 4)
    q = SSD_TILE
    return nbytes, 2 * b * l * (q * n + h * (q * p + 2 * p * n))


def phase_ssd_kernel(torch, np):
    """ssd_scan (kernel) vs its plain versions on the card. Returns the
    kernels line rows of the main-path shapes: Mamba2-2.7B's under
    "ssd_scan", Zamba2-7B's under "ssd_scan/zamba2"."""
    from repro_torch.kernels.ssd_scan.ops import plan, ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models.mamba2 import ssd_chunked
    rows = {}
    for case in SSD_CASES:
        b, l, h, p, n, chunk, dtype = case
        args = _ssd_inputs(torch, np, case)
        serve = case in SSD_SERVE

        def kernel():
            return ssd(*args, chunk=chunk, return_state=True)

        def chunked():
            return ssd_chunked(*args, chunk=chunk)

        def sequential():
            return ssd_scan_ref(*args, return_state=True)
        y, state = kernel()
        y_ref, state_ref = chunked() if serve else sequential()
        torch.cuda.synchronize()
        err = float((y.float() - y_ref.float()).abs().max())
        state_err = float((state - state_ref).abs().max())
        ok = (bool(torch.allclose(y.float(), y_ref.float(), **ssd_tol(dtype)))
              and bool(torch.allclose(state, state_ref, **STATE_TOL))
              and bool(torch.isfinite(y).all()))
        against = "ssd_chunked" if serve else "ssd_scan_ref"
        if not ok:
            raise AssertionError(f"ssd_scan disagrees with {against} at "
                                 f"{case}: max_abs_err {err:.3e}, state "
                                 f"{state_err:.3e}")
        pl = plan(b, l, h, p, n, getattr(torch, dtype),
                  torch.cuda.get_device_properties(0).multi_processor_count)
        nbytes, ops = _ssd_work(case)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / _peak(dtype) * 1e3
        row = {"ms": graph_ms(kernel), "plain_ms": graph_ms(chunked),
               "wrapper_ms": eager_ms(kernel),
               "plain_eager_ms": eager_ms(chunked), "library_ms": None,
               "max_abs_err": err, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        seq = "" if serve else (
            f", the recurrence eagerly "
            f"{eager_ms(sequential, calls=2, trials=3) * 1e3:.1f} us")
        log(f"[ssd_scan] b={b} l={l} h={h} p={p} n={n} chunk={chunk} "
            f"{dtype}: vs {against} max_abs_err {err:.3e} "
            f"({ssd_tol(dtype)}), state {state_err:.3e} ({STATE_TOL}) ok; "
            f"per call on the device (CUDA graph) kernel "
            f"{row['ms'] * 1e3:.3f} us, ssd_chunked "
            f"{row['plain_ms'] * 1e3:.3f} us; eager wrapper "
            f"{row['wrapper_ms'] * 1e3:.2f} us, ssd_chunked "
            f"{row['plain_eager_ms'] * 1e3:.2f} us{seq}; bound "
            f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}); plan: "
            f"tile {pl.tile}, {pl.group} heads a CTA, grid {pl.grid}, "
            f"{pl.device_launches} device launches per call")
        if case in (SSD_MAIN, SSD_ZAMBA):
            rows["ssd_scan" + ("" if case == SSD_MAIN else "/zamba2")] = row
    return rows


def deltas(res, ref, bounds) -> dict:
    """Relative deltas of `res` from `ref` in each metric of `bounds`."""
    values = {
        "completed": lambda r: r.completed,
        "mean_latency_s": lambda r: r.mean_latency_s,
        "p99_latency_s": lambda r: r.p99_latency_s,
        "p50_degradation": lambda r: r.mean_degradation_percentiles[50],
        "p50_freq_cv": lambda r: r.freq_cv_percentiles[50],
        "fleet_yearly_kgco2eq": lambda r: r.fleet_yearly_kgco2eq,
        "fleet_energy_kwh": lambda r: r.fleet_energy_kwh,
    }
    return {k: rel(values[k](res), values[k](ref)) for k in bounds}


def hold(tag, got, bounds) -> None:
    """Log the relative deltas `got` beside `bounds`; raise if one is
    not inside its bound."""
    log(f"{tag} relative deltas: "
        + ", ".join(f"{k} {v:.3e} (bound {bounds[k]})"
                    for k, v in got.items()))
    bad = {k: v for k, v in got.items() if not v < bounds[k]}
    if bad:
        raise AssertionError(f"{tag}: outside the bounds: {bad}")


def phase_fleet(torch, kernels):
    """`kernels`: the `CudaKernel` of every kernel the fleet path runs."""
    from repro_torch.sim import ExperimentConfig, run_experiment
    from repro_torch.sim.fleetsim import run_fleet_experiment
    from repro_torch.workloads import get_scenario

    cfg = ExperimentConfig(**FLEET).with_engine("fleet", backend="torch")
    machine_s = cfg.n_machines * cfg.duration_s
    zero_launches(kernels)
    t0 = time.perf_counter()
    res = run_experiment(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    log(f"[fleet] torch/cuda via run_experiment (trace generation "
        f"included): {wall:.2f} s wall, {machine_s / wall:.1f} "
        f"machine-s/wall-s, launches {launches}")
    periods = int(round(cfg.duration_s / cfg.idling_period_s))
    if launches.get("aging_update") != 2 * periods:
        raise AssertionError(f"aging_update launched "
                             f"{launches.get('aging_update')} times, "
                             f"expected {2 * periods}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    t0 = time.perf_counter()
    reqs = get_scenario(cfg.scenario).generate(
        rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed)
    gen = time.perf_counter() - t0
    log(f"[fleet] trace: {len(reqs)} requests generated in {gen:.2f} s")
    t0 = time.perf_counter()
    again = run_fleet_experiment(cfg, requests=reqs)
    torch.cuda.synchronize()
    wall_t = time.perf_counter() - t0
    if again.scalars() != res.scalars():
        raise AssertionError("torch/cuda fleet run is not deterministic")
    t0 = time.perf_counter()
    ref = run_fleet_experiment(cfg.with_engine("fleet", backend="numpy"),
                               requests=reqs)
    wall_n = time.perf_counter() - t0
    for name, r, w in (("torch/cuda", res, wall_t), ("numpy", ref, wall_n)):
        log(f"[fleet] {name}: engine {w:.2f} s wall, "
            f"{machine_s / w:.1f} machine-s/wall-s, completed "
            f"{r.completed}, p99_latency_s {r.p99_latency_s!r}, "
            f"fleet_yearly_kgco2eq {r.fleet_yearly_kgco2eq!r}")
    n = cfg.n_machines
    finite = all(math.isfinite(v) for v in (
        res.mean_latency_s, res.p99_latency_s, res.fleet_yearly_kgco2eq))
    if not finite or len(res.per_machine_degradation) != n \
            or len(res.per_machine_residency) != n or res.completed <= 0:
        raise AssertionError("fleet result is not finite or has the "
                             "wrong shape")
    hold("[fleet] torch/cuda vs numpy", deltas(res, ref, BOUNDS), BOUNDS)
    return launches, reqs, res, wall_t


def phase_event(torch, np, kernels, floor):
    """`kernels`: the `CudaKernel` of every kernel of the port; the
    event path launches the aging kernel only. `floor`: the empty
    kernel, timed beside it. Returns the launches of the torch-settled
    run, the numpy-settled result and the torch-settled one."""
    from repro_torch.kernels.aging_update.ops import KERNEL, advance_fleet
    from repro_torch.kernels.aging_update.ref import aging_update_ref
    from repro_torch.sim import (Cluster, ExperimentConfig,
                                 FleetAgingSettler, collect, run_experiment)
    from repro_torch.workloads import get_scenario

    cfg = ExperimentConfig()
    machine_s = cfg.n_machines * cfg.duration_s
    periods = int(round(cfg.duration_s / cfg.idling_period_s))

    # 1. on the host, the default numpy settler: through the entry point,
    # then step by step for the event count; both must be identical
    t0 = time.perf_counter()
    res = run_experiment(cfg)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    trace = get_scenario(cfg.scenario).generate(
        rate_rps=cfg.rate_rps, duration_s=cfg.duration_s, seed=cfg.seed)
    gen = time.perf_counter() - t0

    def cluster_run(settler_kw, until=None):
        cluster = Cluster(cfg)
        if settler_kw:
            cluster.fleet_settler = FleetAgingSettler(
                [m.manager for m in cluster.machines], **settler_kw)
        t0 = time.perf_counter()
        cluster.run(trace, until or cfg.duration_s,
                    sample_period_s=cfg.sample_period_s)
        return cluster, time.perf_counter() - t0

    cluster, run_wall = cluster_run({})
    again = collect(cluster, cfg)
    if json.dumps(again.to_dict(), sort_keys=True) \
            != json.dumps(res.to_dict(), sort_keys=True):
        raise AssertionError("event-22x120s is not deterministic")
    events = cluster.queue.processed
    log(f"[event] event-22x120s numpy via run_experiment (trace "
        f"generation included): {wall:.3f} s wall, {machine_s / wall:.1f} "
        f"machine-s/wall-s; trace {gen:.3f} s; Cluster.run {run_wall:.3f} "
        f"s, {events} events, {events / run_wall:.0f} events/s; completed "
        f"{res.completed}, p99_latency_s {res.p99_latency_s!r}, "
        f"fleet_yearly_kgco2eq {res.fleet_yearly_kgco2eq!r}; "
        f"a second run identical")
    finite = all(math.isfinite(v) for v in (
        res.mean_latency_s, res.p99_latency_s, res.fleet_yearly_kgco2eq))
    if not finite or res.completed <= 0 or res.engine != "event" \
            or len(res.per_machine_degradation) != cfg.n_machines:
        raise AssertionError("event result is not finite or has the "
                             "wrong shape")

    # 2. against the fleet engine on the same config
    t0 = time.perf_counter()
    fleet = run_experiment(cfg.with_engine("fleet", backend="numpy"))
    log(f"[event] fleet engine, numpy, same config: "
        f"{time.perf_counter() - t0:.3f} s wall, completed "
        f"{fleet.completed}")
    hold("[event] fleet engine vs event engine",
         deltas(fleet, res, EVENT_FLEET_BOUNDS), EVENT_FLEET_BOUNDS)

    # 3a. one identical mid-run state, settled once by each settler
    states = []
    for kw in ({}, {"backend": "torch", "device": "cuda"}):
        mid, _ = cluster_run({}, until=SETTLE_T)
        managers = [m.manager for m in mid.machines]
        FleetAgingSettler(managers, **kw).settle(SETTLE_T + SETTLE_DT)
        states.append(np.stack([m.dvth for m in managers]))
    want, got = states
    err = float(np.abs(got - want).max())
    ok = bool(np.allclose(got, want, **SETTLE_TOL))
    log(f"[event] one settle of the (22, 40) mid-run state at "
        f"t={SETTLE_T + SETTLE_DT}: torch/cuda vs numpy max_abs_err "
        f"{err:.3e} (rtol {SETTLE_TOL['rtol']}, atol {SETTLE_TOL['atol']}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("the torch settler disagrees with numpy")

    # 3b. the whole cell with the torch settler on the card
    zero_launches(kernels)
    cluster, t_wall = cluster_run({"backend": "torch", "device": "cuda"})
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    on_card = collect(cluster, cfg)
    log(f"[event] torch/cuda settler: Cluster.run {t_wall:.3f} s "
        f"(numpy settler {run_wall:.3f} s), completed {on_card.completed}, "
        f"launches {launches}")
    # every periodic tick settles, and in every idling period some core
    # has aged since its last update: one launch per period
    if launches["aging_update"] != periods:
        raise AssertionError(f"aging_update launched "
                             f"{launches['aging_update']} times, "
                             f"expected {periods}")
    if any(n for name, n in launches.items() if name != "aging_update"):
        raise AssertionError(f"a kernel off the event path ran: {launches}")
    hold("[event] torch/cuda settler vs numpy settler",
         deltas(on_card, res, BOUNDS), BOUNDS)

    # 3c. the cell's Cluster.run with each settler, and a settle of each,
    # in turns on the host's clock; the kernel alone at the cell's N on
    # the device
    walls = {"numpy": [], "torch": []}
    for name in ("numpy", "torch", "torch", "numpy"):
        kw = {"backend": "torch", "device": "cuda"} if name == "torch" else {}
        walls[name].append(cluster_run(kw)[1])
    log(f"[event] Cluster.run in turns (numpy, torch, torch, numpy): "
        + "; ".join(f"{k} settler " + ", ".join(f"{w:.3f}" for w in v)
                    + " s" for k, v in walls.items()))
    managers = [m.manager for m in cluster.machines]
    settlers = {"numpy": FleetAgingSettler(managers),
                "torch": FleetAgingSettler(managers, backend="torch",
                                           device="cuda")}
    now = [cfg.duration_s]
    per = {"numpy": [], "torch": []}
    for name in ("numpy", "torch", "torch", "numpy"):
        for _ in range(SETTLE_CALLS):
            now[0] += 1e-3
            t0 = time.perf_counter()
            settlers[name].settle(now[0])
            per[name].append(time.perf_counter() - t0)
    settle_us = {k: sorted(v)[len(v) // 2] * 1e6 for k, v in per.items()}
    dvth, temps, stress, tau = settlers["torch"]._gather(now[0] + 1e-3)
    args = [torch.tensor(a.ravel(), dtype=torch.float32, device="cuda")
            for a in (dvth, temps, stress, tau)]
    n = args[0].numel()
    params = settlers["torch"].params
    empty_launch = empty_launcher(torch, floor)
    kernel_us = graph_ms(lambda: advance_fleet(*args, params)) * 1e3
    plain_us = graph_ms(lambda: aging_update_ref(*args, params)) * 1e3
    floor_us = graph_ms(lambda: empty_launch(n)) * 1e3
    bound_us = max(AGING_BYTES * n / HBM_BYTES_PER_S,
                   AGING_OPS * n / F32_FLOP_PER_S) * 1e6
    log(f"[event] a settle at (22, 40), medians of {2 * SETTLE_CALLS} in "
        f"turns: torch/cuda {settle_us['torch']:.2f} us, numpy "
        f"{settle_us['numpy']:.2f} us; the aging kernel alone at N={n} "
        f"(CUDA graph) {kernel_us:.3f} us, plain {plain_us:.3f} us, an "
        f"empty kernel of the same geometry {floor_us:.3f} us, bound "
        f"{bound_us:.4f} us (bytes)")
    return launches, res, on_card


def aging_only(torch, kernels, path, expected, run):
    """`run()` with every kernel's launch count set to 0 just before it
    and read just after: the aging kernel must have launched `expected`
    times and no other kernel at all. Returns `run()`'s result and its
    wall, the device synchronised."""
    zero_launches(kernels)
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    if launches["aging_update"] != expected or any(
            n for name, n in launches.items() if name != "aging_update"):
        raise AssertionError(f"{path}: launches {launches}, expected "
                             f"{expected} of aging_update only")
    return out, wall


def _result_dict(r) -> str:
    """A result as canonical JSON, less `provenance` (which holds the
    fingerprint, and so `checkpoint_dir` and the telemetry options) and
    `telemetry_summary`: equal strings are equal bits."""
    d = r.to_dict()
    d.pop("provenance")
    d.pop("telemetry_summary")
    return json.dumps(d, sort_keys=True)


def phase_telemetry(torch, np, kernels, reqs, fleet_res, fleet_wall,
                    event_res, event_card):
    """Phase 3d. `kernels`: the `CudaKernel` of every kernel of the port
    (these paths launch the aging kernel only); `reqs`: phase 3's trace;
    `fleet_res`, `fleet_wall`: phase 3's torch result and engine wall;
    `event_res`, `event_card`: phase 3b's results with the numpy and the
    torch settler. Returns the aging kernel's launches on each path."""
    from repro_torch.sim import (Cluster, ExperimentConfig, FleetEngine,
                                 FleetAgingSettler, collect, run_experiment)
    from repro_torch.sim.fleetsim import run_fleet_experiment
    from repro_torch.telemetry import TelemetryHub
    from repro_torch.workloads import get_scenario

    by_path = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # fleet-200x1h-telemetry-ckpt: a caller's hub and checkpoints
        ckpt = os.path.join(tmp, "ckpt")
        cfg = ExperimentConfig(**FLEET).with_engine(
            "fleet", backend="torch", checkpoint_dir=ckpt,
            checkpoint_every_s=CKPT_EVERY_S)
        periods = int(round(cfg.duration_s / cfg.idling_period_s))
        path = "fleet-200x1h-telemetry-ckpt"
        hub = TelemetryHub()
        res, wall = aging_only(
            torch, kernels, path, 2 * periods,
            lambda: run_fleet_experiment(cfg, telemetry=hub, requests=reqs))
        by_path[path] = 2 * periods
        steps = sorted(os.listdir(ckpt))
        nbytes = sum(os.path.getsize(os.path.join(ckpt, d, f))
                     for d in steps for f in os.listdir(os.path.join(ckpt, d)))
        # a checkpoint at every multiple of its period short of the end
        written = (periods - 1) // int(CKPT_EVERY_S / cfg.idling_period_s)
        s = hub.summary()
        points = {k: v["points"] for k, v in s["timelines"].items()}
        same = _result_dict(res) == _result_dict(fleet_res)
        log(f"[telemetry] {path}: engine {wall:.2f} s wall (phase 3's torch "
            f"engine {fleet_wall:.2f} s), {written} checkpoints written, "
            f"{len(steps)} kept ({steps[0]} to {steps[-1]}), {nbytes} bytes "
            f"kept ({nbytes / len(steps):.0f} a checkpoint); hub: events "
            f"{s['event_kinds']}, timeline points {points}, "
            f"gauges {s['gauges']}; B1 {2 * periods} launches; result "
            f"{'equal to' if same else 'DIFFERENT from'} phase 3's")
        if not same:
            raise AssertionError(f"{path}: the result differs from phase "
                                 f"3's torch result")
        if hub.events[0] != {"kind": "engine", "t": 0.0, "engine": "fleet",
                             "backend": "torch"} or res.telemetry_summary \
                is not None or not points["fleet/windows"]:
            raise AssertionError(f"{path}: the hub or the summary is not "
                                 f"what the reference gives")
        # drop the checkpoints after CKPT_RESUME_AT and resume
        resume_step = int(CKPT_RESUME_AT / cfg.idling_period_s)
        for d in steps:
            if int(d[5:]) > resume_step:
                shutil.rmtree(os.path.join(ckpt, d))
        left = periods - resume_step
        path = "fleet-200x1h-telemetry-ckpt-resume"
        again, wall_r = aging_only(
            torch, kernels, path, 2 * left,
            lambda: run_fleet_experiment(cfg, requests=reqs))
        by_path[path] = 2 * left
        same = _result_dict(again) == _result_dict(fleet_res)
        log(f"[telemetry] {path}: resumed at step {resume_step}, engine "
            f"{wall_r:.2f} s wall, B1 {2 * left} launches; result "
            f"{'equal to' if same else 'DIFFERENT from'} phase 3's")
        if not same:
            raise AssertionError(f"{path}: the resumed result differs "
                                 f"from phase 3's torch result")

        # fleet-200x1h-mixed: a padded (200, 64) fleet on the card
        path = "fleet-200x1h-mixed"
        mcfg = ExperimentConfig(**FLEET_MIXED)
        engines, walls = {}, {}
        eng = FleetEngine(mcfg.with_engine("fleet", backend="torch"))
        _, walls["torch"] = aging_only(torch, kernels, path, 2 * periods,
                                    lambda: eng.run(reqs))
        engines["torch"] = eng
        by_path[path] = 2 * periods
        eng = FleetEngine(mcfg.with_engine("fleet", backend="numpy"))
        t0 = time.perf_counter()
        eng.run(reqs)
        walls["numpy"] = time.perf_counter() - t0
        engines["numpy"] = eng
        machine_s = mcfg.n_machines * mcfg.duration_s
        results = {}
        for name, eng in engines.items():
            pad = eng._pad
            dvth = eng.state["dvth"]
            results[name] = r = eng.collect()
            log(f"[telemetry] {path} {name}: engine {walls[name]:.2f} s "
                f"wall, {machine_s / walls[name]:.1f} machine-s/wall-s, "
                f"{dvth.size} lanes ({int(pad.sum())} padded), padded "
                f"lanes' largest dVth {float(np.abs(dvth[pad]).max())!r}, "
                f"completed {r.completed}, p99_latency_s "
                f"{r.p99_latency_s!r}, fleet_yearly_kgco2eq "
                f"{r.fleet_yearly_kgco2eq!r}")
            if dvth.size != 12_800 or int(pad.sum()) != 2_400 \
                    or (dvth[pad] != 0.0).any():
                raise AssertionError(f"{path} {name}: the padded lanes "
                                     f"aged or the fleet is misshapen")
            if not all(math.isfinite(v) for v in (
                    r.mean_latency_s, r.p99_latency_s,
                    r.fleet_yearly_kgco2eq)) or r.completed <= 0:
                raise AssertionError(f"{path} {name}: result not finite")
        hold(f"[telemetry] {path} torch/cuda vs numpy",
             deltas(results["torch"], results["numpy"], BOUNDS), BOUNDS)

        # event-22x120s-telemetry: the numpy settler through the runner
        path = "event-22x120s-telemetry"
        export = os.path.join(tmp, "export")
        ecfg = ExperimentConfig().with_telemetry(export_dir=export)
        t0 = time.perf_counter()
        res = run_experiment(ecfg)
        wall = time.perf_counter() - t0
        s = res.telemetry_summary
        files = {k: (os.path.relpath(v, export), os.path.getsize(v))
                 for k, v in s["export"].items()}
        got = {k: s[k] for k in EVENT_TELEMETRY}
        same = _result_dict(res) == _result_dict(event_res)
        log(f"[telemetry] {path} numpy settler via run_experiment: "
            f"{wall:.3f} s wall; events {s['events']} (dropped "
            f"{s['events_dropped']}), kinds {s['event_kinds']}; exported "
            f"{files}; result {'equal to' if same else 'DIFFERENT from'} "
            f"the [event] run without a hub")
        if not same or got != EVENT_TELEMETRY:
            raise AssertionError(f"{path}: the result or the summary "
                                 f"differs: {got}")
        # the same cell with the torch settler on the card and a hub
        ocfg = ExperimentConfig()
        trace = get_scenario(ocfg.scenario).generate(
            rate_rps=ocfg.rate_rps, duration_s=ocfg.duration_s,
            seed=ocfg.seed)
        hub = TelemetryHub()

        def torch_settled():
            cluster = Cluster(ocfg, telemetry=hub)
            cluster.fleet_settler = FleetAgingSettler(
                [m.manager for m in cluster.machines], backend="torch",
                device="cuda")
            cluster.run(trace, ocfg.duration_s,
                        sample_period_s=ocfg.sample_period_s)
            return collect(cluster, ocfg, telemetry=hub)
        periods = int(round(ocfg.duration_s / ocfg.idling_period_s))
        card, wall = aging_only(torch, kernels, path, periods,
                                torch_settled)
        by_path[path] = periods
        same = json.dumps(card.to_dict(), sort_keys=True) == json.dumps(
            event_card.to_dict(), sort_keys=True)
        log(f"[telemetry] {path} torch/cuda settler with a hub: "
            f"Cluster.run and collect {wall:.3f} s, {hub.summary()['events']}"
            f" events, B1 {periods} launches; result "
            f"{'equal to' if same else 'DIFFERENT from'} the torch-settled "
            f"[event] run without a hub")
        if not same:
            raise AssertionError(f"{path}: the torch-settled result "
                                 f"differs with a hub")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return by_path


def conserved(r) -> bool:
    """Every submitted request is completed, failed, rejected or pending."""
    return (r.completed + r.failed_requests + r.rejected_requests
            + r.pending_requests) == r.submitted


def fault_line(tag, name, r, wall=None, machine_s=None) -> None:
    speed = "" if wall is None else (
        f"{wall:.2f} s wall, {machine_s / wall:.1f} machine-s/wall-s, ")
    log(f"{tag} {name}: {speed}core_failures {r.core_failures}, "
        f"machine_crashes {r.machine_crashes}, availability "
        f"{r.availability!r}, retries {r.retries}, completed {r.completed} "
        f"of {r.submitted} submitted (failed {r.failed_requests}, rejected "
        f"{r.rejected_requests}, pending {r.pending_requests}), "
        f"p99_latency_s {r.p99_latency_s!r}, fleet_yearly_kgco2eq "
        f"{r.fleet_yearly_kgco2eq!r}")


def phase_faults(torch, kernels, reqs):
    """Phase 3c. `kernels`: the `CudaKernel` of every kernel of the port
    (the fault paths launch the aging kernel only); `reqs`: phase 3's
    trace. Returns the aging kernel's launches on each path."""
    from repro_torch.sim import (Cluster, ExperimentConfig,
                                 FleetAgingSettler, collect, run_experiment)
    from repro_torch.sim.fleetsim import run_fleet_experiment
    from repro_torch.workloads import get_scenario

    by_path = {}
    for path, kw in (("fleet-200x1h-guardband", FLEET_GUARDBAND),
                     ("fleet-200x1h-crash", FLEET_CRASH)):
        cfg = ExperimentConfig(**kw).with_engine("fleet", backend="torch")
        machine_s = cfg.n_machines * cfg.duration_s
        periods = int(round(cfg.duration_s / cfg.idling_period_s))
        res, wall_t = aging_only(
            torch, kernels, path, 2 * periods,
            lambda: run_fleet_experiment(cfg, requests=reqs))
        by_path[path] = 2 * periods
        t0 = time.perf_counter()
        ref = run_fleet_experiment(cfg.with_engine("fleet", backend="numpy"),
                                   requests=reqs)
        wall_n = time.perf_counter() - t0
        tag = f"[faults] {path}"
        fault_line(tag, "torch/cuda", res, wall_t, machine_s)
        fault_line(tag, "numpy", ref, wall_n, machine_s)
        if not all(math.isfinite(v) for v in (
                res.mean_latency_s, res.p99_latency_s,
                res.fleet_yearly_kgco2eq)) or not conserved(res):
            raise AssertionError(f"{tag}: result not finite or requests "
                                 f"not conserved")
        if (res.core_failures, res.machine_crashes, res.stalls) != \
                (ref.core_failures, ref.machine_crashes, ref.stalls):
            raise AssertionError(f"{tag}: fault counts differ from numpy")
        got = dict(deltas(res, ref, BOUNDS),
                   availability=rel(res.availability, ref.availability),
                   retries=rel(res.retries, ref.retries)
                   if ref.retries else float(res.retries))
        hold(f"{tag} torch/cuda vs numpy", got,
             dict(BOUNDS, availability=AVAILABILITY_RTOL,
                  retries=RETRIES_RTOL))
        if path.endswith("guardband") and not res.core_failures:
            raise AssertionError(f"{tag}: no core failed")
        if path.endswith("crash") and not (res.machine_crashes
                                           and res.retries):
            raise AssertionError(f"{tag}: no crash or no retry")

    path = "event-22x60s-guardband"
    base = ExperimentConfig(**EVENT_GUARDBAND)
    periods = int(round(base.duration_s / base.idling_period_s))
    numpy_runs, torch_runs = {}, {}
    for policy in ("linux", "proposed"):
        cfg = base.with_policy(policy)
        t0 = time.perf_counter()
        numpy_runs[policy] = run_experiment(cfg)
        fault_line(f"[faults] {path}", f"{policy}, numpy settler",
                   numpy_runs[policy], time.perf_counter() - t0,
                   cfg.n_machines * cfg.duration_s)
    trace = get_scenario(base.scenario).generate(
        rate_rps=base.rate_rps, duration_s=base.duration_s, seed=base.seed)

    def torch_settled():
        for policy in ("linux", "proposed"):
            cfg = base.with_policy(policy)
            cluster = Cluster(cfg)
            cluster.fleet_settler = FleetAgingSettler(
                [m.manager for m in cluster.machines], backend="torch",
                device="cuda")
            t0 = time.perf_counter()
            cluster.run(trace, cfg.duration_s,
                        sample_period_s=cfg.sample_period_s)
            torch_runs[policy] = collect(cluster, cfg)
            fault_line(f"[faults] {path}", f"{policy}, torch/cuda settler",
                       torch_runs[policy], time.perf_counter() - t0,
                       cfg.n_machines * cfg.duration_s)
    aging_only(torch, kernels, path, 2 * periods, torch_settled)
    by_path[path] = 2 * periods
    for name, runs in (("numpy", numpy_runs), ("torch/cuda", torch_runs)):
        linux, proposed = runs["linux"], runs["proposed"]
        ok = (proposed.core_failures < linux.core_failures
              and proposed.availability > linux.availability
              and all(conserved(r) for r in runs.values()))
        log(f"[faults] {path} {name} settler: proposed fails "
            f"{proposed.core_failures} cores against linux's "
            f"{linux.core_failures}, availability {proposed.availability:.4f}"
            f" against {linux.availability:.4f}, requests conserved: "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"{path}: the acceptance pair does not "
                                 f"hold with the {name} settler")
    for policy in ("linux", "proposed"):
        hold(f"[faults] {path} {policy} torch/cuda vs numpy settler",
             deltas(torch_runs[policy], numpy_runs[policy], BOUNDS), BOUNDS)
    return by_path


def serve_cell(torch, np, serve, kernels, expected):
    """One serving cell (`SERVE`, `SERVE_MAMBA`, `SERVE_MOE`, `SERVE_MLA`
    or `SERVE_VLM`) on the card through the port's engine. `kernels`: the
    `CudaKernel` of every kernel of the port; `expected(cfg,
    decode_iterations)`: the launches of each of them that the path must
    make. Also holds the decode calls given K's rope part apart
    (`rope_apart_calls`) at one per MLA layer and decode step. Returns
    (the model, the prompts, the engine's tokens of each, the launches,
    the cell's tag)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.models import Model
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.telemetry import TelemetryHub

    cfg = get_config(serve["arch"])
    tag = f"[serve {cfg.name}]"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=serve["seed"])
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    shape = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads" if cfg.num_heads
             else f"d_inner {cfg.d_inner}, {cfg.ssm_heads} SSD heads of "
                  f"P {cfg.ssm_head_dim}, state N {cfg.ssm_state}")
    if cfg.num_experts:
        shape += (f", {cfg.num_experts} experts of d_ff {cfg.d_ff}, top-"
                  f"{cfg.experts_per_token}")
    if cfg.attn_type == "mla":
        shape += (f", MLA: q/k head dim {cfg.qk_nope_dim + cfg.qk_rope_dim}"
                  f", v {cfg.v_head_dim}, latent {cfg.kv_lora_rank} + "
                  f"{cfg.qk_rope_dim}")
    log(f"{tag} {cfg.num_layers} layers, d_model {cfg.d_model}, {shape}, "
        f"vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), {cfg.dtype}: "
        f"{n_params:,} parameters ({n_params * 2 / 1e9:.2f} GB) "
        f"initialised on the card in {time.perf_counter() - t0:.2f} s")

    def engine(hub=None):
        return InferenceEngine(
            model, max_batch=serve["max_batch"], max_len=serve["max_len"],
            policy=serve["policy"], num_host_cores=serve["host_cores"],
            telemetry=hub)

    warm = engine()                    # cuBLAS handles, allocator pools
    warm.submit(list(range(serve["prompt_lens"][0])), max_new_tokens=2)
    warm.run_until_drained()
    del warm

    rng = np.random.default_rng(serve["seed"])
    lo, hi = serve["prompt_lens"]
    lens = rng.integers(lo, hi + 1, serve["requests"])
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    hub = TelemetryHub()
    eng = engine(hub)
    prefill_s, decode_iters = [0.0], [0]
    real_prefill, real_decode = eng._prefill_fn, eng._decode_fn

    def timed_prefill(tokens):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_prefill(tokens)
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t
        return out

    def counted_decode(*args):
        decode_iters[0] += 1
        return real_decode(*args)

    eng._prefill_fn, eng._decode_fn = timed_prefill, counted_decode
    zero_launches(kernels)
    apart_before = dec_ops.rope_apart_calls
    t0 = time.perf_counter()
    reqs = []
    for prompt in prompts:
        eng.submit(prompt, max_new_tokens=serve["new_tokens"])
        reqs.append(eng.pending[-1])
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    apart = dec_ops.rope_apart_calls - apart_before
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    new = serve["requests"] * serve["new_tokens"]
    decode_tokens = new - serve["requests"]   # the first comes of prefill
    decode_s = wall - prefill_s[0]
    log(f"{tag} {serve['requests']} requests, prompts "
        f"{sorted(int(n) for n in lens)} tokens, {serve['new_tokens']} new "
        f"each: wall {wall:.3f} s ({new / wall:.1f} tok/s); prefill "
        f"{prefill_s[0]:.3f} s for {int(lens.sum())} prompt tokens "
        f"({lens.sum() / prefill_s[0]:.1f} tok/s); decode {decode_s:.3f} s, "
        f"{decode_iters[0]} iterations, {decode_tokens} tokens "
        f"({decode_tokens / decode_s:.1f} tok/s, "
        f"{decode_s / decode_iters[0] * 1e3:.2f} ms per iteration)")
    rep = eng.host_cpu_report()
    log(f"{tag} host CPU [{rep['policy']}]: cores_active="
        f"{rep['active_cores']}/{serve['host_cores']} cv={rep['cv']:.4f} "
        f"mean_freq_degradation={rep['mean_degradation']:.5f} "
        f"cpu_tasks={rep['assigns']}")
    # the hub counts the tasks placed on a core and, apart, those that
    # found none (oversubscribed); together they are the manager's
    metrics = eng.core_manager.metrics
    placed = hub.counter("assigns").value
    oversub = hub.counter("oversub_assigns").value
    prom = eng.prometheus_text()
    log(f"{tag} telemetry hub: assigns {placed} + oversub_assigns "
        f"{oversub} (manager: assigns {metrics.assigns}, oversub "
        f"{metrics.oversub_assigns}), {hub.summary()['events']} events, "
        f"prometheus_text {len(prom.splitlines())} lines")
    if placed + oversub != metrics.assigns \
            or oversub != metrics.oversub_assigns \
            or f"repro_host_assigns {metrics.assigns}" not in prom:
        raise AssertionError(f"{tag}: the hub's counters or the "
                             f"Prometheus text disagree with the manager")
    want = expected(cfg, decode_iters[0])
    log(f"{tag} launches {launches} (expected {want}); peak device memory "
        f"{peak_gb:.2f} GB")
    # each MLA layer of a decode step gives B3 K's rope part apart
    want_apart = cfg.num_layers if cfg.attn_type == "mla" \
        and not cfg.mla_absorb else 0
    log(f"{tag} decode_attention calls given K's rope part apart: {apart}, "
        f"{apart / decode_iters[0]:g} per decode step (expected "
        f"{want_apart})")
    if apart != want_apart * decode_iters[0]:
        raise AssertionError(f"{tag}: {apart} rope-apart calls in "
                             f"{decode_iters[0]} decode steps, expected "
                             f"{want_apart} a step")
    if launches != want:
        raise AssertionError(f"the serve path did not run through its "
                             f"kernels as expected: {launches} != {want}")
    if any(len(r.output) != serve["new_tokens"] for r in reqs) or any(
            not 0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise AssertionError("a request did not get its tokens")

    tokens = [req.output for req in reqs]
    # the hooks' closures hold the engine: freed here, not by a later
    # garbage collection, so that the next cell finds the card empty
    del eng, reqs, real_prefill, real_decode, hub
    return model, prompts, tokens, launches, tag


def phase_serve(torch, np, serve, kernels, expected, after=None):
    """`serve_cell`; then `after(model, prompts, tokens, tag)`, if given;
    then the two holds of the kernel path against the plain path on the
    engine's tokens. Returns the cell's launches."""
    model, prompts, tokens, launches, tag = serve_cell(
        torch, np, serve, kernels, expected)
    if after is not None:
        after(model, prompts, tokens, tag)
    _hold_bf16(torch, model, prompts, tokens, tag)
    cfg = model.cfg
    del model
    torch.cuda.empty_cache()
    _hold_f32(torch, cfg, prompts, tokens, tag)
    return launches


def phase_vlm(torch, np, serve, kernels, expected):
    """Phase 9: the vision-frontend model served text only (`serve_cell`:
    the engine passes no embeddings, as the reference's does); then
    PATCH_REQUESTS of its requests again, each behind 256 patch
    embeddings (PATCH_SEED), through `Model.prefill` and
    `Model.decode_step` (`_direct_run`), and the two holds on these.
    Returns (the cell's launches, the patch run's)."""
    model, prompts, _, served, tag = serve_cell(torch, np, serve, kernels,
                                                expected)
    tag = f"{tag} patches"
    cfg = model.cfg
    prompts = prompts[:PATCH_REQUESTS]
    embeds = _frontend_embeds(torch, model, PATCH_REQUESTS, PATCH_SEED)
    tokens, patches, steps = _direct_run(torch, model, serve, prompts,
                                         kernels, tag, embeds)
    _check_launches(tag, patches, {
        "aging_update": 0, "ssd_scan": 0,
        "flash_attention": cfg.num_layers * PATCH_REQUESTS,
        "decode_attention": cfg.num_layers * steps})
    _hold_bf16(torch, model, prompts, tokens, tag, embeds)
    del model
    torch.cuda.empty_cache()
    _hold_f32(torch, cfg, prompts, tokens, tag, embeds)
    return served, patches


def _frontend_embeds(torch, model, n, seed):
    """n sets of a frontend's embeddings (1, frontend_tokens, d_model),
    float32, normal at the model's embedding table's std, drawn on the
    card from `seed`."""
    cfg = model.cfg
    std = float(model.embed.float().std())
    gen = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn((1, cfg.frontend_tokens, cfg.d_model), generator=gen,
                        device="cuda") * std for _ in range(n)]


def _stack_caches(torch, model, caches):
    """Caches of single requests (batch 1, 0-d pos) as one cache of their
    slots with a per-slot pos, each tensor stacked on the batch axis that
    `Model.cache_batch_dim` gives for its key."""
    def cat(key, vals):
        if isinstance(vals[0], dict):
            return {k: cat(key, [v[k] for v in vals]) for k in vals[0]}
        return torch.cat(vals, dim=model.cache_batch_dim(key))

    return {key: torch.stack([c[key] for c in caches]) if key == "pos"
            else None if val is None else cat(key, [c[key] for c in caches])
            for key, val in caches[0].items()}


def _drive(torch, model, prompts, new_tokens, max_len, embeds=None):
    """The port's model entry points, as a user of a family the engine
    refuses calls them: each request's prompt (behind its `embeds`, if
    given) through `Model.prefill`, one at a time; then DIRECT_BATCH
    requests at a time through `Model.decode_step` with their caches
    stacked and a per-slot pos, greedy, `new_tokens` each (the first from
    the prefill). Returns (tokens of each request, prefill seconds,
    decode seconds, decode steps), on a synchronised host clock."""
    vocab = model.cfg.vocab_size
    outs, prefill_s, decode_s, steps = [], 0.0, 0.0, 0
    for lo in range(0, len(prompts), DIRECT_BATCH):
        group = range(lo, min(lo + DIRECT_BATCH, len(prompts)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caches, first = [], []
        for i in group:
            logits, cache = model.prefill(
                torch.tensor([prompts[i]], device="cuda"), max_len=max_len,
                embeds=None if embeds is None else embeds[i])
            caches.append(cache)
            first.append(logits[0, -1, :vocab].argmax())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cache = _stack_caches(torch, model, caches)
        del caches
        tok = torch.stack(first)[:, None]
        out = [tok]
        for _ in range(new_tokens - 1):
            logits, cache = model.decode_step(cache, tok)
            tok = logits[:, 0, :vocab].argmax(-1, keepdim=True)
            out.append(tok)
            steps += 1
        torch.cuda.synchronize()
        prefill_s += t1 - t0
        decode_s += time.perf_counter() - t1
        outs.extend(torch.cat(out, dim=1).tolist())
        del cache
    return outs, prefill_s, decode_s, steps


def _direct_run(torch, model, serve, prompts, kernels, tag, embeds=None):
    """`_drive` on `prompts` with the launch counts set to 0 just before
    and read just after; logs the run. Returns (tokens, launches, decode
    steps)."""
    zero_launches(kernels)
    t0 = time.perf_counter()
    tokens, prefill_s, decode_s, steps = _drive(
        torch, model, prompts, serve["new_tokens"], serve["max_len"], embeds)
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    n = len(prompts)
    new = n * serve["new_tokens"]
    prompt_tokens = sum(len(p) for p in prompts)
    front = ""
    if embeds is not None:
        front = f", {embeds[0].shape[1]} frontend embeddings each"
    log(f"{tag} {n} requests through Model.prefill and Model.decode_step "
        f"({DIRECT_BATCH} decoded at a time), prompts "
        f"{sorted(len(p) for p in prompts)} tokens{front}, "
        f"{serve['new_tokens']} new each: wall {wall:.3f} s ({new / wall:.1f}"
        f" tok/s); prefill {prefill_s:.3f} s for {prompt_tokens} prompt "
        f"tokens ({prompt_tokens / prefill_s:.1f} tok/s); decode "
        f"{decode_s:.3f} s, {steps} steps ({decode_s / steps * 1e3:.2f} ms "
        f"each); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    vocab = model.cfg.vocab_size
    if any(len(t) != serve["new_tokens"] or not all(0 <= x < vocab
                                                     for x in t)
           for t in tokens):
        raise AssertionError(f"{tag}: a request did not get its tokens")
    return tokens, launches, steps


def _check_launches(tag, launches, want):
    log(f"{tag} launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{tag}: the path did not run through its "
                             f"kernels as expected: {launches} != {want}")


def _new_model(torch, serve, tag):
    """`serve`'s architecture at full width on the card, from its seed;
    logs its size."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(serve["arch"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=serve["seed"])
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{tag} {cfg.family}: {cfg.num_layers} layers"
        f"{f' + {cfg.encoder_layers} encoder layers' if cfg.is_encdec else ''}"
        f", d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
        f"of {cfg.resolved_head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}: "
        f"{n_params:,} parameters ({n_params * 2 / 1e9:.2f} GB) initialised "
        f"on the card in {time.perf_counter() - t0:.2f} s")
    return model


def phase_direct(torch, np, serve, kernels, expected, frame_seed=None):
    """Phases 8 and 10: a family the engine refuses (the hybrid, the
    encoder-decoder), driven through `Model.prefill` and
    `Model.decode_step` with `serve`'s traffic (`_drive`), an
    encoder-decoder's source as frame embeddings drawn from `frame_seed`;
    then the two holds of the kernel path against the plain path, and an
    encoder-decoder's `_hold_memory`.
    `expected(cfg, steps)`: the launches the path must make. Returns
    them."""
    tag = f"[{serve['arch']}]"
    model = _new_model(torch, serve, tag)
    cfg = model.cfg
    rng = np.random.default_rng(serve["seed"])
    lo, hi = serve["prompt_lens"]
    lens = rng.integers(lo, hi + 1, serve["requests"])
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    embeds = None if frame_seed is None else _frontend_embeds(
        torch, model, serve["requests"], frame_seed)
    # warm-up: cuBLAS handles, allocator pools
    _drive(torch, model, prompts[:1], 2, serve["max_len"],
           None if embeds is None else embeds[:1])
    tokens, launches, steps = _direct_run(torch, model, serve, prompts,
                                          kernels, tag, embeds)
    _check_launches(tag, launches, expected(cfg, steps))
    _hold_bf16(torch, model, prompts, tokens, tag, embeds)
    if cfg.is_encdec:
        _hold_memory(torch, model, prompts, embeds, tag)
    del model
    torch.cuda.empty_cache()
    _hold_f32(torch, cfg, prompts, tokens, tag, embeds)
    return launches


def _teacher_forced(torch, model, prompts, tokens, use_kernel, embeds=None):
    """The model's logits (vocab only, float32) at every step of each
    request: each prompt (behind its frontend's `embeds`, if given)
    through `prefill` alone, then the engine's tokens through
    `decode_step`, the requests together (their caches stacked, a
    per-slot pos; one request keeps its own cache). Returns one (steps,
    vocab) tensor a request."""
    vocab = model.cfg.vocab_size
    embeds = embeds or [None] * len(prompts)
    n_new = len(tokens[0])
    if any(len(t) != n_new for t in tokens):
        raise AssertionError("requests of unequal token counts")
    front = [e.shape[1] if e is not None and model.cfg.family == "vlm"
             else 0 for e in embeds]
    max_len = max(f + len(p) for f, p in zip(front, prompts)) + n_new
    caches, first = [], []
    for prompt, emb in zip(prompts, embeds):
        logits, cache = model.prefill(
            torch.tensor([prompt], device="cuda"), max_len=max_len,
            embeds=emb, use_kernel=use_kernel)
        caches.append(cache)
        first.append(logits[0, -1, :vocab].float())
    cache = caches[0] if len(caches) == 1 else _stack_caches(torch, model,
                                                            caches)
    del caches
    steps = [torch.stack(first)]
    for i in range(n_new - 1):
        tok = torch.tensor([[t[i]] for t in tokens], device="cuda")
        logits, cache = model.decode_step(cache, tok, use_kernel=use_kernel)
        steps.append(logits[:, -1, :vocab].float())
    out = torch.stack(steps, dim=1)
    if not torch.isfinite(out).all():
        raise AssertionError("logits are not finite")
    return list(out)


def _rel_l2(a, b):
    return ((a - b).norm(dim=-1) / b.norm(dim=-1)).amax().item()


class _Routes:
    """While entered, records the top-k expert ids of every MoE layer
    call for each token (one (B, S, k) tensor per call, in call order and
    top-k order). Given `replay` (such a record of another run), it routes
    each call to the recorded ids instead of its own top-k, with the gates
    this call's probabilities at those ids, renormalised as `moe_ffn`
    renormalises them, and still records its own top-k. Two runs that
    replay one record differ by their numerics alone, not by which expert
    won a near-tie."""

    def __init__(self, torch, replay=None):
        from repro_torch.models import moe
        self.torch, self.moe, self.replay, self.calls = torch, moe, replay, []

    def __enter__(self):
        torch, moe, calls = self.torch, self.moe, self.calls
        real = self.real = moe._route
        pending = None if self.replay is None else iter(self.replay)

        def route(x, params, cfg):
            if pending is None:
                gate, idx, aux = real(x, params, cfg)
                calls.append(idx)
                return gate, idx, aux
            idx = next(pending)
            probs = moe.router_probs(x, params["router"])
            calls.append(torch.topk(probs, cfg.experts_per_token,
                                    dim=-1).indices)
            gate = probs.gather(-1, idx)
            gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
            return gate, idx, moe.load_balance_loss(probs, idx,
                                                    cfg.num_experts)
        moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.real


def _routed(torch, model, prompts, tokens, use_kernel, replay=None,
            embeds=None):
    """`_teacher_forced` under `_Routes`: (logits of each request, the
    routes taken)."""
    with _Routes(torch, replay) as routes:
        out = _teacher_forced(torch, model, prompts, tokens, use_kernel,
                              embeds)
    return out, routes.calls


def _hold_bf16(torch, model, prompts, tokens, tag, embeds=None):
    """bfloat16: kernel path vs plain path, against the noise floor. For
    MoE the kernel path and the noisy plain path replay the plain path's
    routes (`_Routes`), so both distances measure numerics: top-k routing
    is discontinuous, and a near-tie that bfloat16 rounding decides either
    way moves a token to another expert whatever its cause. The top-k the
    kernel path would take on those routes is counted against them.
    `embeds`: each request's frontend embeddings (patches or frames), or
    None; the noisy path perturbs them as it does the embedding table.
    For an encoder-decoder, whose 24 bidirectional layers amplify that
    to a floor near a quarter of the logits' norm, the floor of the
    token table alone is measured and printed beside it; it is not held,
    since it leaves out the encoder, whose path `_hold_memory` holds
    against a floor of its own. Each pass decodes the requests together
    (`_teacher_forced`)."""
    t0 = time.perf_counter()
    moe_model = bool(model.cfg.num_experts)
    kernel_d, noise_d, max_err, flips, steps = 0.0, 0.0, 0.0, 0, 0
    routes, route_flips = 0, 0
    embeds = embeds or [None] * len(prompts)
    plains, taken = _routed(torch, model, prompts, tokens, False,
                            embeds=embeds)
    kernels, own = _routed(torch, model, prompts, tokens, True,
                           replay=taken if moe_model else None,
                           embeds=embeds)
    if moe_model:
        routes, route_flips, _ = _route_flips(torch, own, taken,
                                              model.cfg.num_layers)
    for toks, p, k in zip(tokens, plains, kernels):
        kernel_d = max(kernel_d, _rel_l2(k, p))
        max_err = max(max_err, float((k - p).abs().max()))
        flips += int((p.argmax(-1) != torch.tensor(toks, device="cuda"))
                     .sum())
        steps += len(toks)
    del kernels

    def floor(frontend):
        """The noisy plain path's distance from the plain path: the
        embedding table perturbed (seed 1), and the frontend's
        embeddings too (seed 2) if `frontend`."""
        table = model.embed.data
        noise = torch.randn(table.shape, generator=torch.Generator(
            "cuda").manual_seed(1), device="cuda")
        model.embed.data = (table.float() * (1 + NOISE_REL * noise)).to(
            table.dtype)
        del noise
        gen = torch.Generator("cuda").manual_seed(2)
        noisy_embeds = [emb * (1 + NOISE_REL * torch.randn(
            emb.shape, generator=gen, device="cuda"))
            if emb is not None and frontend else emb for emb in embeds]
        try:
            noisy, _ = _routed(torch, model, prompts, tokens, False,
                               replay=taken if moe_model else None,
                               embeds=noisy_embeds)
        finally:
            model.embed.data = table
        return max(_rel_l2(n, p) for n, p in zip(noisy, plains))

    noise_d = floor(True)
    table_only = ""
    if model.cfg.is_encdec:
        table_only = (f"; token table alone, not held: "
                      f"{floor(False):.4e}")
    pinned = ""
    if moe_model:
        pinned = (f" (MoE: both on the plain path's routes; there the "
                  f"kernel path's own top-k would differ at {route_flips} "
                  f"of {routes} (token, layer), {route_flips / routes:.3e})")
    log(f"{tag} bfloat16, kernel vs plain path on the engine's tokens: "
        f"{steps} steps, max |logit diff| {max_err:.4f}, max relative L2 "
        f"{kernel_d:.4e}; noise floor (plain path, embeddings"
        f"{'' if embeds[0] is None else ' and frontend inputs'} perturbed by "
        f"{NOISE_REL:.3g} relative) {noise_d:.4e}{table_only}{pinned}; "
        f"plain greedy tokens that differ from the engine's: {flips}/{steps} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not kernel_d <= noise_d:
        raise AssertionError(f"kernel path leaves the bfloat16 noise floor: "
                             f"{kernel_d:.4e} > {noise_d:.4e}")


def _hold_memory(torch, model, prompts, embeds, tag):
    """bfloat16, an encoder-decoder: the encoder's memory as the
    cross-attention cache that `Model.prefill` leaves (every layer's xk
    and xv), kernel path vs plain path, per request as a relative L2
    distance, against a noise floor of its own: the plain path's memory
    with each request's frames perturbed by relative Gaussian noise of
    NOISE_REL (seed 2). Both are maxima over the requests."""
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(2)

    def memory(prompt, emb, use_kernel):
        _, cache = model.prefill(torch.tensor([prompt], device="cuda"),
                                 embeds=emb, use_kernel=use_kernel)
        return torch.cat([cache["xk"].flatten(),
                          cache["xv"].flatten()]).float()

    def dist(a, b):
        return float((a - b).norm() / b.norm())

    kernel_d, noise_d = 0.0, 0.0
    for prompt, emb in zip(prompts, embeds):
        p = memory(prompt, emb, False)
        kernel_d = max(kernel_d, dist(memory(prompt, emb, True), p))
        noisy = emb * (1 + NOISE_REL * torch.randn(emb.shape, generator=gen,
                                                   device="cuda"))
        noise_d = max(noise_d, dist(memory(prompt, noisy, False), p))
        del p
    log(f"{tag} bfloat16, the encoder's memory (xk, xv of "
        f"{model.cfg.num_layers} layers), kernel vs plain path: "
        f"{len(prompts)} requests, max relative L2 {kernel_d:.4e}; noise "
        f"floor (plain path, frames perturbed by {NOISE_REL:.3g} relative) "
        f"{noise_d:.4e} ({time.perf_counter() - t0:.1f} s)")
    if not kernel_d <= noise_d:
        raise AssertionError(f"the encoder's memory leaves the bfloat16 "
                             f"noise floor: {kernel_d:.4e} > {noise_d:.4e}")


def _route_flips(torch, kernel_calls, plain_calls, n_layers):
    """(routes, differing routes, per step the count of its differing
    routes) of one teacher-forced request: the prefill (step 0), then one
    decode step each, n_layers calls a step. A route differs when its set
    of experts does."""
    routes, flips, per_step = 0, 0, []
    for i in range(0, len(kernel_calls), n_layers):
        step = 0
        for a, b in zip(kernel_calls[i:i + n_layers],
                        plain_calls[i:i + n_layers]):
            routes += a.shape[0] * a.shape[1]
            step += int((a.sort(-1).values != b.sort(-1).values)
                        .any(-1).sum())
        flips += step
        per_step.append(step)
    return routes, flips, per_step


def _hold_f32(torch, cfg, prompts, tokens, tag, embeds=None):
    """float32 at full width: kernel path vs plain path, tight; for MoE
    on the steps whose routes agree (see F32_RTOL). `embeds`: each
    request's frontend embeddings, or None."""
    import dataclasses

    from repro_torch.models import Model
    t0 = time.perf_counter()
    model = Model(dataclasses.replace(cfg, dtype="float32"), device="cuda",
                  seed=1)
    worst, max_err, steps, held = -math.inf, 0.0, 0, 0
    routes, flips, flip_steps, unheld_err = 0, 0, 0, 0.0
    embeds = embeds or [None] * len(prompts)
    for prompt, toks, emb in list(zip(prompts, tokens,
                                      embeds))[:F32_REQUESTS]:
        (k,), on_kernel = _routed(torch, model, [prompt], [toks], True,
                                  embeds=[emb])
        (p,), on_plain = _routed(torch, model, [prompt], [toks], False,
                                 embeds=[emb])
        diff = (k - p).abs()
        margin = (diff - F32_ATOL - F32_RTOL * p.abs()).amax(-1)
        agree = torch.ones(len(toks), dtype=torch.bool, device=k.device)
        if cfg.num_experts:
            r, f, per_step = _route_flips(torch, on_kernel, on_plain,
                                          cfg.num_layers)
            routes, flips = routes + r, flips + f
            agree = torch.tensor([n == 0 for n in per_step],
                                 device=k.device)
            flip_steps += int((~agree).sum())
            if (~agree).any():
                unheld_err = max(unheld_err, float(diff[~agree].max()))
        if agree.any():
            max_err = max(max_err, float(diff[agree].max()))
            worst = max(worst, float(margin[agree].max()))
        steps += len(toks)
        held += int(agree.sum())
    routing = ""
    if cfg.num_experts:
        routing = (f"; routes (token, layer): {flips} of {routes} differ "
                   f"({flips / routes:.3e}, limit {ROUTE_FLIP_MAX}), on "
                   f"{flip_steps} steps, held {held} of {steps} steps "
                   f"(max |logit diff| on the others {unheld_err:.3e})")
    log(f"{tag} float32 at full width, kernel vs plain path: {steps} "
        f"steps of {F32_REQUESTS} requests, max |logit diff| {max_err:.3e} "
        f"(bound {F32_ATOL} + {F32_RTOL} |plain|, worst margin "
        f"{worst:.3e}){routing} ({time.perf_counter() - t0:.1f} s)")
    del model
    torch.cuda.empty_cache()
    if cfg.num_experts and flips > ROUTE_FLIP_MAX * routes:
        raise AssertionError(f"{flips} of {routes} routes differ between "
                             f"the kernel and the plain path")
    if held == 0:
        raise AssertionError("no step held: every step took a differing "
                             "route")
    if worst > 0:
        raise AssertionError(f"float32 kernel path leaves the bound "
                             f"(worst margin {worst:.3e})")


def _train_batch(np, cfg, seed):
    """A seeded batch of 2 x 32 tokens of `cfg`'s smoke model, with zero
    patch embeddings (a vlm) or seeded frame embeddings (an
    encoder-decoder)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32))}
    shape = (2, cfg.frontend_tokens, cfg.d_model)
    if cfg.is_encdec:
        batch["embeds"] = (rng.standard_normal(shape) * 0.02).astype(
            np.float32)
    elif cfg.frontend != "none":
        batch["embeds"] = np.zeros(shape, np.float32)
    return batch


def _loss_and_grads(torch, model, batch):
    """(loss, {name: grad}) of one `Model.loss` and its backward pass;
    the grads are taken off the params."""
    model.requires_grad_(True)
    loss = model.loss(batch)
    loss.backward()
    grads = {}
    for name, p in model.named_parameters():
        grads[name], p.grad = p.grad, None
    return loss.detach(), grads


def train_f32_hold(torch, np, kernels):
    """Each family's smoke config in float32: the card's loss and every
    gradient against the port's CPU result for the same weights and
    batch, at TRAIN_F32; no kernel launches."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    t0 = time.perf_counter()
    zero_launches(kernels)
    worst, max_err, n_grads = -math.inf, 0.0, 0
    for i, arch in enumerate(TRAIN_FAMILIES):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        batch = _train_batch(np, cfg, i)
        cpu = Model(cfg, device="cpu", seed=0)
        card = Model(cfg, device="cuda", seed=0)
        card.load_state_dict(cpu.state_dict())
        want, want_g = _loss_and_grads(torch, cpu, batch)
        got, got_g = _loss_and_grads(torch, card, batch)
        pairs = [(got.cpu(), want)] + [(got_g[n].cpu(), g)
                                       for n, g in want_g.items()]
        for a, b in pairs:
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"[train] {arch}: not finite")
            diff = (a - b).abs()
            max_err = max(max_err, float(diff.max()))
            worst = max(worst, float((diff - TRAIN_F32["atol"]
                                      - TRAIN_F32["rtol"] * b.abs()).max()))
        n_grads += len(want_g)
        log(f"[train] {arch} smoke, float32: loss card {got.item():.6f} "
            f"cpu {want.item():.6f}")
    launches = read_launches(kernels)
    log(f"[train] float32 smoke models, loss and {n_grads} gradients of "
        f"{len(TRAIN_FAMILIES)} families, card vs CPU: max |diff| "
        f"{max_err:.3e}, worst margin {worst:.3e} (bound "
        f"{TRAIN_F32['atol']} + {TRAIN_F32['rtol']} |cpu|) "
        f"({time.perf_counter() - t0:.1f} s)")
    _check_launches("[train] smoke models", launches,
                    {name: 0 for name in launches})
    if worst > 0:
        raise AssertionError(f"[train] card and CPU differ beyond the "
                             f"float32 bound (worst margin {worst:.3e})")


def train_store_resume(torch, np, kernels):
    """The smoke Llama (bfloat16) on the card: TRAIN_SAVE_AT steps, a
    checkpoint through the trainer's `save_checkpoint` (the store's
    files, in the reference's layout), a new model's
    `restore_checkpoint`, and the steps to 2 * TRAIN_SAVE_AT again: the
    resumed losses equal the uninterrupted ones at TRAIN_F32."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.train import (make_train_step,
                                          restore_checkpoint,
                                          save_checkpoint)
    from repro_torch.models import Model
    from repro_torch.training import optimizer as opt
    t0 = time.perf_counter()
    cfg = get_smoke_config("llama3-8b")
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      global_batch=4, seed=0))
    batches = [next(data) for _ in range(2 * TRAIN_SAVE_AT)]
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=min(20, len(batches)),
                           total_steps=len(batches))

    def run(model, state, part):
        step, losses = make_train_step(model, ocfg), []
        for batch in part:
            state, loss, _ = step(state, batch)
            losses.append(loss.item())
        return state, losses
    zero_launches(kernels)
    model = Model(cfg, device="cuda", seed=0)
    _, whole = run(model, opt.init_state(dict(model.named_parameters())),
                   batches)
    model = Model(cfg, device="cuda", seed=0)
    state, head = run(model, opt.init_state(dict(
        model.named_parameters())), batches[:TRAIN_SAVE_AT])
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        save_checkpoint(ckpt, TRAIN_SAVE_AT, model, state)
        size = sum(f.stat().st_size for f in Path(ckpt).rglob("*.npz"))
        model = Model(cfg, device="cuda", seed=1)
        state = restore_checkpoint(ckpt, model, opt.init_state(dict(
            model.named_parameters())))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    _, tail = run(model, state, batches[TRAIN_SAVE_AT:])
    err = max(rel(a, b) for a, b in zip(head + tail, whole))
    log(f"[train] smoke Llama on the card, {len(whole)} steps, a "
        f"checkpoint through the store at step {TRAIN_SAVE_AT} ({size:,} "
        f"bytes) restored into a new model: losses {whole[0]:.4f} -> "
        f"{whole[-1]:.4f}, resumed run's max relative diff {err:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    _check_launches("[train] smoke Llama", read_launches(kernels),
                    {k.name: 0 for k in kernels})
    for a, b in zip(head + tail, whole):
        if abs(a - b) > TRAIN_F32["atol"] + TRAIN_F32["rtol"] * abs(b):
            raise AssertionError(f"[train] the run resumed through the "
                                 f"store left the uninterrupted one: "
                                 f"{a} != {b}")


def _noise_floor(torch, model, batch, loss, gnorm):
    """The relative moves of the bfloat16 step-1 `loss` and `gnorm` when
    every weight is perturbed by NOISE_REL relative Gaussian noise (one
    draw per TRAIN_NOISE_SEEDS seed); the weights are put back after."""
    from repro_torch.training.optimizer import global_norm
    params = list(model.parameters())
    kept = [p.detach().clone() for p in params]
    d_loss, d_gnorm = 0.0, 0.0
    for seed in TRAIN_NOISE_SEEDS:
        gen = torch.Generator("cuda").manual_seed(seed)
        with torch.no_grad():
            for p in params:
                noise = torch.randn(p.shape, generator=gen, device="cuda")
                p.copy_((p.float() * (1 + NOISE_REL * noise)).to(p.dtype))
                del noise
        noisy, grads = _loss_and_grads(torch, model, batch)
        d_loss = max(d_loss, rel(noisy.item(), loss))
        d_gnorm = max(d_gnorm, rel(global_norm(grads).item(), gnorm))
        del grads
        with torch.no_grad():
            for p, k in zip(params, kept):
                p.copy_(k)
    del kept
    torch.cuda.empty_cache()
    return d_loss, d_gnorm


def phase_train(torch, np, kernels):
    """Phase 11: the smoke models' float32 hold (`train_f32_hold`), then
    Llama-3-8B at full width with TRAIN_LAYERS layers trained through
    `make_train_step`: the loss must fall, a checkpoint restored at
    TRAIN_SAVE_AT must run on to the same losses, the bfloat16 step 1
    must stay within its noise floors against float32 (the grad norm's
    with TRAIN_GRAD_BIAS), and no kernel may
    launch (the training forward is the plain math, as in the
    reference). Returns the launches of the full-width run."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.train import (checkpoint_trees,
                                          load_checkpoint_trees,
                                          make_train_step)
    from repro_torch.models import Model
    from repro_torch.training import optimizer as opt
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    train_f32_hold(torch, np, kernels)
    train_store_resume(torch, np, kernels)
    tag = "[train-llama3-8b]"
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              num_layers=TRAIN_LAYERS)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH, seed=0))
    batches = [{"tokens": torch.as_tensor(next(data)["tokens"],
                                          device="cuda")}
               for _ in range(TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{tag} {cfg.num_layers} of the config's 32 layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, FFN "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}: {n_params:,} "
        f"parameters initialised in {time.perf_counter() - t0:.2f} s; "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    zero_launches(kernels)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=min(20, TRAIN_STEPS),
                           total_steps=TRAIN_STEPS)
    state = opt.init_state(dict(model.named_parameters()))
    train_step = make_train_step(model, ocfg)
    losses, gnorms, step_s = [], [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss, metrics = train_step(state, batch)
        losses.append(loss.item())
        gnorms.append(metrics["grad_norm"].item())
        step_s.append(time.perf_counter() - t0)
        if i + 1 == TRAIN_SAVE_AT:
            t0 = time.perf_counter()
            trees = checkpoint_trees(model, state)
            save_s = time.perf_counter() - t0
            size = sum(t.numel() * t.element_size() for t in (
                *model.parameters(), *state.mu.values(), *state.nu.values()))
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    state = load_checkpoint_trees(model, state, *trees)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del trees
    resumed, resumed_g = [], []
    for batch in batches[TRAIN_SAVE_AT:]:
        state, loss, metrics = train_step(state, batch)
        resumed.append(loss.item())
        resumed_g.append(metrics["grad_norm"].item())
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    step_ms = sorted(step_s[1:])[len(step_s[1:]) // 2] * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"{tag} {TRAIN_STEPS} steps: losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; grad norms "
        f"{' '.join(f'{x:.3f}' for x in gnorms)}")
    log(f"{tag} step {step_ms:.1f} ms (median of steps 2 to "
        f"{TRAIN_STEPS}; the first {step_s[0] * 1e3:.1f} ms), "
        f"{tokens / step_ms * 1e3:,.0f} tok/s, peak device memory "
        f"{peak / 1e9:.2f} GB; the checkpoint's trees of step "
        f"{TRAIN_SAVE_AT} ({size / 1e9:.2f} GB, host memory) taken in "
        f"{save_s:.1f} s, put back in {restore_s:.1f} s; card: {smi}")
    _check_launches(tag, launches, {name: 0 for name in launches})
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last < first:
        raise AssertionError(f"{tag} the loss did not fall: mean of the "
                             f"first 5 steps {first:.4f}, of the last 5 "
                             f"{last:.4f}")
    resume_err = max(
        max(rel(a, b) for a, b in zip(resumed, losses[TRAIN_SAVE_AT:])),
        max(rel(a, b) for a, b in zip(resumed_g, gnorms[TRAIN_SAVE_AT:])))
    log(f"{tag} loss fell: mean of the first 5 steps {first:.4f}, of the "
        f"last 5 {last:.4f}; resumed from step {TRAIN_SAVE_AT}: losses "
        f"{' '.join(f'{x:.4f}' for x in resumed)}, max relative diff of "
        f"loss and grad norm from the uninterrupted run {resume_err:.3e}")
    for a, b in zip(resumed + resumed_g,
                    losses[TRAIN_SAVE_AT:] + gnorms[TRAIN_SAVE_AT:]):
        if abs(a - b) > TRAIN_F32["atol"] + TRAIN_F32["rtol"] * abs(b):
            raise AssertionError(f"{tag} the resumed run left the "
                                 f"uninterrupted one: {a} != {b}")
    # the bfloat16 step 1 against float32, within its noise floor
    del train_step, state, metrics
    gc.collect()
    torch.cuda.empty_cache()
    model.requires_grad_(False)
    t0 = time.perf_counter()
    model.load_state_dict(Model(cfg, device="cuda", seed=0).state_dict())
    floor = _noise_floor(torch, model, batches[0], losses[0], gnorms[0])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    f32 = Model(dataclasses.replace(cfg, dtype="float32"), device="cuda",
                seed=0)
    with torch.no_grad():       # the bfloat16 weights, exactly
        for p in f32.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    loss32, grads = _loss_and_grads(torch, f32, batches[0])
    gnorm32 = opt.global_norm(grads).item()
    del f32, grads
    gc.collect()
    torch.cuda.empty_cache()
    d_loss, d_gnorm = rel(losses[0], loss32.item()), rel(gnorms[0], gnorm32)
    log(f"{tag} bfloat16 step 1 vs float32 on the same weights: loss "
        f"{losses[0]:.6f} vs {loss32.item():.6f} (relative {d_loss:.3e}, "
        f"noise floor {floor[0]:.3e}), grad norm {gnorms[0]:.5f} vs "
        f"{gnorm32:.5f} ({d_gnorm:.3e}, floor {floor[1]:.3e} + bias "
        f"{TRAIN_GRAD_BIAS:.3e}) ({time.perf_counter() - t0:.1f} s)")
    if not (d_loss <= floor[0] and d_gnorm <= floor[1] + TRAIN_GRAD_BIAS):
        raise AssertionError(f"{tag} bfloat16 step 1 leaves its noise "
                             f"floor")
    log(f"[train] phase in {time.perf_counter() - t_phase:.1f} s")
    return launches


def _dist_tokens(torch, cfg):
    """DIST_BATCH prompts of DIST_PROMPT tokens (seed DIST_SEED)."""
    gen = torch.Generator(device="cpu").manual_seed(DIST_SEED)
    return torch.randint(0, cfg.vocab_size, (DIST_BATCH, DIST_PROMPT),
                         generator=gen).to("cuda")


def _dist_plain(torch, model, tokens):
    """The plain model's prefill and DIST_STEPS greedy decode steps:
    (logits of each step, the tokens fed, the cache)."""
    logits, cache = model.prefill(tokens, DIST_MAX_LEN, use_kernel=False)
    out, fed = [logits], []
    for _ in range(DIST_STEPS):
        token = logits[:, -1:].argmax(-1)
        fed.append(token)
        logits, cache = model.decode_step(cache, token, use_kernel=False)
        out.append(logits)
    return out, fed, cache


def _card_cost(torch, step, own):
    """`step()`'s FLOPs by `FlopCounterMode`, its peak device memory from
    `reset_peak_memory_stats` and the median of 5 timed runs (ms), on the
    card. `own`: the bytes of the step's resident arguments (params,
    inputs, cache); what else is resident ("other": what earlier phases
    still hold) is taken off the peak ("step_peak")."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        step()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"flops": counter.get_total_flops(), "peak": peak,
            "resident": resident, "other": resident - own,
            "step_peak": peak - (resident - own), "ms": sorted(times)[2]}


def _rates(torch):
    """A bf16 GEMM's rate (GEMM_N cubed) and a device-to-device copy's
    (COPY_BYTES), measured with CUDA events: FLOP/s, bytes/s (read plus
    written)."""
    a = torch.randn(GEMM_N, GEMM_N, device="cuda", dtype=torch.bfloat16)
    b = torch.randn_like(a)
    gemm_ms = eager_ms(lambda: a @ b, calls=20, trials=5)
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = eager_ms(lambda: dst.copy_(src), calls=20, trials=5)
    return 2 * GEMM_N ** 3 / (gemm_ms * 1e-3), \
        2 * COPY_BYTES / (copy_ms * 1e-3)


def phase_distributed(torch, np, kernels):
    """Phase 12: the distribution layer (`repro_torch.distributed`,
    `launch/mesh.py`, `launch/dryrun.py`). (a) The dry run's CLI for
    llama3-8b x decode_32k on both meshes in a child process, which must
    pass; (b) Llama-3-8B at full width over `make_host_mesh()` by
    `param_specs` and `cache_specs`, its prefill and decode logits equal
    to the plain model's; (c) the dry run's per-device cost of that
    prefill and of one decode step on a (1, 1) mesh against the card's
    FLOPs (equal) and peak memory (within DIST_PEAK_RTOL), beside the
    step's time and roofline terms; (d) no process group left. No kernel
    launches on the path (`use_kernel=False`, as the dry run). Returns
    the launches."""
    import gc

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import Model
    from repro_torch.models.config import InputShape
    tag = "[distributed]"
    t_phase = time.perf_counter()

    def dry_run(*args):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=str(
                Path(__file__).resolve().parent / "src")))
    child = dry_run("--arch", "llama3-8b", "--shape", "decode_32k",
                    "--mesh", "both")
    f3 = [dry_run("--arch", ",".join(archs), "--shape", shape, "--mesh",
                  "both", "--layers", str(DIST_F3_LAYERS))
          for archs, shape in ((DIST_F3_TRAIN, "train_4k"),
                               (DIST_F3_DECODE, "decode_32k"))]
    try:
        cfg = get_config("llama3-8b")
        gc.collect()
        torch.cuda.empty_cache()
        model = Model(cfg, device="cuda", seed=0)
        tokens = _dist_tokens(torch, cfg)
        zero_launches(kernels)
        # (c) on the card first, on the plain model: the prefill, then one
        # decode step at pos DIST_PROMPT (it rewrites the same cache row
        # each time it runs)
        params = sum(_nbytes(p) for p in model.parameters())
        prefill = _card_cost(torch, lambda: model.prefill(
            tokens, DIST_MAX_LEN, use_kernel=False),
            params + _nbytes(tokens))
        _, cache = model.prefill(tokens, DIST_MAX_LEN, use_kernel=False)
        token = tokens[:, -1:]
        decode = _card_cost(torch, lambda: model.decode_step(
            cache, token, use_kernel=False),
            params + _nbytes(token) + sum(map(_nbytes, tree_tensors(cache))))
        del cache
        # (b) the plain path, then the same model laid out on the mesh
        plain, fed, cache = _dist_plain(torch, model, tokens)
        del cache
        t0 = time.perf_counter()
        mesh = mesh_lib.make_host_mesh()
        try:
            shd.distribute(model, mesh, shd.param_specs(model, mesh))
            toks = shd.distribute({"t": tokens}, mesh,
                                  {"t": shd.P("data", None)})["t"]
            logits, cache = model.prefill(toks, DIST_MAX_LEN,
                                          use_kernel=False)
            spread = [logits]
            for token in fed:
                tok = shd.distribute({"t": token}, mesh,
                                     {"t": shd.P("data", None)})["t"]
                logits, cache = model.decode_step(cache, tok,
                                                  use_kernel=False)
                spread.append(logits)
            torch.cuda.synchronize()
            layouts = sorted({str(t.placements) for t in tree_tensors(cache)
                              if hasattr(t, "placements")})
            spread = [t.full_tensor() for t in spread]
            dt_s = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
        launches = read_launches(kernels)
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(spread, plain))
        equal = all(torch.equal(a, b) for a, b in zip(spread, plain))
        log(f"{tag} llama3-8b at full width over make_host_mesh() (1 x 1, "
            f"nccl): prefill of {DIST_BATCH} x {DIST_PROMPT} tokens into "
            f"{DIST_MAX_LEN} and {DIST_STEPS} decode steps on DTensors in "
            f"{dt_s:.2f} s; cache layouts {layouts}; logits against the "
            f"plain model: {'equal bit for bit' if equal else 'DIFFER'} "
            f"(max |diff| {diff:.3e}, {len(plain)} steps)")
        if not equal:
            raise AssertionError(f"{tag} the one-rank DTensor model's "
                                 f"logits differ from the plain model's")
        del model, cache, spread, plain, logits
        gc.collect()
        torch.cuda.empty_cache()
        # (c) the dry run's count of the same steps on a fake (1, 1) mesh
        with dryrun.fake_group(1):
            fake = mesh_lib.init_device_mesh(
                "cuda", (1, 1), mesh_dim_names=mesh_lib.SINGLE_POD[1])
            pred_prefill = dryrun.step_cost(
                "llama3-8b", InputShape("smoke-prefill", DIST_PROMPT,
                                        DIST_BATCH, "prefill"),
                fake, cfg, max_len=DIST_MAX_LEN)
            pred_decode = dryrun.step_cost(
                "llama3-8b", InputShape("smoke-decode", DIST_MAX_LEN,
                                        DIST_BATCH, "decode"), fake, cfg)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        gemm, copy = _rates(torch)
        log(f"{tag} card: {smi}; launch/mesh.py: bf16 "
            f"{mesh_lib.PEAK_BF16_FLOPS:.3e} FLOP/s, HBM "
            f"{mesh_lib.HBM_BW:.3e} B/s, link {mesh_lib.LINK_BW:.3e} B/s; "
            f"measured: bf16 GEMM {GEMM_N}^3 {gemm:.3e} FLOP/s, "
            f"device-to-device copy {copy:.3e} B/s (read + written)")
        bad = []
        for name, card, pred in (("prefill", prefill, pred_prefill),
                                 ("decode", decode, pred_decode)):
            terms = {"compute": pred["flops"] / mesh_lib.PEAK_BF16_FLOPS,
                     "memory": pred["bytes"] / mesh_lib.HBM_BW,
                     "collective": pred["coll"]["total"] / mesh_lib.LINK_BW}
            bound = max(terms.values())
            peak_err = rel(pred["peak_bytes"], card["step_peak"])
            same = "equal" if pred["flops"] == card["flops"] else "DIFFER"
            log(f"{tag} {name}: FLOPs dry run {pred['flops']:.6e}, card "
                f"{card['flops']:.6e} ({same}); "
                f"peak dry run {pred['peak_bytes'] / 1e9:.4f} GB "
                f"(arguments {pred['argument_bytes'] / 1e9:.4f}, "
                f"temporaries {pred['temp_bytes'] / 1e9:.4f}), card "
                f"{card['step_peak'] / 1e9:.4f} GB (max_memory_allocated "
                f"{card['peak'] / 1e9:.4f} less {card['other'] / 1e9:.4f} "
                f"that earlier phases hold; relative {peak_err:.4f}); "
                f"bytes accessed {pred['bytes']:.4e}, "
                f"collectives {pred['coll']['total']:.0f} B; step "
                f"{card['ms']:.3f} ms against roofline terms "
                f"compute {terms['compute'] * 1e3:.3f} / memory "
                f"{terms['memory'] * 1e3:.3f} / collective "
                f"{terms['collective'] * 1e3:.3f} ms: "
                f"{bound * 1e3 / card['ms']:.3f} of the bound")
            if pred["flops"] != card["flops"]:
                bad.append(f"{name} FLOPs")
            if peak_err > DIST_PEAK_RTOL:
                bad.append(f"{name} peak")
        if bad:
            raise AssertionError(f"{tag} the dry run's cost misses the "
                                 f"card's: {', '.join(bad)}")
        _check_launches(tag, launches, {name: 0 for name in launches})
        out, _ = child.communicate(timeout=DIST_CLI_S)
        wall = time.perf_counter() - t_phase
        f3_out = [proc.communicate(timeout=DIST_F3_BUDGET_S)[0]
                  for proc in f3]
        f3_wall = time.perf_counter() - t_phase
    finally:
        for proc in (child, *f3):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if dist.is_initialized():
            dist.destroy_process_group()

    def passed(proc, text, what):
        for line in text.splitlines():
            if line.startswith(("OK", "FAIL", "ALL")):
                log(f"{tag} {what}: {line}")
        if proc.returncode != 0 or "ALL DRY-RUNS PASSED" not in text \
                or "2x16x16" not in text:
            raise AssertionError(f"{tag} the {what} failed (exit "
                                 f"{proc.returncode}):\n{text[-3000:]}")
    passed(child, out, "dry run")
    log(f"[distributed] phase in {wall:.1f} s (budget {DIST_BUDGET_S:.0f})")
    if wall > DIST_BUDGET_S:
        raise AssertionError(f"{tag} the phase took {wall:.1f} s, over its "
                             f"budget of {DIST_BUDGET_S:.0f} s")
    for proc, text in zip(f3, f3_out):
        passed(proc, text, f"F3 dry run ({DIST_F3_LAYERS} layers)")
    log(f"{tag} F3 set on torch {torch.__version__}: "
        f"{len(DIST_F3_TRAIN)} x train_4k and {len(DIST_F3_DECODE)} x "
        f"decode_32k on both meshes at {DIST_F3_LAYERS} layers passed in "
        f"{f3_wall:.1f} s (budget {DIST_F3_BUDGET_S:.0f}; card: {smi})")
    if f3_wall > DIST_F3_BUDGET_S:
        raise AssertionError(f"{tag} the F3 dry run took {f3_wall:.1f} s, "
                             f"over its budget of {DIST_F3_BUDGET_S:.0f} s")
    return launches


#: runs an example as `__main__` in a child process, then prints the
#: launch counts of the port's kernels in that process on a line of its own
_EXAMPLE_RUNNER = """
import json, runpy, sys
path, *argv = sys.argv[1:]
sys.argv = [path, *argv]
runpy.run_path(path, run_name="__main__")
from repro_torch.kernels.aging_update.ops import KERNEL as A
from repro_torch.kernels.decode_attention.ops import KERNEL as D
from repro_torch.kernels.flash_attention.ops import KERNEL as F
from repro_torch.kernels.ssd_scan.ops import KERNEL as S
print("[launches] " + json.dumps({k.name: k.launches for k in (A, F, D, S)}))
"""


def _run_example(tag, script, args, timeout):
    """`examples_torch/<script>.py args` in a child process: (its output
    without the launch line, its kernels' launch counts, its wall s)."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _EXAMPLE_RUNNER,
         str(root / "examples_torch" / f"{script}.py"), *args],
        capture_output=True, text=True, timeout=timeout, cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{tag} {script}.py {' '.join(args)} failed "
                             f"(exit {proc.returncode}):\n"
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    launches = json.loads(lines[-1].removeprefix("[launches] "))
    return "\n".join(lines[:-1]) + "\n", launches, wall


def _example_lines(stdout, directory, spec):
    """The report lines as `tests/test_torch_examples_data.py` writes
    them: `directory` as `<DIR>`, fingerprints as `<FP>`, the lines of
    `spec["drop"]`'s patterns left out."""
    stdout = re.sub(*spec["fingerprint"], stdout.replace(directory, "<DIR>"))
    return [ln for ln in stdout.splitlines()
            if not any(re.search(p, ln) for p in spec["drop"])]


def _hold_lines(tag, script, got, spec):
    want = spec["scripts"][script]["lines"]
    if spec["scripts"][script].get("tail"):
        got = got[-len(want):]
    same = got == want
    log(f"{tag} {script}: {len(want)} report lines "
        f"{'equal to the reference' if same else 'DIFFER from the reference'}")
    if not same:
        diff = [f"  got  {a!r}\n  want {b!r}" for a, b in zip(got, want)
                if a != b][:5]
        raise AssertionError(f"{tag} {script}'s report lines differ from "
                             f"{EXAMPLES_EXPECTED} ({len(got)} against "
                             f"{len(want)} lines):\n" + "\n".join(diff))


def _train_log(tag, script, out, min_fall):
    """The (step, loss, tok/s) of the trainer's log lines; the loss at the
    last must be below the first by more than `min_fall`, and finite."""
    rows = [(int(f[1]), float(f[3]), float(f[9].replace(",", "")))
            for f in (ln.split() for ln in out.splitlines())
            if f and f[0] == "step" and len(f) == 10]
    if len(rows) < 2 or not rows[0][1] - rows[-1][1] > min_fall:
        raise AssertionError(f"{tag} {script}: the loss did not fall by "
                             f"more than {min_fall} ({rows}):\n"
                             f"{out[-2000:]}")
    return rows


def phase_examples(torch, np):
    """Phase 13: the scripts of `examples_torch/` in child processes
    (`_run_example`): the host reports held line for line against the
    reference's (EXAMPLES_EXPECTED), the serving demo's kernel launches
    on the card and its sweeps' lines, the training example's loss and
    its launches (none). The host reports run beside the card's scripts,
    in a thread of their own. Returns the serving demo's launches."""
    import concurrent.futures
    import statistics

    from repro_torch.configs import get_smoke_config
    tag = "[examples]"
    root = Path(__file__).resolve().parent
    spec = json.loads((root / EXAMPLES_EXPECTED).read_text())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t_phase = time.perf_counter()
    walls = {}

    def host_reports(tmp):
        tel = os.path.join(tmp, "telemetry")
        for script, args in (("quickstart", []),
                             ("carbon_report", ["--telemetry", tel])):
            out, _, walls[script] = _run_example(tag, script, args, 600)
            _hold_lines(tag, script, _example_lines(out, tel, spec), spec)
        (export,) = Path(tel).glob("proposed-*")
        out, _, walls["telemetry_report"] = _run_example(
            tag, "telemetry_report", [str(export)], 300)
        _hold_lines(tag, "telemetry_report",
                    _example_lines(out, tel, spec), spec)

    def on_the_card(tmp):
        out, served, walls["serve_cluster"] = _run_example(
            tag, "serve_cluster", [], 600)
        _hold_lines(tag, "serve_cluster", _example_lines(out, tmp, spec),
                    spec)
        layers = get_smoke_config("llama3-8b").num_layers
        rate = next(ln for ln in out.splitlines()
                    if ln.startswith("12 requests x 12 tokens"))
        log(f"{tag} serve_cluster demo: {rate}; launches {served}")
        if served["flash_attention"] != layers * 12 \
                or served["decode_attention"] \
                != layers * EXAMPLES_DEMO_DECODE_STEPS \
                or served["aging_update"] or served["ssd_scan"]:
            raise AssertionError(f"{tag} the serving demo did not run "
                                 f"through the attention kernels as "
                                 f"expected: {served}")
        for name, extra, min_fall in (
                ("train_small", [], EXAMPLES_TRAIN_MIN_FALL),
                ("train_small --big", ["--big"], 0.0)):
            out, trained, walls[name] = _run_example(
                tag, "train_small",
                ["--steps", str(EXAMPLES_TRAIN_STEPS), "--ckpt-dir",
                 os.path.join(tmp, name.replace(" ", "")), *extra], 600)
            rows = _train_log(tag, name, out, min_fall)
            params = next(ln for ln in out.splitlines()
                          if ln.startswith("arch="))
            step_ms = [8 * 128 / r * 1e3 for _, _, r in rows[1:]]
            log(f"{tag} {name}: {params}; loss {rows[0][1]:.4f} at step "
                f"{rows[0][0]} -> {rows[-1][1]:.4f} at step {rows[-1][0]}; "
                f"step {statistics.median(step_ms):.2f} ms (median of the "
                f"log lines after the first); launches {trained}")
            if any(trained.values()):
                raise AssertionError(f"{tag} {name} launched a kernel: "
                                     f"{trained}")
        return served

    tmp = tempfile.mkdtemp(prefix="examples-")
    try:
        # leaving the pool waits for the host reports, whatever happened
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            host = pool.submit(host_reports, tmp)
            served = on_the_card(tmp)
            host.result()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    log(f"{tag} walls: " + ", ".join(f"{k} {v:.1f} s"
                                    for k, v in walls.items())
        + f"; card: {smi}")
    log(f"{tag} phase in {wall:.1f} s (budget {EXAMPLES_BUDGET_S:.0f})")
    if wall > EXAMPLES_BUDGET_S:
        raise AssertionError(f"{tag} the phase took {wall:.1f} s, over its "
                             f"budget of {EXAMPLES_BUDGET_S:.0f} s")
    return served


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def tree_tensors(tree):
    """The tensors in a nested dict (a cache)."""
    for val in tree.values():
        if isinstance(val, dict):
            yield from tree_tensors(val)
        elif val is not None and hasattr(val, "shape"):
            yield val


def absorbed_run(torch, kernels, serve):
    """Phase 7's `after`: the same model and requests served again with
    `mla_absorb=True` for ABSORB_NEW_TOKENS tokens each: the prefill goes
    through B2 as before, the decode attends against the latent in plain
    PyTorch (no B3 launch); its tokens are printed beside the default
    run's."""
    import dataclasses

    from repro_torch.serving.engine import InferenceEngine

    def run(model, prompts, tokens, tag):
        cfg = model.cfg
        model.cfg = dataclasses.replace(cfg, mla_absorb=True)
        try:
            eng = InferenceEngine(
                model, max_batch=serve["max_batch"],
                max_len=serve["max_len"], policy=serve["policy"],
                num_host_cores=serve["host_cores"])
            zero_launches(kernels)
            t0 = time.perf_counter()
            reqs = []
            for prompt in prompts:
                eng.submit(prompt, max_new_tokens=ABSORB_NEW_TOKENS)
                reqs.append(eng.pending[-1])
            eng.run_until_drained()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches(kernels)
            del eng
        finally:
            model.cfg = cfg
        want = {"aging_update": 0, "ssd_scan": 0, "decode_attention": 0,
                "flash_attention": cfg.num_layers * serve["requests"]}
        same = sum(a == b for req, toks in zip(reqs, tokens)
                   for a, b in zip(req.output, toks))
        new = serve["requests"] * ABSORB_NEW_TOKENS
        log(f"{tag} mla_absorb=True: {serve['requests']} requests, "
            f"{ABSORB_NEW_TOKENS} new each: wall {wall:.3f} s "
            f"({new / wall:.1f} tok/s); launches {launches} (expected "
            f"{want}); tokens equal to the default run's at {same} of "
            f"{new} positions")
        for req, toks in zip(reqs, tokens):
            log(f"{tag}   absorbed {req.output} | default "
                f"{toks[:ABSORB_NEW_TOKENS]}")
        if launches != want:
            raise AssertionError(f"the absorbed decode did not run as "
                                 f"expected: {launches} != {want}")
        if any(len(r.output) != ABSORB_NEW_TOKENS for r in reqs) or any(
                not 0 <= t < cfg.vocab_size for r in reqs for t in r.output):
            raise AssertionError("an absorbed request did not get its "
                                 "tokens")
    return run


def main() -> int:
    t_start = time.perf_counter()
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        return fail(f"no src/repro_torch beside {Path(__file__).name}")
    import torch
    if not torch.cuda.is_available():
        return fail("CUDA is not available; this smoke needs an NVIDIA GPU")
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch.core.aging import DEFAULT_PARAMS
    from repro_torch.kernels._build import CudaKernel
    from repro_torch.kernels.aging_update.ops import KERNEL as AGING
    from repro_torch.kernels.decode_attention.ops import KERNEL as DECODE
    from repro_torch.kernels.flash_attention.ops import KERNEL as FLASH
    from repro_torch.kernels.ssd_scan.ops import KERNEL as SSD

    # an empty kernel, for the launch floor beside the aging kernel's time
    floor = CudaKernel("launch_floor",
                       src.parent / "benchmarks_torch" / "launch_floor.cu",
                       "empty_launch",
                       [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p])
    every = (AGING, FLASH, DECODE, SSD)
    phase_environment(torch, (*every, floor))
    aging_row = phase_aging_kernel(torch, np, DEFAULT_PARAMS, floor)
    attention_rows = phase_attention_kernels(torch, np)
    ssd_rows = phase_ssd_kernel(torch, np)
    launches, reqs, fleet_res, fleet_wall = phase_fleet(torch, (AGING,))
    event, event_res, event_card = phase_event(torch, np, every, floor)
    by_path = {"fleet-200x1h": launches["aging_update"],
               "event-22x120s": event["aging_update"],
               **phase_faults(torch, every, reqs),
               **phase_telemetry(torch, np, every, reqs, fleet_res,
                                 fleet_wall, event_res, event_card)}
    del reqs

    def dense(cfg, iterations):
        return {"aging_update": 0, "ssd_scan": 0,
                "flash_attention": cfg.num_layers * SERVE["requests"],
                "decode_attention": cfg.num_layers * iterations}

    def ssm(cfg, iterations):
        return {"aging_update": 0, "flash_attention": 0,
                "decode_attention": 0,
                "ssd_scan": cfg.num_layers * SERVE_MAMBA["requests"]}
    attention_by_path = {"flash_attention": {}, "decode_attention": {}}
    for serve, after in ((SERVE, None), (SERVE_MOE, None),
                         (SERVE_MLA, absorbed_run(torch, every, SERVE_MLA))):
        served = phase_serve(torch, np, serve, every, dense, after)
        for name, paths in attention_by_path.items():
            paths[f"serve-{serve['arch']}"] = served[name]
    served = phase_serve(torch, np, SERVE_MAMBA, every, ssm)
    ssd_by_path = {"serve-mamba2-2.7b": served["ssd_scan"]}

    def hybrid(cfg, steps):
        uses = cfg.num_hybrid_groups
        return {"aging_update": 0,
                "ssd_scan": cfg.num_layers * SERVE_HYBRID["requests"],
                "flash_attention": uses * SERVE_HYBRID["requests"],
                "decode_attention": uses * steps}

    def encdec(cfg, steps):
        return {"aging_update": 0, "ssd_scan": 0,
                "flash_attention": (cfg.encoder_layers + cfg.num_layers)
                * SERVE_ENCDEC["requests"],
                "flash_attention/noncausal": cfg.encoder_layers
                * SERVE_ENCDEC["requests"],
                "decode_attention": cfg.num_layers * steps}
    served = phase_direct(torch, np, SERVE_HYBRID, every, hybrid)
    ssd_by_path["zamba2-7b"] = served["ssd_scan"]
    for name, paths in attention_by_path.items():
        paths["zamba2-7b"] = served[name]
    served, patches = phase_vlm(torch, np, SERVE_VLM, every, dense)
    for name, paths in attention_by_path.items():
        paths["serve-internvl2-2b"] = served[name]
        paths["internvl2-2b-patches"] = patches[name]
    served = phase_direct(torch, np, SERVE_ENCDEC, every, encdec,
                          frame_seed=FRAME_SEED)
    bidirectional = served["flash_attention/noncausal"]
    for name, paths in attention_by_path.items():
        paths["seamless-m4t-large-v2"] = served[name]
    trained = phase_train(torch, np, every)
    by_path["train-llama3-8b"] = trained["aging_update"]
    ssd_by_path["train-llama3-8b"] = trained["ssd_scan"]
    for name, paths in attention_by_path.items():
        paths["train-llama3-8b"] = trained[name]
    spread = phase_distributed(torch, np, every)
    by_path["distributed-llama3-8b"] = spread["aging_update"]
    ssd_by_path["distributed-llama3-8b"] = spread["ssd_scan"]
    for name, paths in attention_by_path.items():
        paths["distributed-llama3-8b"] = spread[name]
    served = phase_examples(torch, np)
    for name, paths in attention_by_path.items():
        paths["example-serve-cluster"] = served[name]
    launches["aging_update"] = sum(by_path.values())
    for name, paths in attention_by_path.items():
        launches[name] = sum(paths.values())
    launches["ssd_scan"] = sum(ssd_by_path.values())
    src_dir = "src/repro_torch/kernels"
    kernels = [
        dict({"name": "aging_update", "route": "cuda",
              "source": f"{src_dir}/aging_update/aging_update.cu",
              "replaces": "src/repro/kernels/aging_update/aging_update.py:41",
              "launches": launches["aging_update"],
              "launches_by_path": by_path, "library_ms": None},
             **aging_row),
        dict({"name": "flash_attention", "route": "cuda",
              "source": f"{src_dir}/flash_attention/flash_attention.cu",
              "replaces":
                  "src/repro/kernels/flash_attention/flash_attention.py:72",
              "launches": launches["flash_attention"],
              "launches_by_path": attention_by_path["flash_attention"],
              "mla": dict(attention_rows["flash_attention/mla"],
                          launches=attention_by_path["flash_attention"][
                              "serve-minicpm3-4b"]),
              "zamba2": dict(attention_rows["flash_attention/zamba2"],
                             launches=attention_by_path["flash_attention"][
                                 "zamba2-7b"]),
              # the seamless path's noncausal launches, counted apart
              "encoder": dict(attention_rows["flash_attention/encoder"],
                              launches=bidirectional)},
             **attention_rows["flash_attention"]),
        dict({"name": "decode_attention", "route": "cuda",
              "source": f"{src_dir}/decode_attention/decode_attention.cu",
              "replaces":
                  "src/repro/kernels/decode_attention/decode_attention.py:71",
              "launches": launches["decode_attention"],
              "launches_by_path": attention_by_path["decode_attention"],
              "mla": dict(attention_rows["decode_attention/mla"],
                          launches=attention_by_path["decode_attention"][
                              "serve-minicpm3-4b"]),
              "zamba2": dict(attention_rows["decode_attention/zamba2"],
                             launches=attention_by_path["decode_attention"][
                                 "zamba2-7b"])},
             **attention_rows["decode_attention"]),
        dict({"name": "ssd_scan", "route": "cuda",
              "source": f"{src_dir}/ssd_scan/ssd_scan.cu",
              "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:64",
              "launches": launches["ssd_scan"],
              "launches_by_path": ssd_by_path,
              "zamba2": dict(ssd_rows["ssd_scan/zamba2"],
                             launches=ssd_by_path["zamba2-7b"])},
             **ssd_rows["ssd_scan"]),
    ]
    log(f"[smoke] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
