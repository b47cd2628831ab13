"""PyTorch port of `repro` (aging-aware CPU core management), for one
NVIDIA H100.

The port mirrors the reference package module by module
(`repro_torch.core.aging` <-> `repro.core.aging`, ...), imports `torch`
and numpy and never `jax` or `repro`. Host-side numpy modules are copies
of the reference with only their import paths rewritten, so their
numbers stay bit-identical. Device code is plain PyTorch on tensors with
an explicit `device`; every TPU kernel of the reference on a ported path
is a kernel written by hand for Hopper (`repro_torch.kernels`).

Ported so far, two paths end to end:

    ExperimentConfig(...).with_engine("fleet", backend="torch")
      -> repro_torch.sim.run_experiment -> sim.fleetsim.FleetEngine
      -> sim.metrics.price_and_build -> ExperimentResult

with its aging settle in the CUDA kernel `kernels/aging_update`, plus the
workload, carbon, power and hardware registries it prices through; and

    python -m repro_torch.launch.serve --arch llama3-8b
      -> serving.engine.InferenceEngine (host tasks through core.CoreManager)
      -> models.Model.prefill / decode_step (dense GQA)

with prefill attention in the CUDA kernel `kernels/flash_attention` and
decode attention in `kernels/decode_attention`.
"""

__version__ = "0.1.0"
