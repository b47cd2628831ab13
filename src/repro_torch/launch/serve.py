"""Serving entry point of the port: continuous-batching engine + aging-aware
core manager, on the card unless `--device cpu`. `--arch` takes a dense
GQA model (llama3-8b, granite-3-8b, phi3-medium-14b), a mixture-of-experts
model (granite-moe-3b-a800m; mixtral-8x22b, which fits no single card at
full width, with `--smoke`), an MLA model (minicpm3-4b), the vision-frontend
model internvl2-2b (text only, as the reference's engine serves it) or
Mamba2 (mamba2-2.7b). The engine refuses the hybrid (zamba2-7b) and the
encoder-decoder (seamless-m4t-large-v2), as the reference's does.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      --smoke --device cpu --requests 4 --new-tokens 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import available_policies
from repro_torch.models import Model
from repro_torch.serving.engine import InferenceEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b",
                    help="a dense GQA, mixture-of-experts, MLA or "
                    "vision-frontend model, or mamba2-2.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--policy", default="proposed",
                    choices=list(available_policies()))
    ap.add_argument("--host-cores", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=args.device, seed=args.seed)
    engine = InferenceEngine(
        model, max_batch=args.max_batch, max_len=args.max_len,
        policy=args.policy, num_host_cores=args.host_cores)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for r in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              args.prompt_len).tolist()
        engine.submit(prompt, max_new_tokens=args.new_tokens)
    engine.run_until_drained()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    total_tokens = args.requests * args.new_tokens
    print(f"served {args.requests} requests / {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:,.1f} tok/s)")
    rep = engine.host_cpu_report()
    print(f"host CPU [{rep['policy']}]: cores_active={rep['active_cores']}/"
          f"{args.host_cores} cv={rep['cv']:.4f} "
          f"mean_freq_degradation={rep['mean_degradation']:.5f} "
          f"cpu_tasks={rep['assigns']}")


if __name__ == "__main__":
    main()
