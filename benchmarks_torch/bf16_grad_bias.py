#!/usr/bin/env python3
"""How far a bfloat16 training step's gradients sit from float32's on the
same weights, parameter group by parameter group.

    python3 benchmarks_torch/bf16_grad_bias.py [--layers 8] [--d-model 1024]
        [--vocab 32000] [--device cpu]

Llama-3-8B's layout (heads of 128, 4 query heads per KV head, FFN 3.5 x
d_model) at the given depth and width, random weights from seed 0 made in
bfloat16; one batch of 4 x 256 tokens of `SyntheticTokens` (seed 0).
`Model.loss` and its backward pass run once in bfloat16 and once in
float32 on the same (bfloat16-valued) weights. Prints both losses, both
global grad norms and, for each parameter group (a layer's matrices and
norms by name, summed over the layers), its share of the float32 squared
norm and how much smaller or larger its bfloat16 norm is. Runs on the
card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    d = args.d_model
    cfg = dataclasses.replace(
        get_config("llama3-8b"), num_layers=args.layers, d_model=d,
        num_heads=d // 128, num_kv_heads=max(1, d // 512), head_dim=128,
        d_ff=int(d * 3.5), vocab_size=args.vocab)
    batch = next(SyntheticTokens(DataConfig(
        vocab_size=args.vocab, seq_len=256, global_batch=4, seed=0)))
    bf16 = Model(cfg, device=args.device, seed=0)
    f32 = Model(dataclasses.replace(cfg, dtype="float32"),
                device=args.device, seed=0)
    f32.load_state_dict({n: t.float() for n, t in bf16.state_dict().items()})
    out = {}
    for name, model in (("bfloat16", bf16), ("float32", f32)):
        model.requires_grad_(True)
        loss = model.loss(batch)
        loss.backward()
        groups: dict = {}
        for pname, p in model.named_parameters():
            key = pname.split(".")[-1] if pname.startswith("layers.") \
                else pname
            groups[key] = groups.get(key, 0.0) + float(
                p.grad.float().square().sum())
        out[name] = loss.item(), groups
    (l_bf, g_bf), (l_f, g_f) = out["bfloat16"], out["float32"]
    n_bf, n_f = sum(g_bf.values()) ** 0.5, sum(g_f.values()) ** 0.5
    print(f"[bf16-grad-bias] {args.layers} layers, d_model {d}, vocab "
          f"{args.vocab}, on {args.device}: loss bf16 {l_bf:.6f} f32 "
          f"{l_f:.6f}; grad norm bf16 {n_bf:.5f} f32 {n_f:.5f} "
          f"(relative {(n_bf - n_f) / n_f:+.3e})")
    for key in sorted(g_f, key=lambda k: -g_f[k]):
        print(f"  {key:10s} share {g_f[key] / n_f ** 2:.3f}  bf16 norm / "
              f"f32 norm - 1 {(g_bf[key] / g_f[key]) ** 0.5 - 1:+.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
