#!/usr/bin/env python3
"""How far apart valid evaluations of Llama-3-8B's logits lie, on one GPU.

    python3 benchmarks_torch/logit_drift.py

The serve phase of `chip_smoke.py` holds the kernel path (the attention
kernels) against the plain path (their plain versions) on a 32-layer
model. This script measures what that comparison has to tell apart, on
one request of `chip_smoke.SERVE`'s cell (891 prompt tokens, then 31
decode steps fed with fixed tokens), at full width with random weights
from seed 0, in bfloat16 and in float32:

- kernel: the kernel path;
- plain: the plain path (float32 softmax, like the kernels);
- jnp-math: the reference's model math in PyTorch (scores and
  probabilities rounded to the model's dtype, `models.attention.attention`
  under the causal and decode masks), put in place of the model's
  attention for the run;
- perturbed: the plain path with the embedding table perturbed by
  relative Gaussian noise of 2^-9 (seed 1), below one bfloat16 rounding.

For each pair it prints the largest logit difference, the largest and
mean relative L2 distance per step, and how many greedy tokens differ;
in bfloat16 also the relative L2 distance of the hidden states between
the kernel and plain paths after each layer of the prefill. Needs CUDA;
exits 1 without it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROMPT, STEPS = 891, 31


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("logit_drift: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import NOISE_REL
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.decode_attention.ops import KERNEL as DECODE
    from repro_torch.kernels.flash_attention.ops import KERNEL as FLASH
    from repro_torch.models import Model
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import embed

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all((FLASH, DECODE))

    @contextlib.contextmanager
    def jnp_math():
        real = attn.self_attention, attn.decode_attention

        def self_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                           scale=None, chunk=0, use_kernel=True):
            mask = attn.causal_mask(q.shape[1], k.shape[1], window,
                                    q_offset, q.device)[None, None]
            return attn.attention(q, k, v, mask, scale)

        def decode_attention(q, kc, vc, pos, window=0, scale=None,
                             use_kernel=True):
            mask = attn.decode_mask(kc.shape[1], pos, window, q.device)
            return attn.attention(q, kc, vc, mask, scale)

        attn.self_attention, attn.decode_attention = (self_attention,
                                                      decode_attention)
        try:
            yield
        finally:
            attn.self_attention, attn.decode_attention = real

    rng = np.random.default_rng(0)
    cfg = get_config("llama3-8b")
    prompt = rng.integers(0, cfg.vocab_size, PROMPT).tolist()
    feed = rng.integers(0, cfg.vocab_size, STEPS).tolist()

    def logits(model, use_kernel):
        toks = torch.tensor([prompt], device="cuda")
        out, cache = model.prefill(toks, max_len=PROMPT + STEPS + 1,
                                   use_kernel=use_kernel)
        steps = [out[0, -1, :cfg.vocab_size].float()]
        for tok in feed:
            out, cache = model.decode_step(
                cache, torch.tensor([[tok]], device="cuda"),
                use_kernel=use_kernel)
            steps.append(out[0, -1, :cfg.vocab_size].float())
        return torch.stack(steps)

    def compare(name, a, b):
        d = (a - b).abs()
        rel = (a - b).norm(dim=-1) / b.norm(dim=-1)
        flips = int((a.argmax(-1) != b.argmax(-1)).sum())
        print(f"  {name}: max |d| {float(d.max()):.4e}, relative L2 max "
              f"{float(rel.max()):.4e} mean {float(rel.mean()):.4e}, greedy "
              f"tokens differing {flips}/{len(a)}")

    for dtype in ("bfloat16", "float32"):
        model = Model(dataclasses.replace(cfg, dtype=dtype), device="cuda",
                      seed=0)
        kernel, plain = logits(model, True), logits(model, False)
        with jnp_math():
            ref_math = logits(model, False)
        table = model.embed.data
        noise = torch.randn(table.shape, generator=torch.Generator(
            "cuda").manual_seed(1), device="cuda")
        model.embed.data = (table.float() * (1 + NOISE_REL * noise)).to(
            table.dtype)
        del noise
        perturbed = logits(model, False)
        model.embed.data = table
        print(f"{dtype} (logits: |max| {float(plain.abs().max()):.2f}, std "
              f"{float(plain.std()):.3f}):")
        compare("kernel vs plain", kernel, plain)
        compare("jnp-math vs plain", ref_math, plain)
        compare("kernel vs jnp-math", kernel, ref_math)
        compare("perturbed vs plain", perturbed, plain)
        if dtype == "bfloat16":
            toks = torch.tensor([prompt], device="cuda")
            positions = torch.arange(PROMPT, device="cuda")[None]
            rels = []
            with torch.no_grad():
                hk = hp = embed(toks, model.embed)
                for blk in model.layers:
                    hk = model._mlp(model._attn_full(hk, blk, positions,
                                                     True)[0], blk)
                    hp = model._mlp(model._attn_full(hp, blk, positions,
                                                     False)[0], blk)
                    rels.append(float((hk.float() - hp.float()).norm()
                                      / hp.float().norm()))
            print("  prefill hidden states, kernel vs plain, relative L2 "
                  "after each layer: "
                  + " ".join(f"{r:.1e}" for r in rels))
        del model, table
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
