"""Train a small decoder on the synthetic Markov corpus until the loss
visibly drops — exercises the full substrate (data pipeline -> model ->
AdamW -> checkpointing). A ~20M-param model trains in minutes on CPU;
pass --big for a ~100M-param run.

  PYTHONPATH=src python examples_torch/train_small.py --steps 60
      [--big] [--device cpu] [--ckpt-dir DIR]

It runs `repro_torch.launch.train` with the argv of
`examples/train_small.py`, on the card unless `--device cpu` (without
CUDA it refuses rather than fall back to the CPU). The checkpoints keep
the reference's layout, so `repro.launch.train` resumes them, and this
script resumes the reference's. The default checkpoint directory is
`repro_ckpt` in the temporary directory (`/tmp/repro_ckpt`, as the
reference's, when TMPDIR is not set); a run finding a checkpoint there
resumes from it.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.launch import train as train_mod


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_ckpt"))
    args = ap.parse_args()

    argv = ["--arch", "llama3-8b", "--smoke",
            "--steps", str(args.steps), "--batch", "8", "--seq", "128",
            "--log-every", "10", "--ckpt-dir", args.ckpt_dir,
            "--device", args.device]
    if args.big:
        # ~100M params: widen the smoke config via env-free override
        import repro_torch.configs.llama3_8b as l3
        l3.SMOKE = dataclasses.replace(
            l3.SMOKE, num_layers=8, d_model=768, num_heads=12,
            num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
            vocab_pad_mult=128)
    train_mod.main(argv)


if __name__ == "__main__":
    main()
