"""Training entry point of the port: data pipeline -> model -> AdamW ->
checkpoints (the counterpart of `repro.launch.train`), on the card unless
`--device cpu`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --smoke --device cpu --steps 50 --batch 8 --seq 128 --ckpt-dir ckpt

Checkpoints are written in the reference's layout: params and the AdamW
state as the reference's stacked parameter tree (`params_to_jax`), through
the port's store, which keys and encodes them as the reference's store
does. Either package's trainer resumes the other's run. As in the
reference, a resumed run starts the data stream at its first batch.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import store
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import Model, params_from_jax, params_to_jax
from repro_torch.training import optimizer as opt_lib


def _like_param(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its param's layout (a pending sum reduced, a
    replicated gradient cut to the param's shard); a plain one as it is."""
    if isinstance(grad, DTensor):
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


def make_train_step(model: Model, ocfg: opt_lib.AdamWConfig):
    """A plain function (opt_state, batch) -> (opt_state, loss, metrics):
    `model.loss` and its gradients by autograd, then one `apply_updates`
    of the model's params, in place. Turns on the params' gradients. On a
    mesh each gradient is first laid out as its param."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def train_step(opt_state, batch):
        loss = model.loss(batch)
        loss.backward()
        grads = {n: _like_param(p.grad, p) for n, p in params.items()}
        _, opt_state, metrics = opt_lib.apply_updates(params, grads,
                                                      opt_state, ocfg)
        for p in params.values():
            p.grad = None
        return opt_state, loss.detach(), metrics
    return train_step


def checkpoint_trees(model: Model, opt_state: opt_lib.AdamWState):
    """(params, AdamW state) as the reference's trees: per-layer entries
    stacked (`params_to_jax`), params and moments as CPU tensors."""
    cfg = model.cfg
    return (params_to_jax(cfg, dict(model.named_parameters())),
            opt_lib.AdamWState(opt_state.step,
                               params_to_jax(cfg, opt_state.mu),
                               params_to_jax(cfg, opt_state.nu)))


def load_checkpoint_trees(model: Model, opt_state: opt_lib.AdamWState,
                          params: dict, state: opt_lib.AdamWState
                          ) -> opt_lib.AdamWState:
    """The reference's trees (`checkpoint_trees`'s, or the store's) copied
    into the model's params and `opt_state`'s moments; returns the state
    with their step."""
    cfg = model.cfg
    model.load_state_dict(params_from_jax(cfg, params))
    for mine, theirs in ((opt_state.mu, state.mu), (opt_state.nu, state.nu)):
        for name, t in params_from_jax(cfg, theirs).items():
            mine[name].copy_(t)
    return opt_lib.AdamWState(
        torch.as_tensor(state.step).to(opt_state.step.device),
        opt_state.mu, opt_state.nu)


def save_checkpoint(directory: str, step: int, model: Model,
                    opt_state: opt_lib.AdamWState,
                    extra: dict | None = None) -> str:
    """`store.save` of the model's params and `opt_state` in the
    reference's layout."""
    return store.save(directory, step, *checkpoint_trees(model, opt_state),
                      extra=extra)


def restore_checkpoint(directory: str, model: Model,
                       opt_state: opt_lib.AdamWState) -> opt_lib.AdamWState:
    """The newest checkpoint in `directory` (either package's) copied into
    the model's params and `opt_state`'s moments; returns the state with
    the restored step."""
    cfg = model.cfg

    def template(tensors: dict) -> dict:
        # the store reads only each leaf's dtype and device
        return params_to_jax(cfg, {n: torch.empty(0, dtype=t.dtype)
                                   for n, t in tensors.items()})

    params = store.restore(directory,
                           template(dict(model.named_parameters())))
    state = store.restore(directory, opt_lib.AdamWState(
        torch.zeros((), dtype=torch.int32), template(opt_state.mu),
        template(opt_state.nu)), name="opt_state.npz")
    return load_checkpoint_trees(model, opt_state, params, state)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=args.device, seed=args.seed)
    ocfg = opt_lib.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                               total_steps=args.steps)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params:,} "
          f"(analytic {cfg.param_count():,})")
    opt_state = opt_lib.init_state(dict(model.named_parameters()))
    step0 = 0
    if args.ckpt_dir and store.latest_step(args.ckpt_dir) is not None:
        step0 = store.latest_step(args.ckpt_dir)
        opt_state = restore_checkpoint(args.ckpt_dir, model, opt_state)
        print(f"restored step {step0} from {args.ckpt_dir}")

    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))
    train_step = make_train_step(model, ocfg)

    losses = []
    t0 = time.time()
    for step in range(step0, args.steps):
        batch_np = next(data)
        batch = {"tokens": torch.as_tensor(batch_np["tokens"],
                                           device=model.device)}
        if cfg.frontend != "none":
            batch["embeds"] = torch.zeros(
                (args.batch, cfg.frontend_tokens, cfg.d_model),
                dtype=torch.float32, device=model.device)
        opt_state, loss, metrics = train_step(opt_state, batch)
        losses.append(float(loss))
        if (step + 1) % args.log_every == 0:
            rate = args.batch * args.seq * args.log_every / (
                time.time() - t0)
            print(f"step {step+1:5d} loss {float(loss):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"tok/s {rate:,.0f}")
            t0 = time.time()
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1, model, opt_state,
                            extra={"loss": float(loss)})
    if losses and losses[-1] < losses[0]:
        print(f"loss improved {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print("WARNING: loss did not improve")


if __name__ == "__main__":
    main()
