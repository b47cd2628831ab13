"""AdamW optimizer + LR schedules (the counterpart of
`repro.training.optimizer`), on tensors.

Params, grads and the two moments are dicts keyed by the `Model`'s
state-dict names (`dict(model.named_parameters())`); the moments are
float32 on each param's device. The arithmetic is the reference's, op for
op and in its dtypes: float32 `step`, `lr` and bias corrections, the
update `mhat / (sqrt(vhat) + eps)` with the decay added to it, formed in
float32 and cast back to the param's dtype. `torch.optim.AdamW` places
the decay and `eps` elsewhere, so it would round differently.

`apply_updates` writes the new params and moments into the tensors it is
given (the reference's train step donates them to `jit`), which keeps a
full-width model's optimizer within one card's memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

# state-dict prefixes of the per-layer params, which the reference stacks
# on a leading layer axis (`repro.models.Model.init`)
STACKED = ("layers.", "enc_layers.")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: dict             # first moment (fp32)
    nu: dict             # second moment (fp32)


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether AdamW decays the param `name`. The reference decays a leaf
    of rank >= 2 (matrices); its per-layer leaves carry a leading layer
    axis, so every one of them decays, norms and Mamba2's per-head
    vectors included, though the port holds them as vectors under
    `layers.<i>.` and `enc_layers.<i>.`. The hybrid's one `shared.` block
    is not stacked there and follows the plain rank rule."""
    return p.dim() >= 2 or name.startswith(STACKED)


def init_state(params: dict) -> AdamWState:
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    device = next(iter(params.values())).device if params else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros, nu={n: z.clone() for n, z in zeros.items()})


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_frac."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(grads: dict) -> torch.Tensor:
    """The float32 L2 norm of all grads together."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of `x`, in place where it
    can be, as XLA and CUDA take it. torch's vectorized CPU kernel is at
    times an ulp off; the float64 root rounded once to float32 is exact
    (double rounding is innocuous for a square root)."""
    if x.device.type == "cpu":
        return x.double().sqrt_().float()
    return x.sqrt_()


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a true division, as the reference's `max_norm / norm` (a Python
    # float over a tensor would multiply by the reciprocal)
    bound = torch.full_like(norm, max_norm)
    return torch.clamp(bound / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to a global norm of at most `max_norm`, in their
    dtypes, the norm before)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: AdamWState,
                  cfg: AdamWConfig) -> tuple[dict, AdamWState, dict]:
    """One AdamW step. Returns (new_params, new_state, metrics): `params`
    and the state's moments updated in place, a new step."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full_like(stepf, b1), stepf)
    bc2 = 1 - torch.pow(torch.full_like(stepf, b2), stepf)
    for name, p in params.items():
        g32 = (grads[name] * scale.to(grads[name].dtype)).float()
        m, v = state.mu[name], state.nu[name]
        # m = b1 * m + (1 - b1) * g; v = b2 * v + (1 - b2) * g^2
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_(g32.square_().mul_(1 - b2))
        del g32
        delta = m / bc1
        delta.div_(_sqrt(v / bc2).add_(cfg.eps))
        if decays(name, p):  # decoupled weight decay
            delta.add_(p.float() * cfg.weight_decay)
        p.copy_((p.float() - delta.mul_(lr)).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), {
        "lr": lr, "grad_norm": gnorm}
