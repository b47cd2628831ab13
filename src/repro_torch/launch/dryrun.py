"""Multi-pod dry run: lay out every (architecture x input shape) on the
production meshes and run its step over DTensors, proving the
distribution config is coherent without hardware, and count the roofline
terms per device (the counterpart of `repro.launch.dryrun`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun

It computes on no device. Parameters, optimizer state, caches and inputs
are DTensors whose local shards are `meta` tensors, on a mesh over a fake
process group of the mesh's size (256 ranks for (16, 16), 512 for (2, 16,
16)), started for each run and destroyed after it; this process is rank 0.
The mesh is a "cuda" mesh, so DTensor picks the collectives it would
issue on the cards. The step then runs as it would on rank 0: each op
runs on the local shards and each redistribution issues its collective,
which the fake group completes without moving anything.

`CostCounter`, one dispatch mode over the local ops only, counts per
device: FLOPs (`torch.utils.flop_counter`'s formulas), bytes accessed
(each op's input bytes plus output bytes: the eager port's traffic, where
the reference counts XLA's after fusion), the collectives' result bytes
(`hlo_analysis.CollectiveLog`) and the peak of live temporaries.
DTensor's sharding propagation, which runs ops on fake tensors at global
shapes, is not counted.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import os
import time
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ALIASES, all_arch_names
from repro_torch.distributed import hlo_analysis
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.train import make_train_step
from repro_torch.models import INPUT_SHAPES, Model
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.training import optimizer as opt_lib


def resolve_config(arch: str, shape_name: str,
                   variant: str = "baseline") -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ALIASES[arch]}")
    cfg = mod.LONG_CONTEXT if shape_name == "long_500k" else mod.FULL
    if variant == "optimized":
        # beyond-paper §Perf knobs: chunked online-softmax attention,
        # absorbed MLA decode, sequence-parallel residuals, ZeRO-1
        # optimizer sharding, pinned decode caches, ring SWA caches
        cfg = dataclasses.replace(cfg, attn_chunk=2048, mla_absorb=True,
                                  seq_parallel=True, zero1=True,
                                  pin_cache_sharding=True, swa_ring=True)
    return cfg


def front_len(cfg: ModelConfig, shape: InputShape) -> int:
    if cfg.frontend == "none":
        return 0
    if cfg.family == "vlm":
        return cfg.frontend_tokens
    # audio: encoder frames scale with the sequence, bounded for decode
    if shape.kind == "decode":
        return min(shape.seq_len // 4, 4096)
    return shape.seq_len // 4


def abstract_cache(model: Model, cfg: ModelConfig, shape: InputShape
                   ) -> dict:
    """The decode cache of this step as `meta` tensors: what a prefill of
    seq_len - 1 tokens (VLM prompts embed their patches inside that
    budget) into a cache of seq_len leaves, "pos" included; the
    encoder-decoder's cross cache over its `front_len` frames."""
    n_front = front_len(cfg, shape)
    cache = model.empty_cache(shape.global_batch, shape.seq_len,
                              n_front if cfg.is_encdec else None)
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=model.device)
    return cache


def _meta(mesh, shape, dtype, spec):
    return shd.distribute({"x": torch.empty(shape, dtype=dtype,
                                            device="meta")},
                          mesh, {"x": spec})["x"]


def _shape(shape_name) -> InputShape:
    """An entry of INPUT_SHAPES by name, or an `InputShape` itself (a
    caller's own step, as the smoke's)."""
    if isinstance(shape_name, InputShape):
        return shape_name
    return INPUT_SHAPES[shape_name]


def input_specs(arch: str, shape_name, mesh=None, cfg=None) -> dict:
    """Every model input of this step as a `meta` DTensor on `mesh`:
    tokens (and embeds) with the batch over the batch axes, or the decode
    token and the cache by `cache_specs`. Allocates nothing."""
    shape = _shape(shape_name)
    cfg = cfg or resolve_config(arch, shape.name)
    mesh = mesh or mesh_lib.make_production_mesh()
    b, s = shape.global_batch, shape.seq_len
    b_ax = shd.dim_spec(mesh, b, shd.batch_axes(mesh))
    tok_spec = shd.P(b_ax, None)
    n_front = front_len(cfg, shape)
    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        s_text = s - (n_front if cfg.family == "vlm" else 0)
        inputs = {"tokens": _meta(mesh, (b, s_text), torch.int32, tok_spec)}
        if n_front:
            inputs["embeds"] = _meta(mesh, (b, n_front, cfg.d_model),
                                     torch.float32, shd.P(b_ax, None, None))
        if shape.kind == "train":
            specs["batch"] = inputs
        else:
            specs.update(inputs)
    else:  # decode: one token + cache of seq_len
        specs["token"] = _meta(mesh, (b, 1), torch.int32, tok_spec)
        cache = abstract_cache(Model(cfg, device="meta"), cfg, shape)
        specs["cache"] = shd.distribute(cache, mesh,
                                        shd.cache_specs(cfg, cache, mesh))
    return specs


def _zero1_spec(abs_leaf, spec, mesh):
    """ZeRO-1 (§Perf): additionally shard optimizer moments over the
    data axis on the first dim the model axis doesn't already occupy."""
    dax = "data"
    sizes = shd.mesh_axes(mesh)
    if dax not in sizes:
        return spec
    size = sizes[dax]
    dims = list(spec)
    for i, (d, ax) in enumerate(zip(abs_leaf.shape, dims)):
        if ax is None and d % size == 0:
            dims[i] = dax
            break
    return shd.P(*dims)


def build_step(arch: str, shape_name, mesh, cfg=None,
               max_len: int | None = None):
    """(step_fn, args, model): the model laid out on `mesh` by
    `param_specs` (which `step_fn` holds: the reference passes the params
    as its step's first argument), and the step's other arguments as
    `meta` DTensors. train: `make_train_step`'s step of `loss`, its backward
    pass and AdamW, over (AdamWState, batch); prefill: `Model.prefill`
    into a cache of seq_len; decode: `Model.decode_step` on (cache,
    token). Every attention takes its plain version (`use_kernel=False`),
    as the reference's dry run lowers its jnp model. `shape_name` may be
    an `InputShape`; `max_len` (default seq_len) is the prefill's cache
    length."""
    shape = _shape(shape_name)
    cfg = cfg or resolve_config(arch, shape.name)
    model = Model(cfg, device="meta")
    pspecs = shd.param_specs(model, mesh)
    shd.distribute(model, mesh, pspecs)
    specs = input_specs(arch, shape_name, mesh, cfg)

    if shape.kind == "train":
        ocfg = opt_lib.AdamWConfig()
        opt_abs = opt_lib.init_state(model.abstract_params())
        mspec = ({n: _zero1_spec(opt_abs.mu[n], s, mesh)
                  for n, s in pspecs.items()} if cfg.zero1 else pspecs)
        opt_in = opt_lib.AdamWState(
            step=shd.distribute({"step": opt_abs.step}, mesh,
                                {"step": shd.P()})["step"],
            mu=shd.distribute(opt_abs.mu, mesh, mspec),
            nu=shd.distribute(opt_abs.nu, mesh, mspec))
        train_step = make_train_step(model, ocfg)

        def step(opt_state, batch):
            with shd.implicit_replication():
                return train_step(opt_state, batch)
        return step, (opt_in, specs["batch"]), model

    if shape.kind == "prefill":
        def prefill_step(tokens, embeds=None):
            return model.prefill(tokens, max_len=max_len or shape.seq_len,
                                 embeds=embeds, use_kernel=False)
        return prefill_step, (specs["tokens"],
                              *([specs["embeds"]] if "embeds" in specs
                                else [])), model

    def serve_step(cache, token):
        return model.decode_step(cache, token, use_kernel=False)
    return serve_step, (specs["cache"], specs["token"]), model


def local_bytes(tree) -> int:
    """Bytes of the local shards of the tensors in `tree` (on this rank)."""
    local = [t.to_local() if isinstance(t, DTensor) else t
             for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in local)


def _returns_alias(func) -> bool:
    """Whether the op's outputs alias an input (a view, or an in-place or
    out= op returning what it wrote into)."""
    return any(r.alias_info is not None for r in func._schema.returns)


_NO_TRAFFIC = {"aten.empty", "aten.empty_strided", "aten.empty_like",
               "aten._unsafe_view", "_c10d_functional.wait_tensor",
               "_c10d_functional._wrap_tensor_autograd"}


class CostCounter(hlo_analysis.CollectiveLog):
    """The dry run's one counting mode, over the local ops of a step.

    Ops on DTensors pass through to DTensor (which runs the local ops this
    mode then sees); ops on fake tensors are DTensor's sharding
    propagation at global shapes, and are not counted. For the rest:
      * `flops`: `flop_registry[op](*args, **kwargs, out_val=out)` for the
        ops it has a formula for (products, convolutions, attention);
      * `bytes`: input bytes plus output bytes of each op that is not a
        view and not an allocation of uninitialised memory;
      * `peak`: the most bytes held at once by storages that ops made
        while the mode was on (temporaries and the step's new outputs),
        each counted from the op that made it until it is freed;
      * the collectives, as `CollectiveLog`.
    The same step counted twice gives the same numbers: nothing depends
    on DTensor's caches."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, weakref.ref] = {}

    def _freed(self, key: int, nbytes: int) -> None:
        self._storages.pop(key, None)
        self.live -= nbytes

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            nbytes = st.nbytes()
            self._storages[key] = weakref.ref(
                st, lambda _, key=key, n=nbytes: self._freed(key, n))
            self.live += nbytes
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if any(isinstance(t, DTensor) for t in ins):
            return NotImplemented
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out
        self._log(func, out)
        if func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        name = hlo_analysis._op_name(func)
        if not _returns_alias(func) or func._schema.is_mutable:
            if name not in _NO_TRAFFIC:
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in ins + outs)
        if not _returns_alias(func):
            self._track(outs)
        return out


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake default process group of `world_size` ranks, this process
    rank 0, destroyed on exit: collectives complete at once and move
    nothing. Refuses to start beside a running default group."""
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts a fake process group of its "
                           "own; a default group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def step_cost(arch: str, shape_name, mesh, cfg=None,
              max_len: int | None = None) -> dict:
    """Build the step (`build_step`), run it once under a `CostCounter`
    and return its per-device cost: "flops", "bytes" (accessed), "coll"
    (the collectives' dict), "argument_bytes" (the local shards of the
    params and the step's arguments), "output_bytes", "temp_bytes" (the
    peak of what the step allocated) and "peak_bytes" (arguments plus
    temporaries, the reference's peak)."""
    return _cost_of(*build_step(arch, shape_name, mesh, cfg, max_len))


def _cost_of(step_fn, args, model) -> dict:
    arg_bytes = local_bytes(args) + local_bytes(list(model.parameters()))
    with CostCounter() as counter:
        out = step_fn(*args)
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "coll": counter.as_dict(), "argument_bytes": arg_bytes,
            "output_bytes": local_bytes(out), "temp_bytes": counter.peak,
            "peak_bytes": arg_bytes + counter.peak}


def _measure(arch, shape_name, mesh, cfg) -> dict:
    """The per-device cost of the step of `cfg` at its depth."""
    return step_cost(arch, shape_name, mesh, cfg)


def _coll_comb(a, b, fa=1.0, fb=1.0):
    keys = set(a) | set(b)
    return {k: max(0.0, fa * a.get(k, 0) + fb * b.get(k, 0)) for k in keys}


def _extrapolated_cost(arch, shape_name, mesh, cfg) -> dict:
    """The reference's layer-accurate cost from reduced depths: count
    variants of 2 and 4 layers (the hybrid: 1 and 2 groups; the
    encoder-decoder: 2 and 4 layers on each side) and extrapolate the
    per-layer marginal cost linearly, exact for layer-homogeneous stacks.
    The port can count the full depth directly (`run_one`'s own count);
    this keeps the reference's method, so the records compare."""
    if cfg.is_encdec:
        base = _measure(arch, shape_name, mesh, dataclasses.replace(
            cfg, num_layers=2, encoder_layers=2))
        d_enc = _measure(arch, shape_name, mesh, dataclasses.replace(
            cfg, num_layers=2, encoder_layers=4))
        d_dec = _measure(arch, shape_name, mesh, dataclasses.replace(
            cfg, num_layers=4, encoder_layers=2))
        n_e, n_d = cfg.encoder_layers - 2, cfg.num_layers - 2
        out = {}
        for k in ("flops", "bytes"):
            se = (d_enc[k] - base[k]) / 2
            sd = (d_dec[k] - base[k]) / 2
            out[k] = base[k] + se * n_e + sd * n_d
        ce = _coll_comb(d_enc["coll"], base["coll"], 0.5, -0.5)
        cd = _coll_comb(d_dec["coll"], base["coll"], 0.5, -0.5)
        coll = _coll_comb(base["coll"], _coll_comb(ce, cd, n_e, n_d))
        out["coll"] = coll
        return out
    if cfg.family == "hybrid":
        per, rem = cfg.hybrid_period, cfg.hybrid_remainder
        l1, l2 = per + rem, 2 * per + rem          # 1 and 2 groups
        steps = float(cfg.num_hybrid_groups - 1)   # extra groups beyond l1
    else:
        l1, l2 = 2, 4
        steps = (cfg.num_layers - l1) / (l2 - l1)  # extra (l2-l1) blocks
    c1 = _measure(arch, shape_name, mesh,
                  dataclasses.replace(cfg, num_layers=l1))
    c2 = _measure(arch, shape_name, mesh,
                  dataclasses.replace(cfg, num_layers=l2))
    out = {k: c1[k] + (c2[k] - c1[k]) * steps for k in ("flops", "bytes")}
    dcoll = _coll_comb(c2["coll"], c1["coll"], 1.0, -1.0)
    out["coll"] = _coll_comb(c1["coll"], dcoll, 1.0, steps)
    return out


def run_one(arch: str, shape_name: str, multi_pod: bool,
            unrolled_cost: bool = True, variant: str = "baseline") -> dict:
    """Dry-run one (arch x shape x mesh) in a fake process group of the
    mesh's size, started here and destroyed before returning.

    `lower_s` is the time to lay out the model and build the distributed
    inputs, `compile_s` that plus running the step at full depth, which
    gives the memory accounting (arguments, outputs, the peak of
    temporaries) and a direct count of the cost. With `unrolled_cost`, on
    the single-pod mesh, the cost is the reference's extrapolation from
    reduced depths (`_extrapolated_cost`, timed in `unrolled_compile_s`)
    instead, as the reference's records give it."""
    shape = INPUT_SHAPES[shape_name]
    with fake_group(512 if multi_pod else 256):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        chips = mesh.size()
        cfg = resolve_config(arch, shape_name, variant)
        t0 = time.time()
        built = build_step(arch, shape_name, mesh, cfg)
        t_lower = time.time() - t0
        cost = _cost_of(*built)
        del built
        t_compile = time.time() - t0
        flops_dev, bytes_dev, coll = cost["flops"], cost["bytes"], \
            cost["coll"]
        t_unroll = 0.0
        if unrolled_cost and not multi_pod:
            tu = time.time()
            est = _extrapolated_cost(arch, shape_name, mesh, cfg)
            flops_dev, bytes_dev, coll = est["flops"], est["bytes"], \
                est["coll"]
            t_unroll = time.time() - tu

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_active = cfg.active_param_count()
    mult = 3 if shape.kind == "train" else 1  # fwd+bwd ~ 3x fwd
    model_flops = 2.0 * n_active * tokens * mult
    rec = {
        "arch": arch,
        "shape": shape_name,
        "variant": ("optimized" if (cfg.attn_chunk or cfg.mla_absorb
                                    or cfg.seq_parallel or cfg.zero1)
                    else "baseline"),
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "unrolled_compile_s": round(t_unroll, 2),
        "per_device": {
            "argument_bytes": cost["argument_bytes"],
            "output_bytes": cost["output_bytes"],
            "temp_bytes": cost["temp_bytes"],
            "peak_bytes": cost["peak_bytes"],
            "flops": flops_dev,
            "bytes_accessed": bytes_dev,
            "collective_bytes": coll.get("total", 0),
        },
        "collectives": {k: v for k, v in coll.items() if k != "total"},
        "roofline_s": {
            "compute": flops_dev / mesh_lib.PEAK_BF16_FLOPS,
            "memory": bytes_dev / mesh_lib.HBM_BW,
            "collective": coll.get("total", 0) / mesh_lib.LINK_BW,
        },
        "model_flops_global": model_flops,
        "useful_flops_ratio": (model_flops / (flops_dev * chips)
                               if flops_dev else 0.0),
        "params": cfg.param_count(),
        "active_params": n_active,
    }
    terms = rec["roofline_s"]
    rec["bottleneck"] = max(terms, key=terms.get)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default=None, help="JSON output directory")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "optimized"])
    args = ap.parse_args(argv)

    archs = all_arch_names() if args.all or not args.arch else [args.arch]
    shapes = (list(INPUT_SHAPES) if args.all or not args.shape
              else [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                tag = (f"{arch} x {shape_name} x "
                       f"{'2x16x16' if multi else '16x16'}")
                try:
                    rec = run_one(arch, shape_name, multi,
                                  variant=args.variant)
                except Exception as e:  # noqa: BLE001 — report and continue
                    failures.append((tag, repr(e)))
                    print(f"FAIL  {tag}: {e}", flush=True)
                    continue
                pd = rec["per_device"]
                print(f"OK    {tag}: compile={rec['compile_s']}s "
                      f"peak={pd['peak_bytes']/1e9:.2f}GB "
                      f"flops/dev={pd['flops']:.3e} "
                      f"coll/dev={pd['collective_bytes']/1e6:.1f}MB "
                      f"bottleneck={rec['bottleneck']}", flush=True)
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    suffix = ("_opt" if args.variant == "optimized"
                              else "")
                    fn = (f"{arch}_{shape_name}_{rec['mesh']}{suffix}.json"
                          .replace("/", "_"))
                    with open(os.path.join(args.out, fn), "w") as f:
                        json.dump(rec, f, indent=1)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        raise SystemExit(1)
    print("\nALL DRY-RUNS PASSED")


if __name__ == "__main__":
    main()
