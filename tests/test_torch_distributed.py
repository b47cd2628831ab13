"""The distribution layer of the port (`repro_torch.distributed`,
`repro_torch.launch.mesh`, `repro_torch.launch.dryrun`, the model's mesh
hooks) against the reference (`repro.distributed`, `repro.launch.dryrun`),
on the CPU.

- Parameter specs of all 10 archs on the reference's `FakeMesh`es, (16,
  16) and (2, 16, 16), leaf by leaf against `repro.distributed.sharding.
  param_specs` of the reference's abstract params (its stacked per-layer
  leaves carry a leading None the port's per-layer leaves do not).
- Decode caches at decode_32k: the port's `dryrun.abstract_cache` shapes
  and dtypes against the reference's `jax.eval_shape` of its prefill, key
  by key, then both packages' `cache_specs`; the spec functions on a grid
  of shapes.
- DTensor placements on fake (16, 16) and (2, 16, 16) meshes, the
  collective log and the dry run's counting mode, in this process over a
  fake process group that each test destroys.
- `collective_bytes` and `duplicate_fusion_count` against the
  reference's; the dry run's algebra (`_coll_comb`, `_zero1_spec`,
  `front_len`, `resolve_config`) against the reference's.
- `run_one("llama3-8b", "decode_32k")` on both meshes in a child: the
  reference's record keys, argument bytes from the specs, and the
  reduced-depth extrapolation equal to the full-depth count.
- Values on a (2, 2) gloo mesh of 4 spawned processes: `moe_ffn_sharded`
  and `decode_attention_length_sharded` against the plain functions, and
  a smoke Llama with `seq_parallel` and `pin_cache_sharding` against the
  plain model.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import json
import math
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as ref_get_config
from repro.distributed import hlo_analysis as ref_hlo
from repro.distributed import sharding as ref_shd
from repro.models import Model as RefModel
from repro_torch.configs import all_arch_names, get_config
from repro_torch.distributed import hlo_analysis
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import INPUT_SHAPES, Model

REPO = Path(__file__).resolve().parents[1]
ARCHS = all_arch_names()


class FakeMesh:
    """Duck-typed mesh (shape dict + axis_names), the reference tests'."""
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
MESH_POD = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = pytest.mark.parametrize("mesh", [MESH, MESH_POD],
                                 ids=["16x16", "2x16x16"])


def _ref_dryrun():
    """`repro.launch.dryrun`, imported as the reference's
    `TestCostExtrapolation` does: jax keeps its one device, and the
    XLA_FLAGS its import sets are put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return ref


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    return RefModel(ref_get_config(arch)).abstract_params()


def _ref_leaf(tree, name):
    """The reference's leaf for a port parameter name, and whether it is
    stacked on a leading layer axis."""
    group, _, rest = name.partition(".")
    stacked = group in ("layers", "enc_layers")
    node = tree[group] if stacked else tree
    if stacked:
        rest = rest.partition(".")[2]
    for key in (rest if stacked else name).split("."):
        node = node[key]
    return node, stacked


def _paths(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_paths(val, f"{prefix}{key}."))
        elif val is not None:
            out[f"{prefix}{key}"] = val
    return out


# --------------------------------------------------------------------- #
# parameter and cache specs against the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
@MESHES
def test_param_specs_equal_reference(arch, mesh):
    model = Model(get_config(arch), device="meta")
    mine = shd.param_specs(model, mesh)
    ref_abs = _ref_abstract(arch)
    theirs = ref_shd.param_specs(ref_abs, mesh)
    for name, spec in mine.items():
        ref_spec, stacked = _ref_leaf(theirs, name)
        leaf, _ = _ref_leaf(ref_abs, name)
        ref_spec = tuple(ref_spec)
        if stacked:
            assert ref_spec[0] is None, name
            ref_spec = ref_spec[1:]
            assert tuple(model.get_parameter(name).shape) == leaf.shape[1:]
        assert tuple(spec) == ref_spec, name
    # the port's names cover the reference's leaves, and no more
    mine_leaves = {n if not n.startswith(("layers.", "enc_layers."))
                   else n.split(".", 2)[0] + "." + n.split(".", 2)[2]
                   for n in mine}
    assert mine_leaves == set(_paths(ref_abs))


def test_abstract_params_are_meta():
    model = Model(get_config("llama3-8b"), device="meta")
    params = model.abstract_params()
    assert all(t.device.type == "meta" for t in params.values())
    assert sum(t.numel() for t in params.values()) == sum(
        leaf.size for leaf in jax.tree.leaves(_ref_abstract("llama3-8b")))
    small = Model(dataclasses.replace(get_config("llama3-8b"), num_layers=1,
                                      d_model=64, num_heads=4,
                                      num_kv_heads=2, head_dim=16, d_ff=128,
                                      vocab_size=100, vocab_pad_mult=128),
                  device="cpu")
    shapes = {n: (t.shape, t.dtype)
              for n, t in small.abstract_params().items()}
    assert shapes == {n: (p.shape, p.dtype)
                      for n, p in small.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_and_specs_equal_reference(arch):
    ref = _ref_dryrun()
    shape = INPUT_SHAPES["decode_32k"]
    cfg = dryrun.resolve_config(arch, "decode_32k")
    mine = dryrun.abstract_cache(Model(cfg, device="meta"), cfg, shape)
    rcfg = ref.resolve_config(arch, "decode_32k")
    theirs = ref.abstract_cache(RefModel(rcfg), rcfg,
                                ref.INPUT_SHAPES["decode_32k"])
    mine_leaves, their_leaves = _paths(mine), _paths(theirs)
    assert set(mine_leaves) == set(their_leaves)
    for key, t in mine_leaves.items():
        assert tuple(t.shape) == tuple(their_leaves[key].shape), key
        assert str(t.dtype).removeprefix("torch.") == \
            str(their_leaves[key].dtype), key
    for mesh in (MESH, MESH_POD):
        mine_specs = _paths(shd.cache_specs(cfg, mine, mesh))
        their_specs = _paths(ref_shd.cache_specs(rcfg, theirs, mesh))
        assert {k: tuple(v) for k, v in mine_specs.items()} == \
            {k: tuple(v) for k, v in their_specs.items()}


KV_SHAPES = [(32, b, s, h, 128) for b in (1, 8, 128, 100)
             for s in (4096, 4100) for h in (8, 15, 16, 32, 40)]


@pytest.mark.parametrize("shape", KV_SHAPES, ids=str)
@MESHES
def test_kv_cache_spec(shape, mesh):
    assert tuple(shd.kv_cache_spec(mesh, shape)) == \
        tuple(ref_shd.kv_cache_spec(mesh, shape))


@pytest.mark.parametrize("shape", [(62, b, s, 288) for b in (1, 16, 128, 7)
                                   for s in (32768, 32767)], ids=str)
@MESHES
def test_latent_cache_spec(shape, mesh):
    assert tuple(shd.latent_cache_spec(mesh, shape)) == \
        tuple(ref_shd.latent_cache_spec(mesh, shape))


@pytest.mark.parametrize("b,c,h", [(b, c, h) for b in (1, 32, 128)
                                   for c in (5376, 5377)
                                   for h in (8, 16, 80, 81)], ids=str)
@MESHES
def test_ssm_cache_specs(b, c, h, mesh):
    conv, state = (64, b, 3, c), (64, b, h, 64, 128)
    mine = shd.ssm_cache_specs(mesh, conv, state)
    theirs = ref_shd.ssm_cache_specs(mesh, conv, state)
    assert [tuple(s) for s in mine] == [tuple(s) for s in theirs]


@MESHES
def test_dim_spec_and_batch_axes(mesh):
    axes = [None, *mesh.axis_names, tuple(mesh.axis_names[:-1])]
    for dim in (1, 2, 15, 16, 32, 48, 256, 512, 1000, 129024):
        for ax in axes:
            assert shd.dim_spec(mesh, dim, ax) == \
                ref_shd.dim_spec(mesh, dim, ax)
            assert shd.axis_size(mesh, ax) == ref_shd.axis_size(mesh, ax)
    assert shd.batch_axes(mesh) == ref_shd.batch_axes(mesh)


# --------------------------------------------------------------------- #
# DTensor placements, collectives and the counting mode (fake group)
# --------------------------------------------------------------------- #
def _fake_mesh(world_shape):
    shape, names = world_shape
    return init_device_mesh("cuda", shape, mesh_dim_names=names)


@pytest.mark.parametrize("world", [mesh_lib.SINGLE_POD, mesh_lib.MULTI_POD],
                         ids=["16x16", "2x16x16"])
def test_placements_give_local_shards(world):
    shape, names = world
    fake = FakeMesh(dict(zip(names, shape)))
    b_ax = shd.batch_axes(fake)
    cases = [((256, 4096), shd.P(b_ax, None)),
             ((4096, 14336), shd.P(None, "model")),
             ((129024, 4096), shd.P("model", None)),
             ((8, 4096, 14336), shd.P(None, None, "model")),
             ((32, 128, 32768, 8, 128),
              shd.kv_cache_spec(fake, (32, 128, 32768, 8, 128))),
             ((32, 128, 32768, 32, 128),
              shd.kv_cache_spec(fake, (32, 128, 32768, 32, 128))),
             ((), shd.P())]
    with dryrun.fake_group(math.prod(shape)):
        mesh = _fake_mesh(world)
        for global_shape, spec in cases:
            t = shd.distribute({"x": torch.empty(global_shape,
                                                 device="meta")},
                               mesh, {"x": spec})["x"]
            want = tuple(d // shd.axis_size(fake, ax)
                         for d, ax in zip(global_shape, spec))
            assert tuple(t.shape) == global_shape
            assert tuple(t.to_local().shape) == want, spec
        # a tuple entry: Shard(0) on each of its mesh dims, in mesh order
        pl = shd.placements(shd.P(b_ax, None), mesh)
        assert [names[i] for i, p in enumerate(pl) if p == Shard(0)] == \
            list(b_ax)
        assert pl[names.index("model")] == Replicate()
        with pytest.raises(ValueError):
            shd.placements(shd.P(tuple(reversed(names)), None), mesh)
    assert not dist.is_initialized()


def test_distribute_model_keeps_values():
    """`distribute` replaces each parameter with a DTensor of the same
    values, on a (1, 1) gloo mesh; the model's `mesh` names it."""
    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=1,
                              d_model=64, num_heads=4, num_kv_heads=2,
                              head_dim=16, d_ff=128, vocab_size=100,
                              vocab_pad_mult=128, dtype="float32")
    model = Model(cfg, device="cpu", seed=0)
    before = {n: p.clone() for n, p in model.named_parameters()}
    assert model.mesh is None
    try:
        mesh = mesh_lib.make_host_mesh("cpu")
        shd.distribute(model, mesh, shd.param_specs(model, mesh))
        assert model.mesh is mesh
        for name, p in model.named_parameters():
            assert torch.equal(p.full_tensor(), before[name]), name
    finally:
        dist.destroy_process_group()


def test_collective_log_counts_result_bytes():
    x = torch.empty(64, 128, dtype=torch.bfloat16, device="meta")
    with dryrun.fake_group(256):
        mesh = _fake_mesh(mesh_lib.SINGLE_POD)
        group = (mesh, 1)
        with hlo_analysis.CollectiveLog() as log:
            outs = [funcol.all_reduce(x, "sum", group),
                    funcol.all_gather_tensor(x, 0, group),
                    funcol.reduce_scatter_tensor(x, "sum", 0, group),
                    funcol.all_to_all_single(x, None, None, group)]
            for out in outs:    # wait_tensor: not a collective
                funcol.wait_tensor(out)
    row = 128 * 2
    assert log.as_dict() == {"all-reduce": 64 * row,
                             "all-gather": 16 * 64 * row,
                             "reduce-scatter": 4 * row,
                             "all-to-all": 64 * row,
                             "total": (64 + 1024 + 4 + 64) * row,
                             "count": 4}


def test_cost_counter_counts_local_flops_once():
    """A column- then row-parallel MLP on (16, 16): exactly the local
    products' FLOPs, 2 (B/16) D (F/16) each, and the same on a second run
    (DTensor's sharding propagation, cached after the first, is not
    counted either time); the row-parallel output's all-reduce."""
    b, d, f = 256 * 16, 512, 2048
    with dryrun.fake_group(256):
        mesh = _fake_mesh(mesh_lib.SINGLE_POD)

        def meta(shape, spec):
            return shd.distribute({"x": torch.empty(
                shape, dtype=torch.bfloat16, device="meta")}, mesh,
                {"x": spec})["x"]
        w1, w2 = meta((d, f), shd.P(None, "model")), \
            meta((f, d), shd.P("model", None))
        x = meta((b, d), shd.P("data", None))
        counts = []
        for _ in range(2):
            with dryrun.CostCounter() as counter:
                y = ((x @ w1) @ w2).redistribute(mesh, [Shard(0),
                                                       Replicate()])
            counts.append((counter.flops, counter.as_dict()))
        assert tuple(y.to_local().shape) == (b // 16, d)
    per_product = 2 * (b // 16) * d * (f // 16)
    assert counts[0] == counts[1]
    assert counts[0][0] == 2 * per_product
    assert counts[0][1]["all-reduce"] == (b // 16) * d * 2


# --------------------------------------------------------------------- #
# HLO text and the dry run's algebra against the reference
# --------------------------------------------------------------------- #
HLO = """
  %all-gather.1 = bf16[4,128]{1,0} all-gather(%x), replica_groups={}
  %ar = (f32[16,16]{1,0}, f32[8]{0}) all-reduce(%a, %b), to_apply=%add
  %notacoll = f32[2]{0} add(%c, %d)
  %rs = f32[64]{0} reduce-scatter(%e), dimensions={0}
"""
HLO_DONE = ("  %ag = bf16[8]{0} all-gather-start(%x)\n"
            "  %agd = bf16[8]{0} all-gather-done(%ag)\n")


def _generated_hlo(seed: int) -> str:
    rng = np.random.default_rng(seed)
    dtypes = list(hlo_analysis.DTYPE_BYTES) + ["token"]
    ops = list(hlo_analysis.COLLECTIVE_OPS) + ["add", "fusion"]
    lines = []
    def shape():
        dims = ",".join(str(rng.integers(1, 64))
                        for _ in range(rng.integers(0, 3)))
        return f"{dtypes[rng.integers(len(dtypes))]}[{dims}]"

    for i in range(40):
        op = ops[rng.integers(len(ops))]
        shapes = ", ".join(shape() for _ in range(rng.integers(1, 3)))
        suffix = ["", "-start", "-done"][rng.integers(3)] if op in \
            hlo_analysis.COLLECTIVE_OPS else ""
        lines.append(f"  %v{i} = ({shapes}) {op}{suffix}(%p{i})")
        if rng.random() < 0.3:
            lines.append(f"  fused_computation.{rng.integers(5)} {{")
    return "\n".join(lines)


@pytest.mark.parametrize("text", [HLO, HLO_DONE, "", *map(_generated_hlo,
                                                          range(6))],
                         ids=["hlo", "done", "empty",
                              *map(str, range(6))])
def test_hlo_text_functions_equal_reference(text):
    assert hlo_analysis.collective_bytes(text) == \
        ref_hlo.collective_bytes(text)
    assert hlo_analysis.duplicate_fusion_count(text) == \
        ref_hlo.duplicate_fusion_count(text)
    assert hlo_analysis.DTYPE_BYTES == ref_hlo.DTYPE_BYTES
    assert hlo_analysis.COLLECTIVE_OPS == ref_hlo.COLLECTIVE_OPS


def test_dryrun_algebra_equals_reference():
    ref = _ref_dryrun()
    a = {"all-reduce": 10.0, "total": 10.0, "count": 3}
    b = {"all-reduce": 4.0, "all-gather": 2.0, "total": 6.0, "count": 1}
    for fa, fb in ((1.0, -1.0), (0.5, -0.5), (1.0, 15.0), (2.0, 3.0)):
        assert dryrun._coll_comb(a, b, fa, fb) == \
            ref._coll_comb(a, b, fa, fb)
    for arch in ARCHS:
        for name, shape in INPUT_SHAPES.items():
            for variant in ("baseline", "optimized"):
                mine = dryrun.resolve_config(arch, name, variant)
                theirs = ref.resolve_config(arch, name, variant)
                assert dataclasses.asdict(mine) == \
                    dataclasses.asdict(theirs)
            assert dryrun.front_len(mine, shape) == \
                ref.front_len(theirs, ref.INPUT_SHAPES[name])


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x22b",
                                  "mamba2-2.7b", "seamless-m4t-large-v2"])
@MESHES
def test_zero1_spec_equals_reference(arch, mesh):
    ref = _ref_dryrun()
    model = Model(get_config(arch), device="meta")
    specs = shd.param_specs(model, mesh)
    ref_abs = _ref_abstract(arch)
    ref_specs = ref_shd.param_specs(ref_abs, mesh)
    for name, t in model.abstract_params().items():
        leaf, stacked = _ref_leaf(ref_abs, name)
        if stacked:
            continue        # the reference's leaf has the layer axis
        assert tuple(dryrun._zero1_spec(t, specs[name], mesh)) == tuple(
            ref._zero1_spec(leaf, _ref_leaf(ref_specs, name)[0], mesh))


# --------------------------------------------------------------------- #
# run_one in a child: record, argument bytes, extrapolation
# --------------------------------------------------------------------- #
def _reference_record_keys():
    """The keys of the reference's `run_one` record, read from its
    source (its run fails under jax 0.9: ROADMAP R3)."""
    tree = ast.parse((REPO / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_one")
    rec = next(n.value for n in ast.walk(fn)
               if isinstance(n, ast.Assign)
               and isinstance(n.targets[0], ast.Name)
               and n.targets[0].id == "rec")
    keys = {k.value for k in rec.keys}
    per_device = next(v for k, v in zip(rec.keys, rec.values)
                      if k.value == "per_device")
    return keys | {"bottleneck"}, {k.value for k in per_device.keys}


RUN_ONE = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    out = {"records": [dryrun.run_one("llama3-8b", "decode_32k", multi)
                       for multi in (False, True)]}
    out["group_left"] = dist.is_initialized()
    with dryrun.fake_group(256):
        mesh = mesh_lib.make_production_mesh()
        out["direct"] = dryrun.step_cost("llama3-8b", "decode_32k", mesh)
        out["again"] = dryrun.step_cost("llama3-8b", "decode_32k", mesh)
        for arch in ("zamba2-7b", "seamless-m4t-large-v2"):
            cfg = dryrun.resolve_config(arch, "decode_32k")
            direct = dryrun.step_cost(arch, "decode_32k", mesh, cfg)
            est = dryrun._extrapolated_cost(arch, "decode_32k", mesh, cfg)
            out[arch] = {"direct": [direct["flops"], direct["bytes"],
                                    direct["coll"]["total"]],
                         "extrapolated": [est["flops"], est["bytes"],
                                          est["coll"]["total"]]}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def run_one_child():
    proc = subprocess.run([sys.executable, "-c", RUN_ONE],
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_run_one_record_has_reference_keys(run_one_child):
    keys, per_device = _reference_record_keys()
    for rec, mesh, chips in zip(run_one_child["records"],
                                ("16x16", "2x16x16"), (256, 512)):
        assert set(rec) == keys
        assert set(rec["per_device"]) == per_device
        assert (rec["mesh"], rec["chips"]) == (mesh, chips)
        assert rec["bottleneck"] in rec["roofline_s"]
        assert rec["per_device"]["peak_bytes"] == \
            rec["per_device"]["argument_bytes"] + \
            rec["per_device"]["temp_bytes"]
    assert run_one_child["group_left"] is False


def _local_bytes(shape, spec, mesh, itemsize):
    return math.prod(d // shd.axis_size(mesh, ax)
                     for d, ax in zip(shape, spec)) * itemsize


@pytest.mark.parametrize("which", [0, 1], ids=["16x16", "2x16x16"])
def test_run_one_argument_bytes_from_specs(run_one_child, which):
    mesh = (MESH, MESH_POD)[which]
    cfg = dryrun.resolve_config("llama3-8b", "decode_32k")
    shape = INPUT_SHAPES["decode_32k"]
    model = Model(cfg, device="meta")
    want = sum(_local_bytes(p.shape, spec, mesh, p.element_size())
               for (_, p), spec in zip(model.named_parameters(),
                                       shd.param_specs(model,
                                                       mesh).values()))
    cache = dryrun.abstract_cache(model, cfg, shape)
    specs = _paths(shd.cache_specs(cfg, cache, mesh))
    want += sum(_local_bytes(t.shape, specs[k], mesh, t.element_size())
                for k, t in _paths(cache).items())
    b_ax = shd.dim_spec(mesh, shape.global_batch, shd.batch_axes(mesh))
    want += _local_bytes((shape.global_batch, 1), (b_ax, None), mesh, 4)
    rec = run_one_child["records"][which]
    assert rec["per_device"]["argument_bytes"] == want


def test_extrapolation_equals_direct_count(run_one_child):
    """Llama's stack is homogeneous: the reference's extrapolation from 2
    and 4 layers equals the port's count of all 32, exactly; and a step
    counted twice counts the same."""
    rec, direct = run_one_child["records"][0], run_one_child["direct"]
    assert run_one_child["again"] == direct
    assert rec["per_device"]["flops"] == direct["flops"]
    assert rec["per_device"]["bytes_accessed"] == direct["bytes"]
    assert rec["per_device"]["collective_bytes"] == direct["coll"]["total"]
    assert {k: v for k, v in rec["collectives"].items()} == \
        {k: v for k, v in direct["coll"].items() if k != "total"}


@pytest.mark.parametrize("arch", ["zamba2-7b", "seamless-m4t-large-v2"])
def test_extrapolation_of_uneven_stacks_is_recorded(run_one_child, arch,
                                                    record_property):
    """The hybrid's groups and the encoder-decoder's two stacks are not one
    homogeneous stack: the extrapolation's relative difference from the
    direct count (FLOPs, bytes, collective bytes at decode_32k on 16 x 16)
    is recorded and printed, not held (`PERF.md` §6)."""
    got = run_one_child[arch]
    diff = [(e - d) / d for d, e in zip(got["direct"], got["extrapolated"])]
    record_property("extrapolated_minus_direct_relative", diff)
    print(f"{arch}: extrapolated - direct, relative: flops {diff[0]:.3e}, "
          f"bytes {diff[1]:.3e}, collective bytes {diff[2]:.3e}")
    assert all(d > 0 for d in got["direct"])


# --------------------------------------------------------------------- #
# values on a (2, 2) gloo mesh
# --------------------------------------------------------------------- #
GLOO = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def worker(rank, port, path):
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_smoke_config
        from repro_torch.distributed import sharding as shd
        from repro_torch.models import Model, attention as attn, moe
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=4)
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        out = {}

        def put(tree, specs):
            return shd.distribute(tree, mesh, specs)

        # the MoE FFN: batch over data, d_ff over model
        cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                                  dtype="float32")
        gen = torch.Generator().manual_seed(0)
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        params = {"router": torch.randn(d, e, generator=gen),
                  "w_gate": torch.randn(e, d, f, generator=gen) * 0.05,
                  "w_up": torch.randn(e, d, f, generator=gen) * 0.05,
                  "w_down": torch.randn(e, f, d, generator=gen) * 0.05}
        x = torch.randn(4, 16, d, generator=gen)
        y0, aux0 = moe.moe_ffn(x, params, cfg)
        specs = shd.param_specs(params, mesh)
        y1, aux1 = moe.moe_ffn_sharded(
            put({"x": x}, {"x": shd.P("data", None, None)})["x"],
            put(params, specs), cfg)
        out["moe"] = [(y1.full_tensor() - y0).abs().max().item(),
                      y0.abs().max().item(),
                      abs(aux1.full_tensor().item() - aux0.item()),
                      [str(p) for p in y1.placements]]

        # the length-sharded decode: S over model, batch over data
        b, s, h, hkv, dh = 4, 64, 8, 2, 16
        q = torch.randn(b, 1, h, dh, generator=gen)
        k = torch.randn(b, s, hkv, dh, generator=gen)
        v = torch.randn(b, s, hkv, dh, generator=gen)
        errs = []
        for pos in (torch.tensor(40), torch.tensor([1, 17, 40, 64])):
            for window in (0, 24):
                o0 = attn.decode_attention(q, k, v, pos, window,
                                           use_kernel=False)
                t = put({"q": q, "k": k, "v": v},
                        {"q": shd.P("data", None, None, None),
                         "k": shd.P("data", "model", None, None),
                         "v": shd.P("data", "model", None, None)})
                o1 = attn.decode_attention_length_sharded(
                    t["q"], t["k"], t["v"], pos, window)
                errs.append((o1.full_tensor() - o0).abs().max().item())
        out["length_sharded"] = errs

        # a smoke Llama (1 KV head, so the cache is length-sharded) with
        # seq_parallel and pin_cache_sharding, prefill and 3 decode steps
        cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                                  dtype="float32", num_kv_heads=1,
                                  seq_parallel=True, pin_cache_sharding=True)
        model = Model(cfg, device="cpu", seed=0)
        tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
        logits, cache = model.prefill(tokens, 40, use_kernel=False)
        plain, fed = [logits], []
        for _ in range(3):
            tok = logits[:, -1:].argmax(-1)
            fed.append(tok)
            logits, cache = model.decode_step(cache, tok, use_kernel=False)
            plain.append(logits)
        loss0 = model.loss({"tokens": tokens}).item()
        shd.distribute(model, mesh, shd.param_specs(model, mesh))
        tok_spec = {"t": shd.P("data", None)}
        logits, cache = model.prefill(put({"t": tokens}, tok_spec)["t"], 40,
                                      use_kernel=False)
        spread = [logits]
        for tok in fed:
            logits, cache = model.decode_step(
                cache, put({"t": tok}, tok_spec)["t"], use_kernel=False)
            spread.append(logits)
        loss1 = model.loss({"tokens": put({"t": tokens}, tok_spec)["t"]})
        out["model"] = [max((a.full_tensor() - b).abs().max().item()
                            for a, b in zip(spread, plain)),
                        max(b[..., :cfg.vocab_size].abs().max().item()
                            for b in plain),
                        abs(loss1.full_tensor().item() - loss0),
                        sorted({str(t.placements) for key, t in cache.items()
                                if key != "pos"})]
        if rank == 0:
            with open(path, "w") as fh:
                json.dump(out, fh)
        dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(worker, args=(int(sys.argv[1]), sys.argv[2]), nprocs=4,
                 join=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_values(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    script, path = tmp / "gloo_values.py", tmp / "out.json"
    script.write_text(GLOO)
    proc = subprocess.run(
        [sys.executable, str(script), str(_free_port()), str(path)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(path.read_text())


def test_moe_ffn_sharded_equals_moe_ffn(gloo_values):
    err, scale, aux_err, placements = gloo_values["moe"]
    assert err <= 1e-6 + 1e-6 * scale, gloo_values["moe"]
    assert aux_err <= 1e-6
    assert placements == [str(Shard(0)), str(Replicate())]


def test_length_sharded_decode_equals_decode(gloo_values):
    assert max(gloo_values["length_sharded"]) <= 1e-6, gloo_values


def test_sharded_model_equals_plain(gloo_values):
    """seq_parallel and pin_cache_sharding on, 1 KV head over a `model`
    axis of 2: the cache is length-sharded and attended in place; float32
    logits and loss within 1e-5 of the plain model's (the row-parallel
    products sum their halves in another order)."""
    err, scale, loss_err, layouts = gloo_values["model"]
    assert err <= 1e-5 + 1e-5 * scale, gloo_values["model"]
    assert loss_err <= 1e-5
    assert any(repr(Shard(2)) in lay for lay in layouts), layouts
