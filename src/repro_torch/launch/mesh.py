"""Production mesh definitions (the counterpart of `repro.launch.mesh`),
as `torch.distributed` device meshes with the reference's shapes and
axis names, and the roofline constants of the card the port runs on.

The factories are FUNCTIONS (no module-level mesh), so that importing this
module touches no process group: the dry run starts a fake group of each
mesh's size in turn, while tests and the smoke run with one rank or none.
"""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with `multi_pod`, over the default process group, which must
    hold 256 or 512 ranks (as under `torchrun`, or the dry run's fake
    group)."""
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh(device: str = "cuda") -> DeviceMesh:
    """A (1, 1) ("data", "model") mesh on one device, on the card unless
    the caller asks for "cpu". It uses the default process group when one
    is running (of one rank); else it starts one of one rank (nccl on the
    card, gloo on the CPU, at a free port of localhost), which the caller
    ends with `torch.distributed.destroy_process_group()` when done with
    the mesh."""
    device_type = torch.device(device).type
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}", world_size=1,
            rank=0)
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=SINGLE_POD[1])


# Roofline constants per device, from NVIDIA's H100 SXM5 data sheet
# (dense rates), for the card the smoke reports.
# bf16 FLOP/s on the tensor cores: NVIDIA H100 80GB HBM3, 700 W
PEAK_BF16_FLOPS = 989e12
# HBM3 bytes/s: NVIDIA H100 80GB HBM3, 700 W
HBM_BW = 3.35e12
# NVLink 4 bytes/s per GPU per direction: NVIDIA H100 80GB HBM3, 700 W.
# It holds within one node of 8 GPUs. A (16, 16) mesh's `data` axis
# crosses nodes, where each GPU's own NIC (400 Gb/s) gives about 50e9
# bytes/s, so the collective term is a lower bound for that axis.
LINK_BW = 450e9
