"""The routed experts' grouped products (`repro_torch.models.moe.
grouped_mm`, one `torch._grouped_mm` launch per projection: gate, up,
down) in each expert layer of a model call. Its work over the k S routed
rows of a call of S tokens: 2 k S d f operations a projection; the
weights of the min(E, k S) experts the rows can reach (all E at a long
prefill) read once, and the rows read and written once: k S (d + f)
values a projection."""

KERNEL = "moe_experts"
#: parts of the names of its device kernels, as a card's trace shows them
#: (torch 2.11): CUTLASS's grouped GEMM (`GemmUniversal<GroupProblemShape
#: ...>`) and the kernel that lays out its problems before it
NAMES = ("GroupProblemShape", "prepare_grouped_gemm_data")


def work(cell, kind: str, info) -> list[tuple[float, float]]:
    """(bytes, operations) of each launch one model call makes."""
    shape_of = getattr(cell.family, "moe_shape", None)
    shape = shape_of(cell.config) if shape_of is not None else None
    tokens = info if kind == "prefill" else len(info or ())
    if shape is None or not tokens:
        return []
    size = 2 if cell.config["torch_dtype"] == "bfloat16" else 4
    e, k, d, f = shape["experts"], shape["k"], shape["d"], shape["f"]
    rows = k * tokens
    nbytes = (min(e, rows) * d * f + rows * (d + f)) * size
    return [(nbytes, 2.0 * rows * d * f)] * (3 * shape["layers"])
