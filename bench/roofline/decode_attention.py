"""B3, `kernels/decode_attention`: one launch per attention layer and
decode step. Its work over the visible rows of the active slots: the
visible K and V rows, q, the positions and the output, each once;
2 (D + Dv) operations per (query head, visible row)."""

KERNEL = "decode_attention"
NAMES = ("decode_attention",)        # parts of its device kernels' names


def work(cell, kind: str, info) -> list[tuple[float, float]]:
    """(bytes, operations) of each launch one model call makes."""
    shape = cell.family.attention_shape(cell.config)
    if kind != "decode" or shape is None or not info:
        return []
    size = 2 if cell.config["torch_dtype"] == "bfloat16" else 4
    h, hkv, d, dv = shape["heads"], shape["kv_heads"], shape["d"], shape["dv"]
    seen, b = sum(info), len(info)
    nbytes = (seen * hkv * (d + dv) + b * h * (d + dv)) * size + 4 * b
    return [(nbytes, 2.0 * (d + dv) * h * seen)] * shape["layers"]
