"""B2, `kernels/flash_attention`: one causal launch per attention layer
and prefill. Its work: q, k and v read once and the output written once;
2 (D + Dv) operations per (query head, visible key) pair, S (S + 1) / 2
pairs per head of a causal prefill of S tokens."""

KERNEL = "flash_attention"
NAMES = ("flash_attention",)


def work(cell, kind: str, info) -> list[tuple[float, float]]:
    shape = cell.family.attention_shape(cell.config)
    if kind != "prefill" or shape is None:
        return []
    size = 2 if cell.config["torch_dtype"] == "bfloat16" else 4
    h, hkv, d, dv = shape["heads"], shape["kv_heads"], shape["d"], shape["dv"]
    s = info
    nbytes = (s * h * (d + dv) + s * hkv * (d + dv)) * size
    ops = 2.0 * (d + dv) * h * s * (s + 1) / 2
    return [(nbytes, ops)] * shape["layers"]
