"""B4, `kernels/ssd_scan`: one call (three device launches: chunk_state,
state_pass, chunk_scan) per Mamba2 layer and prefill. Its work: x read
and y written, dt, a_log, b and c read and the float32 final state
written, each once (chunk states kept between its phases are not
counted); the chunked algebra at a fixed tile of Q = 64 steps over the L
steps, with C B^T formed once for all heads: 2 L (Q N + H (Q P + 2 P N))
operations."""

KERNEL = "ssd_scan"
NAMES = ("chunk_state", "state_pass", "chunk_scan")
TILE = 64


def work(cell, kind: str, info) -> list[tuple[float, float]]:
    shape = cell.family.ssd_shape(cell.config)
    if kind != "prefill" or shape is None:
        return []
    size = 2 if cell.config["torch_dtype"] == "bfloat16" else 4
    h, p, n, l = shape["heads"], shape["p"], shape["n"], info
    nbytes = (2 * l * h * p * size + l * h * 4 + h * 4 + 2 * l * n * size
              + h * p * n * 4)
    ops = 2.0 * l * (TILE * n + h * (TILE * p + 2 * p * n))
    return [(nbytes, ops)] * shape["layers"]
