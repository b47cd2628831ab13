"""Device time between CUDA events recorded around `Model.prefill`, per
1,000 prompt tokens (traced run, read after the window)."""


def read(rec):
    t = rec.trace
    if t is None or not t.prefill_ms:
        return None
    return 1e3 * sum(ms for _, ms in t.prefill_ms) / sum(
        n for n, _ in t.prefill_ms)
