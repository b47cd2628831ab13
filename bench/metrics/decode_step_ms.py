"""Mean device time between CUDA events recorded around
`Model.decode_step` (traced run, read after the window)."""


def read(rec):
    t = rec.trace
    if t is None or not t.decode_ms:
        return None
    return sum(t.decode_ms) / len(t.decode_ms)
