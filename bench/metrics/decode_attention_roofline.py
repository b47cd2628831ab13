"""decode_attention's least time over the launches of the traced stretch (its
bytes and operations: bench/roofline/decode_attention.py) over its device time
there, in %."""


def read(rec):
    return rec.roofline_share("decode_attention")
