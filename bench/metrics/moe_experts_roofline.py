"""moe_experts's least time over the launches of the traced stretch (its
bytes and operations: bench/roofline/moe_experts.py) over its device time
there, in %."""


def read(rec):
    return rec.roofline_share("moe_experts")
