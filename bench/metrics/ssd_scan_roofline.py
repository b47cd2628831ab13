"""ssd_scan's least time over the launches of the traced stretch (its
bytes and operations: bench/roofline/ssd_scan.py) over its device time
there, in %."""


def read(rec):
    return rec.roofline_share("ssd_scan")
