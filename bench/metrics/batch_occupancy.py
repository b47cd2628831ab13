"""Mean active slots (`engine.active_mask`) per decode iteration (traced
run)."""


def read(rec):
    t = rec.trace
    if t is None or not t.occupancy:
        return None
    return sum(t.occupancy) / len(t.occupancy)
