"""1 - the union of the device's operation intervals over the traced
stretch (torch.profiler), in %."""


def read(rec):
    return rec.idle_share()
