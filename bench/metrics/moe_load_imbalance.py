"""The routed experts' load: the sum over the program's dropless MoE calls
of the most-loaded expert's rows, times the routed experts, over the sum
of their routed rows (`repro_torch.models.moe.counters()`, read once after
the run; the whole process, set-up included). 1.0 is an even load; None
where the program keeps no such counters or routed nothing."""


def read(rec):
    try:
        from repro_torch.models import moe
    except ImportError:
        return None
    counters = getattr(moe, "counters", None)
    experts = rec.cell.config.get("n_routed_experts")
    if counters is None or not experts:
        return None
    c = counters()
    if not c.get("routed_rows"):
        return None
    return c["largest_expert_rows"] * experts / c["routed_rows"]
