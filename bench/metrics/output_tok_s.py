"""Output tokens the engine returned in the window over the window's
seconds (host clock; the window closes with the last step it began)."""


def read(rec):
    n = sum(sum(t >= rec.t_start for t in r.arrivals) for r in rec.requests)
    return n / rec.window_s
