"""95th percentile of every gap between consecutive output tokens of one
request whose later token came in the window (host clock, as the client
sees them: tokens returned by one step share its instant)."""
from bench.stats import percentile


def read(rec):
    gaps = [b - a for r in rec.requests
            for a, b in zip(r.arrivals, r.arrivals[1:]) if b >= rec.t_start]
    return 1e3 * percentile(gaps, 95) if gaps else None
