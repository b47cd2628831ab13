"""95th percentile, over every request sent in the window, of the time
from its send to its first token; one without a first token when the
window closed counts as infinite."""
import math

from bench.stats import percentile


def read(rec):
    ttft = [(r.first - r.sent) if r.first is not None else math.inf
            for r in rec.window_requests()]
    return 1e3 * percentile(ttft, 95) if ttft else None
