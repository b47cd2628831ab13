"""Host time in `CoreManager.assign`, `release` and `periodic` (from
`submit` and from `step`), per engine step (traced run)."""


def read(rec):
    t = rec.trace
    if t is None or not rec.steps:
        return None
    return 1e6 * t.cm_s / rec.steps
