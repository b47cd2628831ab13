"""Host time of `InferenceEngine.step()` less the model calls (issue and
wait) and the core manager's calls inside it, per step (traced run)."""


def read(rec):
    t = rec.trace
    if t is None or not rec.steps:
        return None
    return 1e3 * (t.step_s - t.model_s - t.cm_in_step_s) / rec.steps
