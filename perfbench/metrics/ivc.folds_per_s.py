"""Steps a second (folds/s): ``prove_step``s completed in the traced window
over the seconds from its start to the last step's return.  Host-bound and
as noisy as the host (PERF.md), so no bound holds it; it stands beside
``fold_p95_ms``."""


def read(obs):
    m = obs.get("ivc")
    if not m or not m["steps"]:
        return None
    return m["steps"] / m["window_s"]
