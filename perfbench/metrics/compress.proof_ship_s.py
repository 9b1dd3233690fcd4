"""Seconds a shipped proof: the traced window's seconds, to the last
verifier's answer, over the proofs shipped.  Host-bound and as noisy as the
host (PERF.md), so no bound holds it; it stands beside ``ship_p90_ms``."""


def read(obs):
    m = obs.get("compress")
    if not m or not m["proofs"]:
        return None
    return m["window_s"] / m["proofs"]
