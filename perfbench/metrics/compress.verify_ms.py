"""Reading and verifying a shipped proof (ms): the harness's spans around
``deserialize_compressed`` and ``ivc_verify_compressed``, each ended by a
synchronise, over the proofs."""


def read(obs):
    m = obs.get("compress")
    if not m or not m["proofs"]:
        return None
    s = m["spans"].get("perfbench.deserialize", 0.0) + m["spans"].get("perfbench.verify", 0.0)
    return 1e3 * s / m["proofs"]
