"""The sumchecks and the gamma-matvec a shipped proof (ms): ``ivc_compress``'s
``<curve>/outer sumcheck``, ``<curve>/inner sumcheck`` and
``<curve>/gamma-matvec`` spans (a synchronising timer), over the proofs."""

PARTS = ("/outer sumcheck", "/inner sumcheck", "/gamma-matvec")


def read(obs):
    m = obs.get("compress")
    if not m or not m["proofs"]:
        return None
    s = sum(v for k, v in m["spans"].items() if k.endswith(PARTS))
    return 1e3 * s / m["proofs"]
