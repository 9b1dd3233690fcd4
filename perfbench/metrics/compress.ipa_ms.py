"""The two sides' IPA openings a shipped proof (ms): ``ivc_compress``'s
``<curve>/two IPAs`` spans (a synchronising timer), over the proofs."""


def read(obs):
    m = obs.get("compress")
    if not m or not m["proofs"]:
        return None
    s = sum(v for k, v in m["spans"].items() if k.endswith("/two IPAs"))
    return 1e3 * s / m["proofs"]
