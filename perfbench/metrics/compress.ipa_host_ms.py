"""The host part of the IPA rounds a shipped proof (ms): the
``<curve>/ipa.read`` and ``<curve>/ipa.transcript`` spans inside
``<curve>/two IPAs`` (L and R read back as affine ints; the transcript, the
challenge and its inverse), over the proofs.  None where the program opens
no such span."""

SUFFIXES = ("/ipa.read", "/ipa.transcript")


def read(obs):
    m = obs.get("compress")
    if not m or not m["proofs"]:
        return None
    parts = [v for k, v in m["spans"].items() if k.endswith(SUFFIXES)]
    return 1e3 * sum(parts) / m["proofs"] if parts else None
