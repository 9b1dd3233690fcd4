"""The share of the augmented syntheses' witness elements that arrived in
blocks (the native emitters' buffers, the bit decompositions) and not one at
a time: the port's counter ``ELEMENTS`` of ``r1cs/witness.py``, process-wide
and never reset, so over every synthesis of the run (set-up, warm-up and the
window).  None where the program has no such counter."""


def read(obs):
    from vdf_tpu_torch.r1cs import witness

    counts = getattr(witness, "ELEMENTS", None)
    if not obs.get("ivc") or counts is None:
        return None
    total = counts["block"] + counts["single"]
    return counts["block"] / total if total else None
