"""The share of the in-circuit sponge's permutations served from the memo of
permutations the prover already ran (the host's fold challenge, the previous
output hash) and not computed again: the port's counter ``PERMS`` of
``poseidon/int_poseidon.py``, process-wide and never reset, so over every
synthesis of the run (set-up, warm-up and the window).  None where the
program has no such counter."""


def read(obs):
    from vdf_tpu_torch.poseidon import int_poseidon

    counts = getattr(int_poseidon, "PERMS", None)
    if not obs.get("ivc") or counts is None:
        return None
    total = counts["reused"] + counts["computed"]
    return counts["reused"] / total if total else None
