"""The in-circuit Poseidon of the two augmented syntheses a step (ms): the
``synth.h_in/*``, ``synth.ro/*`` and ``synth.h_out/*`` spans inside
``synthesize/*`` (the input hash, the fold challenge, the output hash), over
the window's steps.  None where the program opens no such span."""

PREFIXES = ("synth.h_in/", "synth.ro/", "synth.h_out/")


def read(obs):
    m = obs.get("ivc")
    if not m or not m["steps"]:
        return None
    parts = [v for k, v in m["spans"].items() if k.startswith(PREFIXES)]
    return 1e3 * sum(parts) / m["steps"] if parts else None
