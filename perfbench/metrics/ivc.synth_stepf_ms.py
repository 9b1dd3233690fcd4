"""The step circuit's section of the two augmented syntheses a step (ms): the
``synth.stepf/*`` spans inside ``synthesize/*`` (the selects of the step's
input, z0 at the base case, then the t MinRoot rounds on the primary and the
identity on the secondary), over the window's steps.  None where the program
opens no such span."""


def read(obs):
    m = obs.get("ivc")
    if not m or not m["steps"]:
        return None
    parts = [v for k, v in m["spans"].items() if k.startswith("synth.stepf/")]
    return 1e3 * sum(parts) / m["steps"] if parts else None
