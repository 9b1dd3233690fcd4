"""The in-circuit NIFS fold of the two augmented syntheses a step (ms): the
``synth.fold/*`` spans inside ``synthesize/*`` (the instance fold with its EC
and bignat gadgets), over the window's steps.  None where the program opens
no such span."""


def read(obs):
    m = obs.get("ivc")
    if not m or not m["steps"]:
        return None
    parts = [v for k, v in m["spans"].items() if k.startswith("synth.fold/")]
    return 1e3 * sum(parts) / m["steps"] if parts else None
