"""The host part of the two folds a step (ms): the ``fold.read/*``,
``fold.challenge/*`` and ``fold.instance/*`` spans inside ``fold/*`` (the
commitments read back as affine ints, the fold challenge, the instance fold
on ``IntCurve``), over the window's steps.  None where the program opens no
such span."""

PREFIXES = ("fold.read/", "fold.challenge/", "fold.instance/")


def read(obs):
    m = obs.get("ivc")
    if not m or not m["steps"]:
        return None
    parts = [v for k, v in m["spans"].items() if k.startswith(PREFIXES)]
    return 1e3 * sum(parts) / m["steps"] if parts else None
