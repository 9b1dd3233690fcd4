"""The two augmented syntheses a step (ms): the ``synthesize/*`` spans of
``RecursiveIVC``'s timer (it synchronises at each span's ends) over the
window's steps."""


def read(obs):
    m = obs.get("ivc")
    if not m or not m["steps"]:
        return None
    s = sum(v for k, v in m["spans"].items() if k.startswith("synthesize/"))
    return 1e3 * s / m["steps"]
