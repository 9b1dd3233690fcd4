"""Kernel launches a step: the port's launch counters (``fields/kernels.py``
and ``curves/kernels.py``), reset before the window, over its steps."""


def read(obs):
    m = obs.get("ivc")
    if not m or not m["steps"]:
        return None
    return sum(m["launches"].values()) / m["steps"]
