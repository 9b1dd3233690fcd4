"""The device's idle share of the traced window (%): 1 - the union of the
device's activity intervals (kernels, copies, sets) over the window."""


def read(obs):
    tr = obs.get("trace")
    return None if tr is None else tr.idle_pct()
