"""Host time in the kernel wrappers a step (ms): the port's host-time
counters (``HOST_S`` of ``fields/kernels.py`` and ``curves/kernels.py``,
each wrapper call from its entry to its return), which
``drivers/ivc_chain.py`` clears with the launch counters before the window,
over the window's steps.  Read when the window has closed, before the
cell's outputs are taken; None where the program has no such counter."""


def read(obs):
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.fields import kernels as FK

    m = obs.get("ivc")
    tables = [getattr(mod, "HOST_S", None) for mod in (FK, CK)]
    if not m or not m["steps"] or None in tables:
        return None
    return 1e3 * sum(sum(t.values()) for t in tables) / m["steps"]
