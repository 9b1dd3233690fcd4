"""The time a chain's thread spends inside a step off the CPU (ms a step):
the interleaved prover's counters, 1e3 (sum_k wall_s[k] - sum_k cpu_s[k]) /
sum_k steps[k] over the window (``wall_s`` the summed wall time of
``prove_step``, ``cpu_s`` the thread's own CPU time inside it).  Waiting for
the GIL or blocked on the card; a wait that spins on the card counts as CPU.
None where the program keeps no such counters."""


def read(obs):
    m = obs.get("interleave")
    if not m or not sum(m["steps"]):
        return None
    return 1e3 * (sum(m["wall_s"]) - sum(m["cpu_s"])) / sum(m["steps"])
