"""How evenly the interleaved prover's chains advanced (fraction): the fewest
steps any chain completed in the window over the most any did, from the
prover's ``steps`` counters.  A starved statement reads low.  None where the
program keeps no such counters."""


def read(obs):
    m = obs.get("interleave")
    if not m or not max(m["steps"], default=0):
        return None
    return min(m["steps"]) / max(m["steps"])
