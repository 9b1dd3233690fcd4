"""K1's share of its roofline (%): the least time of the window's segments
(perfbench/work/k1.py: 32-bit multiply-adds over the H100 SXM's INT32
rate, or the state's bytes over HBM) over their CUDA-event time."""

from perfbench.work import k1


def read(obs):
    m = obs.get("minroot")
    if not m or not m["event_s"]:
        return None
    least = k1.least_seconds(m["field"], m["lanes"], m["segments"] * m["t"], m["segments"])
    return 100.0 * least / m["event_s"]
