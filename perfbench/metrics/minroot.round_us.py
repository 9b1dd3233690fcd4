"""K1's time a round (us): the CUDA-event time of the window's segments
over the rounds they ran on a lane."""


def read(obs):
    m = obs.get("minroot")
    if not m or not m["event_s"]:
        return None
    return m["event_s"] * 1e6 / (m["segments"] * m["t"])
