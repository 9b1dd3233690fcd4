"""The share of the instance folds' commitment pairs (U.comm_w + r u.comm_w,
U.comm_e + r comm_T) folded in the batched native call and not on the
pure-Python IntCurve: the port's counter ``INSTANCE_FOLDS`` of
``nova/ivc.py``, process-wide and never reset, so over every fold of the run
(set-up, warm-up and the window).  None where the program has no such
counter."""


def read(obs):
    from vdf_tpu_torch.nova import ivc

    counts = getattr(ivc, "INSTANCE_FOLDS", None)
    if not obs.get("ivc") or counts is None:
        return None
    total = counts["native"] + counts["int"]
    return counts["native"] / total if total else None
