"""Device time of the port's hand-written kernels a step (ms): the traced
window's intervals of K3-K7 and K10-K12 (``csrc/msm_kernels.cuh``,
``csrc/field_ops.cuh``), overlaps once, over the window's steps."""

KERNELS = ("canon_digits_kernel", "canon_mont_kernel", "scan_kernel", "scan_group_kernel",
           "colscan_tile_kernel", "colscan_rows_kernel", "colscan_carry_kernel",
           "bucket_tree_kernel", "bucket_finish_kernel", "shift_gens_kernel",
           "shift_gens_group_kernel", "field_ew_kernel", "field_segsum_kernel",
           "r1cs_matvec_kernel")


def read(obs):
    m, tr = obs.get("ivc"), obs.get("trace")
    if not m or not m["steps"] or tr is None:
        return None
    s = tr.kernel_s(KERNELS)
    return 1e3 * s / m["steps"] if s > 0 else None
