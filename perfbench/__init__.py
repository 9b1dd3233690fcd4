"""The benchmark of ``vdf_tpu_torch`` on an NVIDIA H100.

    python3 -m perfbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process: it loads the cell's files by name, sets the cell up
on ``cuda:0``, warms its shapes, runs the cell's closed loop for ``--seconds``,
judges what the timed path produced against the plain reference in
``perfbench/reference/``, and prints one JSON line last.  See README.md.
"""
