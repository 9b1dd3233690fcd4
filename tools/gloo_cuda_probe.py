#!/usr/bin/env python3
"""Do gloo's collectives carry CUDA tensors when ranks share one card, and
does NCCL refuse two ranks on one card?  On one GPU:

    python3 tools/gloo_cuda_probe.py

Starts four gloo ranks on ``cuda:0`` (a ``file://`` store in a temp dir)
and checks the collectives the port's mesh uses on CUDA tensors: an int64
``all_reduce`` (``sharded_check``), an ``all_gather`` of (4097, 8) int32
limbs (``sharded_matvec``, ``sharded_msm``), an ``all_gather`` on a
two-rank sub-group (``make_mesh(2)``) and a barrier; times a (3, 8)
``all_gather`` and an int64 ``all_reduce`` (mean of 20).  Then two NCCL
ranks on ``cuda:0`` try the first two collectives.  Prints the versions,
the card's name and power limit, then each rank's results as one
``PROBE`` JSON line (a collective that raised shows its error).  Every
rank is killed at its time limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time


def rank(k: int, n: int, store: str, backend: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=n, rank=k)
    res = {"rank": k, "backend": backend}

    def attempt(name, fn):
        try:
            res[name] = fn()
        except Exception as e:  # a refused collective is the finding: record it
            res[name] = "ERR " + repr(e)[:300]

    def all_reduce():
        c = torch.tensor([k + 1], dtype=torch.int64, device=dev)
        dist.all_reduce(c)
        return int(c.item()) == n * (n + 1) // 2 and c.is_cuda

    def all_gather(group=None, size=n, rows=4097):
        part = torch.full((rows, 8), k, dtype=torch.int32, device=dev)
        parts = [torch.empty_like(part) for _ in range(size)]
        dist.all_gather(parts, part, group=group)
        return all(bool((p == j).all()) and p.is_cuda for j, p in enumerate(parts))

    attempt("all_reduce_int64", all_reduce)
    attempt("all_gather_int32", all_gather)
    if backend == "gloo":
        g = dist.new_group([0, 1])  # made by every rank
        if k < 2:
            attempt("subgroup_all_gather", lambda: all_gather(g, 2, 3))
        attempt("barrier", lambda: dist.barrier() or True)
        one = torch.zeros((3, 8), dtype=torch.int32, device=dev)
        outs = [torch.empty_like(one) for _ in range(n)]
        dist.all_gather(outs, one)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            dist.all_gather(outs, one)
        torch.cuda.synchronize()
        res["all_gather_point_ms"] = (time.perf_counter() - t0) * 1e3 / 20
        cnt = torch.ones(1, dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        for _ in range(20):
            dist.all_reduce(cnt)
        torch.cuda.synchronize()
        res["all_reduce_int64_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    print("PROBE " + json.dumps(res), flush=True)
    dist.destroy_process_group()


def launch(n: int, backend: str, timeout: float) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "rank", str(k), str(n), store, backend],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for k in range(n)]
        deadline = time.monotonic() + timeout
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += "\n(killed at the time limit)"
            outs.append((p.returncode, out))
        for k, (rc, out) in enumerate(outs):
            print(f"--- {backend} n={n} rank {k} rc={rc}")
            print("\n".join(out.splitlines()[-12:]), flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gloo_cuda_probe: torch.cuda.is_available() is False")
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count(), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    launch(4, "gloo", 180)
    launch(2, "nccl", 90)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "rank":
        rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        main()
