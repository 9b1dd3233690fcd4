"""One run of one cell: ``python3 -m perfbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.

1. Reads ``BENCHMARK.json`` and the cell's files (spec.py), and refuses to
   run without as many CUDA cards as the cell asks for.
2. The cell's driver (drivers/<name>.py) sets the cell up on ``cuda:0``
   and warms its shapes; set-up is timed from the harness's first
   statement to here (``setup_s``).
3. The cell's driver runs its closed loop for ``--seconds``, under the profiler
   with ``--trace 1``.  With ``--trace 0`` the result carries the cell's
   end-to-end metrics, with ``--trace 1`` its per-layer metrics
   (metrics/<name>.py each).
4. The peak device memory is read, the cell's driver copies to the host
   what the comparison needs and frees the program's state, and the
   harness refuses to go on if ``jax``, ``jaxlib``, ``flax`` or the JAX
   package is loaded.
5. The cell's driver's ``check`` holds those outputs against the plain reference
   (perfbench/reference/); each number compared is printed beside its
   limit on stderr and under ``checks``, the last key of the result.

The last line of stdout is the result.  Exit codes: 0 with a result
(``correct`` may be false); 2 without a card, or with a JAX module loaded;
1 on any other error.  No result is printed unless the exit code is 0.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "vdf_tpu")
NO_CARD = 2


class Context:
    """What a driver works with: the cell, its config and traffic
    parameters, the seed, the device, whether the run is traced, and
    ``obs``, the observations the per-layer readers read."""

    def __init__(self, cell: dict, workload: dict, config: dict, seed: int, trace: bool):
        self.cell = cell
        self.workload = workload
        self.config = config
        self.params = workload["params"]
        self.seed = seed
        self.trace = trace
        self.device = None
        self.obs: dict = {}
        self.spans = []  # trace.Spans objects whose names the trace keeps

    def span_names(self) -> set:
        return {n for s in self.spans for n in s.totals}


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name is a JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q % of the
    values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def _args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m perfbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _device_info(torch, device, chips: int) -> dict:
    if device.type != "cuda":  # the CPU tests' runs
        return {"platform": device.type, "kind": device.type, "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


def run(argv, t0: float, device=None) -> dict:
    """One run; ``device`` None is the card (the only way the command runs),
    a CPU device runs the program's plain versions for the CPU tests."""
    args = _args(argv)
    bench = spec.benchmark()
    cell = spec.find_cell(bench, args.workload)
    workload = spec.workload(cell["name"])
    for key in ("config", "traffic"):
        if workload[key] != cell[key]:
            raise spec.SpecError(f"workloads/{cell['name']}.json names {key} {workload[key]!r}, "
                                 f"BENCHMARK.json {cell[key]!r}")
    config = spec.config(cell["config"])
    drv = spec.driver(workload["driver"])
    e2e = spec.cell_metrics(bench, cell, "end_to_end")
    layer = spec.cell_metrics(bench, cell, "per_layer")
    readers = {m["name"]: spec.metric_reader(m["name"]) for m in layer} if args.trace else {}

    import torch

    chips = int(cell["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"perfbench: the cell needs {chips} CUDA card(s), this machine has {n}",
                  file=sys.stderr)
            raise SystemExit(NO_CARD)
        device = torch.device("cuda", 0)

    from . import trace as T

    ctx = Context(cell, workload, config, args.seed, bool(args.trace))
    ctx.device = torch.device(device)
    cuda = ctx.device.type == "cuda"
    drv.setup(ctx)
    drv.warm(ctx)
    if cuda:
        torch.cuda.synchronize(ctx.device)
    setup_s = time.perf_counter() - t0

    with T.profiled(ctx.trace, ctx.span_names) as held:
        e2e_values, attempted = drv.window(ctx, args.seconds)
    device = _device_info(torch, ctx.device, chips)

    metrics = {}
    if ctx.trace:
        tr = held.trace
        print(f"perfbench: the trace holds {len(tr.device)} device intervals in the window and "
              f"{len(tr.host)} host ranges", file=sys.stderr)
        ctx.obs["trace"] = tr
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        for name, read in readers.items():
            value = read(ctx.obs)
            if value is not None:
                unit = next(m["unit"] for m in layer if m["name"] == name)
                metrics[name] = {"value": value, "unit": unit}
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        e2e_values["setup_s"] = setup_s
        for m in e2e:
            metrics[m["name"]] = {"value": e2e_values[m["name"]], "unit": m["unit"]}

    outs = drv.outputs(ctx)
    ctx.obs.clear()
    if cuda:
        torch.cuda.empty_cache()
    checks, failed = drv.check(ctx, outs)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process has loaded {', '.join(found)}", file=sys.stderr)
        raise SystemExit(NO_CARD)
    correct = all(value <= limit for _, value, limit in checks)
    for name, value, limit in checks:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if ctx.trace:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result


def main(argv, t0: float) -> int:
    try:
        result = run(argv, t0)
    except SystemExit as exc:
        return exc.code if isinstance(exc.code, int) else 1
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], time.perf_counter()))
