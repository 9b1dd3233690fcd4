#!/usr/bin/env python3
"""Time K7's two forms over n, count the SASS instructions of a doubling, and
time torch.sort of K3's keys in both widths, on one GPU.

    python3 tools/k7_sweep.py

  * K7 (``shift_gens``, the table 2^(12 w) G_i) through its C launcher in its
    thread form (one thread a generator) and its group form (a group of 8
    threads a generator on the group law), at n = 2^10 .. 2^16 generators on
    Pallas and Vesta; the two forms equal bit for bit, and the form the
    wrapper picks (``curves.kernels.shift_form``, ``SHIFT_GROUP_BELOW``
    generators an SM).  Run from an older checkout (copy the file there), it
    times the one form that tree has, through its wrapper;
  * the SASS instructions (``cuobjdump -sass``) of one doubling, each inlined
    into a probe kernel of its own, less those of a probe that only loads
    and stores the point: ``point_double`` (one thread, every value reduced:
    the thread form before, and ``dbl_pt``), ``point_double_lazy`` (the
    thread form's doubling now) and a lane of the group law's four steps;
  * ``torch.sort(keys, dim=-1)`` of the (digit, item) keys K3 writes, as int64
    and as 32-bit keys, at the commit's shape (1 and 2 rows of 360,448 keys,
    n = 2^14) and the MSM's (22 rows of 1,048,586, n = 2^20), the two sorted
    sequences equal item for item.

Each time is the mean of REPS back-to-back calls between two CUDA events,
taken RUNS times; the median is printed in milliseconds, one JSON line a
reading, after the card's name and power limit.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys

RUNS = 3
REPS = 5
SWEEP_BITS = range(10, 17)  # n = 2^10 .. 2^16 generators
BASE = 256  # distinct hash-derived generators, repeated to n
# Probe kernels, each one doubling inlined between a load and a store of the
# point (a lane of the group law: its four steps on a buffer); probe_copy is
# the load and the store alone.
PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include "msm_kernels.cuh"

using namespace vdf;

extern "C" __global__ void probe_copy(Pt* p) {
  Pt a = p[threadIdx.x];
  p[threadIdx.x] = a;
}
extern "C" __global__ void probe_point_double(Pt* p) {
  Pt a = p[threadIdx.x];
  point_double<1>(a, a);
  p[threadIdx.x] = a;
}
extern "C" __global__ void probe_point_double_lazy(Pt* p) {
  Pt a = p[threadIdx.x];
  point_double_lazy<1>(a, a);
  p[threadIdx.x] = a;
}
extern "C" __global__ void probe_group_dbl_lane(uint32_t* buf) {
#pragma unroll
  for (int i = 0; i < GROUP_STEPS; ++i) {
    group_step<1>(buf, group_dbl_step(i), (int)(threadIdx.x % GROUP));
    __syncwarp();
  }
}
"""
PROBES = ("probe_point_double", "probe_point_double_lazy", "probe_group_dbl_lane")


def _median_ms(fn) -> tuple[float, list[float]]:
    import torch

    fn()  # warm-up
    runs = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / REPS)
    return statistics.median(runs), runs


def _sass_counts() -> dict:
    """probe -> (SASS instructions, IMAD-class instructions) of one doubling
    on Fq (each probe less probe_copy), from cuobjdump -sass of the probes
    built with the port's nvcc flags."""
    from vdf_tpu_torch import _build

    out_dir = _build.BUILD_DIR / ("k7_sweep_" + _build.build_key())
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / _build.CONSTS_HEADER).write_text(_build.constants_header())
    (out_dir / "probe.cu").write_text(PROBE_SOURCE)
    lib = out_dir / "libprobe.so"
    subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR),
         "-I", str(out_dir), "-o", str(lib), str(out_dir / "probe.cu")],
        check=True, capture_output=True, text=True,
    )
    tool = shutil.which("cuobjdump") or str(_build.DEFAULT_CUDA_HOME / "bin" / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = [0, 0]
            continue
        op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if op and name is not None:
            counts[name][0] += 1
            counts[name][1] += op.group(1).startswith("IMAD")
    base = counts["probe_copy"]
    return {p: (counts[p][0] - base[0], counts[p][1] - base[1]) for p in PROBES}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k7_sweep: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as S
    from vdf_tpu_torch.curves import CURVES, get_curve, hash_to_curve_ints, stack_point
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.curves.bucket_msm import ROWS

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)

    def emit(**row):
        print(json.dumps(row), flush=True)

    forms = getattr(CK, "SHIFT_FORMS", None)
    if forms is not None:  # the probes need this tree's lazy doubling
        for probe, (total, imad) in _sass_counts().items():
            emit(sass=probe, field="Fq", instructions=total, imad=imad)

    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for curve_name in ("pallas", "vesta"):
        c = get_curve(curve_name)
        bf = CURVES[curve_name].base_field
        base = stack_point(c.from_affine_ints(
            hash_to_curve_ints(curve_name, BASE, domain=b"vdf_tpu/t"), device)).contiguous()
        for bits in SWEEP_BITS:
            n = 1 << bits
            gens = base[torch.arange(n, device=device) % BASE].contiguous()
            want = CK.shift_gens(bf, gens)
            if forms is None:  # an older tree: its one form, through the wrapper
                ms, runs = _median_ms(lambda: CK.shift_gens(bf, gens))
                emit(kernel="K7", curve=curve_name, n=n, gens_an_sm=n / sms, form="thread",
                     own_choice=True, ms=ms, runs=runs)
                continue
            chosen = CK.shift_form(n, device)
            for form in forms:
                out = S._shift_launch(bf, gens, form)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise SystemExit(f"K7 ({form} form) disagrees with the wrapper at n={n}")
                ms, runs = _median_ms(lambda form=form, out=out: S._shift_launch(bf, gens, form,
                                                                                 out))
                emit(kernel="K7", curve=curve_name, n=n, gens_an_sm=n / sms, form=form,
                     own_choice=form == chosen, ms=ms, runs=runs)
            del gens, want

    if not hasattr(CK, "key_digit"):
        return  # an older tree: int64 keys only
    curve_name = "pallas"
    sf = CURVES[curve_name].scalar_field
    shapes = []
    for k in (1, 2):
        _, _, s, _, _ = S._commit_inputs(curve_name, S.COMMIT_N, k, device)
        shapes.append((f"commit n=2^14 K={k}", s, CK.WINDOWS * S.COMMIT_N, False))
    _, _, scalars, _ = S._msm_inputs(curve_name, S.MSM_N, device)
    shapes.append(("msm n=2^20", scalars[None], S.MSM_N, True))
    for shape, s, items, window_rows in shapes:
        m_pad = -(-items // ROWS) * ROWS
        sorted_by_width = {}
        for bits in (64, 32):
            keys = CK.canon_digits(sf, s, m_pad, window_rows, key_bits=bits)
            keys = keys[0] if window_rows else keys
            ms, runs = _median_ms(lambda keys=keys: torch.sort(keys, dim=-1))
            got = torch.sort(keys, dim=-1).values
            sorted_by_width[bits] = (CK.key_digit(got), CK.key_item(got))
            emit(stage="torch.sort", shape=shape, rows=keys.shape[0], keys_a_row=keys.shape[1],
                 key_bits=bits, dtype=str(keys.dtype), ms=ms, runs=runs)
        if not all(torch.equal(a, b) for a, b in zip(*sorted_by_width.values())):
            raise SystemExit(f"the sorted 32-bit and int64 keys differ at {shape}")


if __name__ == "__main__":
    main()
