"""The port's benchmark (``python -m vdf_tpu_torch.bench``) on the CPU,
against the repo root's ``bench.py`` and the JAX package.

  (a) its inputs are the reference's: the statement's host-int rounds, the
      MSM points and scalars, the MinRoot start state;
  (b) ``--minroot``, ``--msm`` (at 64 points: a CPU ``msm`` is ~25 s
      whatever n, nearly all the plain K6) and ``--folding`` at
      ``--smoke --device cpu`` exit 0, as subprocesses started together
      at the first test so that they run beside the in-process tests;
      each full line has the reference's metric and every detail key its
      section emits, and the last line is short;
  (c) the results equal the JAX package's on the same inputs;
  (d) every gate fails the run when its result is off by one, one case a
      gate: the run exits non-zero and ``section_errors`` names the
      section; a section skipped for the budget does the same;
  (e) no card without ``--device cpu`` exits non-zero naming KernelError;
  (f) the signal handler exits 128 + signum after a parseable last line.
"""

import argparse
import ast
import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as reference
from vdf_tpu_torch import bench, interop
from vdf_tpu_torch.curves import Point, get_curve
from vdf_tpu_torch.fields import get_field
from vdf_tpu_torch.minroot import MinRootVDF, State, pallas_vdf
from vdf_tpu_torch.native import msm_native_affine
from vdf_tpu_torch.nova.ivc import RecursiveIVC

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
MSM_POINTS = 64
SMOKE_RUNS = {"minroot": ["--minroot"], "msm": ["--msm", "--points", str(MSM_POINTS)],
              "folding": ["--folding"]}
# the reference's section -> the function whose detail dict it prints (bench.py)
REFERENCE_DETAIL = {"minroot": "_minroot_result", "msm": "_msm_result", "folding": "_fold_dict"}
METRICS = {"minroot": "minroot_aggregate_iters_per_sec", "msm": "msm_points_per_sec_per_chip",
           "folding": "nova_folding_steps_per_sec"}


class SmokeRuns:
    """The three smoke runs, started at once; each read when first asked for."""

    def __init__(self):
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self.procs = {
            name: subprocess.Popen(
                [sys.executable, "-m", "vdf_tpu_torch.bench", *argv, "--smoke", "--device", "cpu"],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name, argv in SMOKE_RUNS.items()}
        self.done = {}

    def result(self, name: str):
        if name not in self.done:
            out, err = self.procs[name].communicate(timeout=900)
            self.done[name] = (self.procs[name].returncode, out.splitlines(), err)
        return self.done[name]

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def smoke_runs():
    runs = SmokeRuns()
    yield runs
    runs.close()


def _reference_detail_keys(fn_name: str) -> set:
    """The keys of the detail dict literal the reference's function prints
    (``detail = {...}`` or ``"detail": {...}``); keys it adds under a
    condition are not among them."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    dicts = [n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
             and any(isinstance(t, ast.Name) and t.id == "detail" for t in n.targets)]
    dicts += [v for n in ast.walk(fn) if isinstance(n, ast.Dict)
              for k, v in zip(n.keys, n.values)
              if isinstance(k, ast.Constant) and k.value == "detail"]
    keys = {k.value for d in dicts if isinstance(d, ast.Dict) for k in d.keys}
    assert keys, fn_name
    return keys


def _lines(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


# ---------------------------------------------------------------------
# (a) the inputs
# ---------------------------------------------------------------------


def test_inputs_are_the_references(smoke_runs):
    from vdf_tpu.curves import get_curve as jax_curve
    from vdf_tpu.curves.point import hash_to_curve_ints as jax_hash_to_curve
    from vdf_tpu.minroot import pallas_vdf as jax_pallas_vdf

    assert bench._forward_eval_ints(*bench.START, 64) == reference._forward_eval_ints(
        987654321, 0, 1, 64)

    # bench.py:270-281, rebuilt with vdf_tpu
    n = 2 * bench.MSM_BASES + 5
    rng = np.random.default_rng(7)
    base_aff = jax_hash_to_curve("pallas", 1024, domain=b"vdf_tpu/bench")
    aff = [base_aff[k % 1024] for k in range(n)]
    f = jax_curve("pallas").scalar
    q = f.params.modulus
    scal_ints = [int.from_bytes(rng.bytes(32), "little") % q for k in range(n)]
    assert bench.msm_inputs(n) == (aff, scal_ints)
    sf = get_curve("pallas").scalar
    assert interop.jax_limbs_to_ints(sf.params.name, np.asarray(f.encode(scal_ints))) == \
        sf.decode(sf.encode(scal_ints, CPU))

    # bench.py:409-413
    jf = jax_pallas_vdf().field
    lanes = 64
    want = [interop.jax_limbs_to_ints("Fq", np.asarray(jf.encode(v)))
            for v in ([3 + k for k in range(lanes)], [0] * lanes, [0] * lanes)]
    vdf = pallas_vdf()
    assert list(vdf.state_to_ints(bench.minroot_start(vdf, lanes, CPU))) == want


# ---------------------------------------------------------------------
# (c) the results against the JAX package
# ---------------------------------------------------------------------


def test_smoke_minroot_lanes_equal_the_jax_packages():
    from vdf_tpu.minroot import State as JaxState
    from vdf_tpu.minroot import pallas_vdf as jax_pallas_vdf

    lanes, t = 64, 8  # the smoke run's
    vdf = pallas_vdf()
    got = vdf.state_to_ints(vdf.eval(bench.minroot_start(vdf, lanes, CPU), t))
    jv = jax_pallas_vdf()
    jf = jv.field
    js = jv.eval_uncached(JaxState(jf.encode([3 + k for k in range(lanes)]),
                                   jf.encode([0] * lanes), jf.encode([0] * lanes)), t=t)
    assert list(got) == [interop.jax_limbs_to_ints("Fq", np.asarray(a)) for a in js]


# ---------------------------------------------------------------------
# (d) every gate, and the budget
# ---------------------------------------------------------------------


def _plus_one_x(s: State) -> State:
    f = get_field("Fq")
    return State(f.add(s.x, f.one(s.x.device).expand_as(s.x)), s.y, s.i)


def _tamper_proof(monkeypatch):
    real = RecursiveIVC.proof

    def proof(self):
        out = real(self)
        out.z_i = [out.z_i[0] + 1, *out.z_i[1:]]
        return out

    monkeypatch.setattr(RecursiveIVC, "proof", proof)


def _fake_msm(monkeypatch, wrong_from_call: int):
    """msm replaced by the native Pippenger's sum, its x off by one from the
    ``wrong_from_call``-th call on."""
    import vdf_tpu_torch.curves as C

    calls = []

    def fake(curve, points, scalars):
        calls.append(1)
        x, y = msm_native_affine("pallas", curve.to_affine_ints(points),
                                 curve.scalar.decode(scalars))
        shift = 1 if len(calls) >= wrong_from_call else 0
        return Point(*(v[0] for v in curve.from_affine_ints([(x + shift, y)], points.x.device)))

    monkeypatch.setattr(C, "msm", fake)


def _tamper_method(monkeypatch, name: str, when=lambda s: True):
    real = getattr(MinRootVDF, name)

    def tampered(self, s, *rest):
        out = real(self, s, *rest)
        return _plus_one_x(out) if when(s) else out

    monkeypatch.setattr(MinRootVDF, name, tampered)


def _run_main(argv, capsys):
    rc = bench.main([*argv, "--device", "cpu"])
    return rc, _lines(capsys)[-1]


def _run_section(name, fn, capsys, kernels=()):
    asm = bench.Assembler(CPU, 600.0, "cpu", "the test's host")
    asm.section(name, fn, kernels=kernels)
    rc = asm.finish()
    return rc, _lines(capsys)[-1]


SMOKE_FOLD = ["--folding", "--smoke", "--steps", "3"]
SMALL_MINROOT = ["--minroot", "--smoke", "--lanes", "2", "--iters", "2"]


def _gate_statement(monkeypatch, capsys):
    _tamper_method(monkeypatch, "eval")
    return "folding", "statement", _run_main(SMOKE_FOLD, capsys)


def _gate_folding(monkeypatch, capsys):
    _tamper_proof(monkeypatch)
    return "folding", "does not verify", _run_main(SMOKE_FOLD, capsys)


def _gate_folding_zn(monkeypatch, capsys):
    calls = []

    def chain(pp, z0, n, start, device):
        calls.append(1)
        return {"step_s": [1.0], "z_n": [len(calls), 0, 1], "phases": {}}

    monkeypatch.setattr(bench, "prove_chain", chain)
    return "folding", "different z_n", _run_main(SMOKE_FOLD, capsys)


def _gate_interleaved(monkeypatch, capsys):
    import vdf_tpu_torch.nova.pipeline as P

    real = P.prove_interleaved

    def tampered(pp, z0s, n):
        proofs = real(pp, z0s, n)
        proofs[0].z_i = [proofs[0].z_i[0] + 1, *proofs[0].z_i[1:]]
        return proofs

    monkeypatch.setattr(P, "prove_interleaved", tampered)
    return "interleaved", "does not verify", _run_section("interleaved", lambda: (
        bench.interleaved_result(2, 3, "native", CPU, lambda: 600.0, [], ks=(1,))), capsys)


def _gate_msm(monkeypatch, capsys):
    _fake_msm(monkeypatch, wrong_from_call=1)
    return "msm", "native Pippenger", _run_main(["--msm", "--smoke", "--points", "8"], capsys)


def _gate_msm_repeat(monkeypatch, capsys):
    _fake_msm(monkeypatch, wrong_from_call=2)
    return "msm", "timed msm", _run_main(["--msm", "--smoke", "--points", "8"], capsys)


def _gate_minroot_eval(monkeypatch, capsys):
    _tamper_method(monkeypatch, "eval")
    return "minroot", "eval differs", _run_main(SMALL_MINROOT, capsys)


def _gate_minroot_verify(monkeypatch, capsys):
    _tamper_method(monkeypatch, "inverse_eval")
    return "minroot", "verify differs", _run_main(SMALL_MINROOT, capsys)


def _gate_native_minroot(monkeypatch, capsys):
    import vdf_tpu_torch.native as N

    real = N.minroot_eval_native
    monkeypatch.setattr(N, "minroot_eval_native",
                        lambda *a: (lambda x, y, i: (x + 1, y, i))(*real(*a)))
    return "minroot", "native MinRoot", _run_main(SMALL_MINROOT, capsys)


def _gate_latency(monkeypatch, capsys):
    monkeypatch.setattr(bench, "LATENCY_LANES", 4)
    _tamper_method(monkeypatch, "eval", when=lambda s: s.x.shape[0] == 4)
    args = argparse.Namespace(smoke=False, lanes=2, iters=2, mode="ltr_sequential",
                              xla_path=False)
    return "minroot", "latency point", _run_section("minroot", lambda: bench.minroot_result(
        args, CPU, "cpu", lambda: 600.0, [], with_modes=False), capsys)


def _gate_per_mode(monkeypatch, capsys):
    _tamper_method(monkeypatch, "round")
    return "per_mode", "mode ltr_sequential", _run_section("per_mode", lambda: (
        bench.permode_result(CPU, lambda: 600.0, [], lanes=2, t=2)), capsys)


def _gate_sweep(monkeypatch, capsys):
    _tamper_proof(monkeypatch)
    return "sweep_t2", "does not verify", _run_section("sweep_t2", lambda: bench.sweep_point(
        2, 200, 3, "native", CPU), capsys)


GATES = {name[len("_gate_"):]: fn for name, fn in list(globals().items())
         if name.startswith("_gate_")}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_a_wrong_result_fails_the_run(gate, monkeypatch, capsys):
    section, message, (rc, last) = GATES[gate](monkeypatch, capsys)
    assert rc == 1
    errors = last["detail"]["section_errors"]
    assert list(errors) == [section], errors
    assert errors[section].startswith("BenchError") and message in errors[section], errors


def test_a_skipped_section_fails_the_run(monkeypatch, capsys):
    """With a budget of 1 s the default smoke run proves the headline (it
    always runs) and skips the msm and minroot sections."""
    monkeypatch.setenv(bench.BUDGET_ENV, "1")
    rc = bench.main(["--smoke", "--steps", "3", "--device", "cpu"])
    lines = _lines(capsys)
    last = lines[-1]
    assert rc == 1
    assert last["metric"] == "nova_folding_steps_per_sec" and last["value"] > 0
    assert last["detail"]["skipped"] == ["msm", "minroot"]
    assert last["detail"]["section_errors"] == {}
    assert lines[-2]["detail"]["verified"] is True


def test_section_errors_do_not_stop_the_run(monkeypatch, capsys):
    _tamper_method(monkeypatch, "eval")
    _fake_msm(monkeypatch, wrong_from_call=10**9)
    rc = bench.main([*SMALL_MINROOT, "--msm", "--points", "8", "--device", "cpu"])
    last = _lines(capsys)[-1]
    assert rc == 1 and list(last["detail"]["section_errors"]) == ["minroot"]
    assert last["metric"] == "msm_points_per_sec_per_chip" and last["value"] > 0
    assert len(json.dumps(last)) < bench.LAST_LINE_MAX


# ---------------------------------------------------------------------
# (e) no card, (f) signals
# ---------------------------------------------------------------------


def test_no_card_exits_non_zero_naming_kernel_error():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "vdf_tpu_torch.bench", "--smoke", "--minroot"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "KernelError" in proc.stderr and proc.stdout == ""


@pytest.mark.parametrize("signum", [signal.SIGTERM, signal.SIGINT])
def test_signal_exits_128_plus_signum(signum, capsys):
    asm = bench.Assembler(CPU, 600.0, "cpu", "the test's host")
    asm.msm = {"metric": "msm_points_per_sec_per_chip", "value": 5.0, "unit": "points/s",
               "vs_baseline": 0.5, "detail": {"baseline_points_per_sec": 10.0}}
    with pytest.raises(SystemExit) as exc:
        asm.on_signal(signum, None)
    assert exc.value.code == 128 + signum
    lines = _lines(capsys)
    assert lines[-1]["metric"] == "msm_points_per_sec_per_chip"
    assert lines[-1]["detail"]["skipped"] == [f"signal_{signum}"]
    assert lines[-1]["detail"]["msm"]["baseline"] == 10.0


def test_main_restores_the_signal_handlers(capsys):
    before = [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)]
    assert bench.main([*SMALL_MINROOT, "--device", "cpu"]) == 0
    assert [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)] == before
    capsys.readouterr()


def test_last_line_stays_short_with_long_errors():
    asm = bench.Assembler(CPU, 600.0, "cpu", "the test's host")
    asm.errors = {f"sweep_t{k}": "BenchError: " + "x" * 5000 for k in range(12)}
    line = asm.last_line()
    assert len(line) < bench.LAST_LINE_MAX
    assert sorted(json.loads(line)["detail"]["section_errors"]) == sorted(asm.errors)


# ---------------------------------------------------------------------
# (b), (c): the smoke runs as a caller sees them
# ---------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SMOKE_RUNS))
def test_smoke_run_exits_0_with_the_references_keys(name, smoke_runs):
    rc, lines, err = smoke_runs.result(name)
    assert rc == 0, err[-3000:]
    full, last = json.loads(lines[-2]), lines[-1]
    assert full["metric"] == METRICS[name] and full["value"] > 0
    assert full["vs_baseline"] is not None
    missing = _reference_detail_keys(REFERENCE_DETAIL[name]) - set(full["detail"])
    assert not missing, missing
    assert full["detail"]["backend"] == "cpu"
    assert len(last) < bench.LAST_LINE_MAX
    short = json.loads(last)
    assert (short["metric"], short["value"], short["vs_baseline"]) == \
        (full["metric"], full["value"], full["vs_baseline"])
    assert short["detail"]["skipped"] == [] and short["detail"]["section_errors"] == {}
    assert short["detail"][name]["baseline"] > 0


def test_smoke_msm_equals_the_jax_packages_native(smoke_runs):
    from vdf_tpu.native import msm_native as jax_msm_native

    rc, lines, _ = smoke_runs.result("msm")
    detail = json.loads(lines[-2])["detail"]
    assert rc == 0 and detail["oracle_checked_at"] == MSM_POINTS
    aff, sc = bench.msm_inputs(MSM_POINTS)
    x, y, z = jax_msm_native("pallas", aff, sc)
    mod = get_field("Fp").params.modulus
    zi = pow(z, -1, mod)
    want = [hex(x * zi * zi % mod), hex(y * zi * zi % mod * zi % mod)]
    assert detail["checked_sum_affine_hex"] == want


def test_smoke_folding_shapes_equal_the_jax_packages(smoke_runs):
    from vdf_tpu.nova.ivc import ivc_public_params as jax_ivc_public_params

    rc, lines, _ = smoke_runs.result("folding")
    detail = json.loads(lines[-2])["detail"]
    pp = jax_ivc_public_params(2, engine="native")
    assert rc == 0 and detail["t_iters_per_step"] == 2 and detail["num_steps"] == 4
    assert (detail["constraints_primary"], detail["constraints_secondary"]) == \
        (pp.primary.shape.num_cons, pp.secondary.shape.num_cons)
    assert detail["verified"] is True and detail["engine"] == "native"
