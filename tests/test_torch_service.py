"""The port's service modules on the CPU: checkpoints, ProverConfig and the
statement pipeline (vdf_tpu_torch.checkpoint, .config, .nova.pipeline).

All share one module-scoped ``ivc_public_params(2, engine="native")`` (the
two keys' derivation is most of this file's time):

  * tests/test_checkpoint.py's and tests/test_config.py's cases on the port;
  * checkpoint files byte-equal to the JAX package's writers on the same
    proof (through ``interop.ivc_proof_to_jax``) and the same state, each
    package's loader reading the other's file;
  * tests/test_pipeline.py's cases on the port (statements of 2-3 steps,
    stage E with device="cpu"), each statement's proof field by field equal
    to a lone RecursiveIVC's, two interleaved chains' proofs byte-equal to
    the same chains proved in turn, and errors of either stage or of a chain's
    thread reaching the caller with ``partial_proofs``;
  * no fallback to the CPU: with no card the device entry points raise;
  * the launch counters and the kernel build under 8 threads at once.

Equality is exact (host ints, affine points, canonical witness values).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import pytest
import torch

from vdf_tpu import checkpoint as jax_checkpoint
from vdf_tpu.fields import get_field as jax_get_field
from vdf_tpu.minroot import State as JaxState
from vdf_tpu.nova import ivc as jax_ivc
from vdf_tpu_torch import ProverConfig, interop
from vdf_tpu_torch.checkpoint import load_ivc, load_vdf, resume_ivc, save_ivc, save_vdf
from vdf_tpu_torch.errors import KernelError, SerializationError
from vdf_tpu_torch.fields import get_int_field
from vdf_tpu_torch.minroot import Evaluation, MinRootVDF, pallas_vdf, vesta_vdf
from vdf_tpu_torch.nova import pipeline
from vdf_tpu_torch.nova.ivc import IVCProof, RecursiveIVC, ivc_public_params, ivc_verify
from vdf_tpu_torch.nova.pipeline import (
    VDFStatement,
    prove_interleaved,
    prove_stream,
)
from vdf_tpu_torch.serialize import serialize_ivc_proof
from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng, field_random

torch.set_num_threads(1)  # many small tensor ops; see tests/test_torch_commit.py

T, N = 2, 4  # iterations a step, steps of the checkpoint chains (tests/test_checkpoint.py)


def _forward(x, y, i, total):
    f = get_int_field("Fq")
    e = pow(5, -1, f.p - 1)
    for _ in range(total):
        x, y, i = pow((x + y) % f.p, e, f.p), (x + i) % f.p, i + 1
    return [x, y, i]


def _fields_equal(a: IVCProof, b: IVCProof) -> None:
    for f in dataclasses.fields(IVCProof):
        got, want = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(want):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name


def _as_jax(proof: IVCProof):
    d = interop.ivc_proof_to_jax(proof)
    for name in ("r_U_primary", "r_U_secondary"):
        d[name] = jax_ivc.HostRelaxedInstance(**d[name])
    d["l_u_secondary"] = jax_ivc.HostInstance(**d["l_u_secondary"])
    return jax_ivc.IVCProof(**d)


@pytest.fixture(scope="module")
def pp():
    return ivc_public_params(T, engine="native")


@pytest.fixture(scope="module")
def jax_pp():
    """The JAX package's native params: shapes only (its serializer and
    loader touch no key)."""
    return jax_ivc.ivc_public_params(T, engine="native")


@pytest.fixture(scope="module")
def two_step(pp):
    start = (11, 0, 0)
    z0 = _forward(*start, 2 * T)
    ivc = RecursiveIVC(pp, z0)
    ivc.prove_step()
    return ivc.proof(), z0, list(start)


# -- tests/test_checkpoint.py on the port


def test_ivc_checkpoint_resume_identical(pp, tmp_path):
    start = (42, 0, 0)
    z0 = _forward(*start, N * T)
    ivc_full = RecursiveIVC(pp, z0)
    for _ in range(N - 1):
        ivc_full.prove_step()
    want = serialize_ivc_proof(pp, ivc_full.proof())

    # interrupted at step 2: checkpoint, "crash", resume, continue
    ivc_a = RecursiveIVC(pp, z0)
    ivc_a.prove_step()
    ckpt = tmp_path / "ivc.ckpt"
    save_ivc(str(ckpt), pp, ivc_a)
    del ivc_a

    ivc_b = resume_ivc(str(ckpt), pp)
    assert ivc_b.i == 2
    for _ in range(N - 2):
        ivc_b.prove_step()
    assert serialize_ivc_proof(pp, ivc_b.proof()) == want, "resumed proof differs"
    assert ivc_verify(pp, ivc_b.proof(), N, z0, list(start))
    assert not list(tmp_path.glob("*.tmp.*"))  # the atomic write left no temp file


def test_ivc_checkpoint_is_verified_on_resume(pp, two_step, tmp_path):
    proof, _, _ = two_step
    ckpt = tmp_path / "ivc.ckpt"
    save_ivc(str(ckpt), pp, proof)

    blob = bytearray(ckpt.read_bytes())
    blob[len(blob) // 2] ^= 0x01  # one body byte: decode or verify must reject
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(bytes(blob))
    with pytest.raises(SerializationError):
        resume_ivc(str(bad), pp)

    trunc = tmp_path / "trunc.ckpt"
    trunc.write_bytes(ckpt.read_bytes()[:-10])
    with pytest.raises(SerializationError):
        load_ivc(str(trunc), pp)
    other = tmp_path / "other.ckpt"
    other.write_bytes(b"not a checkpoint at all")
    with pytest.raises(SerializationError, match="not an IVC checkpoint"):
        load_ivc(str(other), pp)


def test_vdf_checkpoint_roundtrip(tmp_path):
    vdf = pallas_vdf()
    s0 = vdf.state_from_ints([5, 6], [0, 0], [0, 0], device="cpu")
    _, proof1 = Evaluation.eval(vdf, s0, 3)
    path = tmp_path / "vdf.ckpt"
    save_vdf(str(path), "Fq", proof1.result, proof1.t)
    assert path.stat().st_size == 16 + 8 + 1 + 8 + 3 * 2 * 32

    field_name, state, t = load_vdf(str(path), device="cpu")
    assert field_name == "Fq" and t == 3 and state.x.device.type == "cpu"
    _, proof2 = Evaluation.eval(vdf, state, 3)
    joint = proof1.append(proof2)
    assert joint is not None and joint.t == 6 and joint.verify(s0)

    blob = bytearray(path.read_bytes())
    blob[-1] = 0xFF  # a non-canonical element fails closed
    bad = tmp_path / "bad_vdf.ckpt"
    bad.write_bytes(bytes(blob))
    with pytest.raises(SerializationError):
        load_vdf(str(bad), device="cpu")
    bad.write_bytes(path.read_bytes()[:-1])
    with pytest.raises(SerializationError, match="truncated"):
        load_vdf(str(bad), device="cpu")


# -- each package's files, the other's bytes


def test_ivc_checkpoint_bytes_equal_jax(pp, jax_pp, two_step, tmp_path):
    proof, _, _ = two_step
    mine, theirs = tmp_path / "port.ckpt", tmp_path / "jax.ckpt"
    save_ivc(str(mine), pp, proof)
    jax_checkpoint.save_ivc(str(theirs), jax_pp, _as_jax(proof))
    assert mine.read_bytes() == theirs.read_bytes()
    _fields_equal(load_ivc(str(theirs), pp), proof)
    back = jax_checkpoint.load_ivc(str(mine), jax_pp)
    _fields_equal(interop.ivc_proof_from_jax(back, engine="native"), proof)


def test_vdf_checkpoint_bytes_equal_jax(tmp_path):
    rng = XorShiftRng(TEST_SEED)
    for name in ("Fq", "Fp"):
        p = get_int_field(name).p
        xs, ys, is_ = ([field_random(rng, p) for _ in range(3)] for _ in range(3))
        vdf = pallas_vdf() if name == "Fq" else vesta_vdf()
        state = vdf.state_from_ints(xs, ys, is_, device="cpu")
        jf = jax_get_field(name)
        jstate = JaxState(jf.encode(xs), jf.encode(ys), jf.encode(is_))
        mine, theirs = tmp_path / f"port_{name}.ckpt", tmp_path / f"jax_{name}.ckpt"
        save_vdf(str(mine), name, state, 77)
        jax_checkpoint.save_vdf(str(theirs), name, jstate, 77)
        assert mine.read_bytes() == theirs.read_bytes()
        got_name, got, t = load_vdf(str(theirs), device="cpu")
        assert (got_name, t) == (name, 77) and vdf.state_to_ints(got) == (xs, ys, is_)
        j_name, j_state, j_t = jax_checkpoint.load_vdf(str(mine))
        assert (j_name, j_t) == (name, 77)
        assert [jf.decode(a) for a in j_state] == [xs, ys, is_]


# -- tests/test_config.py on the port


def test_defaults_and_validation():
    cfg = ProverConfig()
    assert cfg.t == 32 and cfg.engine == "device" and cfg.shards == 1 and cfg.device is None
    with pytest.raises(ValueError):
        ProverConfig(t=0)
    with pytest.raises(ValueError):
        ProverConfig(engine="gpu")
    with pytest.raises(ValueError, match="engine"):
        ProverConfig(engine="auto")  # the port makes no automatic choice
    with pytest.raises(ValueError):
        ProverConfig(eval_mode="nonsense")
    with pytest.raises(ValueError):
        ProverConfig(shards=0)
    assert ProverConfig().mesh() is None
    assert ProverConfig(eval_mode="rtl_add_chain").vdf().mode.value == "rtl_add_chain"
    with pytest.raises(RuntimeError, match="process group"):
        ProverConfig(shards=2).mesh()  # no process group in this process


def test_from_env_overrides(monkeypatch):
    monkeypatch.setenv("VDF_TPU_T", "7")
    monkeypatch.setenv("VDF_TPU_ENGINE", "native")
    monkeypatch.setenv("VDF_TPU_EVAL_MODE", "rtl_add_chain")
    monkeypatch.setenv("VDF_TPU_SHARDS", "3")
    monkeypatch.setenv("VDF_TPU_CHECKPOINT", "/ckpt")
    cfg = ProverConfig.from_env()
    assert (cfg.t, cfg.engine, cfg.eval_mode, cfg.shards, cfg.checkpoint_dir) == (
        7, "native", "rtl_add_chain", 3, "/ckpt")
    assert ProverConfig.from_env(t=3).t == 3  # explicit overrides beat env
    monkeypatch.setenv("VDF_TPU_ENGINE", "auto")
    with pytest.raises(ValueError):
        ProverConfig.from_env()


def test_prover_roundtrip_native(pp):
    """Config -> prover -> one step -> verify (the native engine)."""
    cfg = ProverConfig(t=T, engine="native")
    assert cfg.public_params() is pp  # cached per (t, engine, device, mesh)
    vdf = cfg.vdf()
    assert vdf.field.params.name == "Fq"
    z0 = _forward(42, 0, 0, 2 * T)
    ivc = cfg.prover(z0)
    ivc.prove_step()
    assert ivc_verify(cfg.public_params(), ivc.proof(), 2, z0, [42, 0, 0])


def test_device_entry_points_need_a_card(monkeypatch, tmp_path):
    """No fallback to the CPU: with no card the device engine's config, the
    pipeline's stage E and load_vdf raise KernelError."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KernelError, match="no CUDA device"):
        ProverConfig(t=1).public_params()
    with pytest.raises(KernelError, match="no CUDA device"):
        prove_stream(None, [VDFStatement((1, 0, 0), 1)])
    path = tmp_path / "vdf.ckpt"
    save_vdf(str(path), "Fq", pallas_vdf().state_from_ints([1], [2], [3], device="cpu"), 1)
    with pytest.raises(KernelError, match="no CUDA device"):
        load_vdf(str(path))


# -- tests/test_pipeline.py on the port


@pytest.fixture(scope="module")
def statements():
    rng = XorShiftRng(TEST_SEED)
    p = get_int_field("Fq").p
    return [
        VDFStatement((field_random(rng, p), 0, 1), num_steps=3),
        VDFStatement((field_random(rng, p), 0, 1), num_steps=2),
        VDFStatement((field_random(rng, p), 0, 1), num_steps=3),
    ]


def test_statement_needs_a_step():
    with pytest.raises(ValueError, match="num_steps"):
        VDFStatement((1, 0, 0), 0)


def test_pipelined_matches_sequential(pp, statements):
    vdf = pallas_vdf()
    seq = prove_stream(pp, statements, vdf, pipelined=False, device="cpu")
    pipe = prove_stream(pp, statements, vdf, pipelined=True, device="cpu")
    assert len(seq) == len(pipe) == len(statements)
    for s, q in zip(seq, pipe):
        assert s.statement == q.statement  # order preserved
        assert s.verified and q.verified
        assert s.z0 == q.z0 == _forward(*q.statement.start, T * q.statement.num_steps)
        assert s.eval_seconds > 0 and q.fold_seconds > 0
        _fields_equal(s.proof, q.proof)  # the pipeline is scheduling only
        assert ivc_verify(pp, q.proof, q.statement.num_steps, q.z0, list(q.statement.start))
        lone = RecursiveIVC(pp, q.z0)  # and equals a lone chain's proof
        for _ in range(q.statement.num_steps - 1):
            lone.prove_step()
        _fields_equal(q.proof, lone.proof())


def test_interleaved_chains_match_sequential(pp):
    """prove_interleaved is scheduling only: each chain's proof equals a
    lone RecursiveIVC's, and verifies."""
    rng = XorShiftRng(TEST_SEED)
    p = get_int_field("Fq").p
    num_steps = 3
    starts = [(field_random(rng, p), 0, 1) for _ in range(3)]
    z0s = [_forward(*s, T * num_steps) for s in starts]
    proofs = prove_interleaved(pp, z0s, num_steps, starts=starts)
    assert len(proofs) == len(starts)
    for z0, start, proof in zip(z0s, starts, proofs):
        assert ivc_verify(pp, proof, num_steps, z0, list(start))
        solo = RecursiveIVC(pp, z0)
        for _ in range(num_steps - 1):
            solo.prove_step()
        _fields_equal(proof, solo.proof())


def test_interleaved_pair_bytes_equal_sequential(pp):
    """Two chains on two threads, each synthesis keeping its own blocks: both
    proofs serialize to the bytes of the same chains proved one after the
    other, and the syntheses arrived mostly as blocks."""
    from vdf_tpu_torch.r1cs import witness

    rng = XorShiftRng(TEST_SEED[::-1])
    p = get_int_field("Fq").p
    num_steps = 3
    z0s = [_forward(field_random(rng, p), 0, 1, T * num_steps) for _ in range(2)]
    before = dict(witness.ELEMENTS)
    proofs = prove_interleaved(pp, z0s, num_steps)
    blocks = witness.ELEMENTS["block"] - before["block"]
    singles = witness.ELEMENTS["single"] - before["single"]
    assert blocks / (blocks + singles) >= 0.9
    for z0, proof in zip(z0s, proofs):
        solo = RecursiveIVC(pp, z0)
        for _ in range(num_steps - 1):
            solo.prove_step()
        assert serialize_ivc_proof(pp, proof) == serialize_ivc_proof(pp, solo.proof())


def test_pipeline_rejects_tampered_start(pp):
    stmt = VDFStatement((12345, 0, 1), num_steps=2)
    (res,) = prove_stream(pp, [stmt], pallas_vdf(), pipelined=True, device="cpu")
    assert res.verified
    assert not ivc_verify(pp, res.proof, stmt.num_steps, res.z0, [54321, 0, 1])


class _FailingVDF(MinRootVDF):
    """Stage E fails on a statement whose start x is 666."""

    def eval(self, s, t):
        if self.field.decode(s.x) == [666]:
            raise RuntimeError("stage E failed")
        return super().eval(s, t)


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "sequential"])
def test_stage_e_error_reaches_caller(pp, pipelined):
    good = VDFStatement((5, 0, 1), num_steps=2)
    bad = VDFStatement((666, 0, 1), num_steps=2)
    vdf = _FailingVDF(pallas_vdf().field)
    with pytest.raises(RuntimeError, match="stage E failed") as info:
        prove_stream(pp, [good, bad, good], vdf, pipelined=pipelined, device="cpu")
    done = info.value.partial_proofs
    assert [r.statement for r in done] == [good] and done[0].verified


def test_chain_error_reaches_caller(pp, monkeypatch):
    """An exception in one chain's thread reaches the caller, with the other
    chains' proofs attached."""
    z0s = [_forward(7, 0, 1, 2 * T), _forward(8, 0, 1, 2 * T)]
    real = pipeline.RecursiveIVC.prove_step

    def prove_step(self):
        if self.z0 == z0s[1]:
            raise RuntimeError("chain failed")
        real(self)

    monkeypatch.setattr(pipeline.RecursiveIVC, "prove_step", prove_step)
    with pytest.raises(RuntimeError, match="chain failed") as info:
        prove_interleaved(pp, z0s, 2)
    good, failed = info.value.partial_proofs
    assert failed is None and ivc_verify(pp, good, 2, z0s[0], [7, 0, 1])


# -- thread safety of the counters and the build


def test_launch_counters_under_threads():
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.fields import kernels as FK

    FK.reset_launches()
    CK.reset_launches()
    per_thread = 20000

    def work():
        for k in range(per_thread):
            FK.count_launch("minroot_eval", k % 2)
            CK.count_launch("scan")

    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert FK.LAUNCHES["minroot_eval"] == CK.LAUNCHES["scan"] == 8 * per_thread
    assert FK.STREAMS["minroot_eval", 0] == FK.STREAMS["minroot_eval", 1] == 4 * per_thread
    FK.reset_launches()
    CK.reset_launches()
    assert FK.LAUNCHES["minroot_eval"] == CK.LAUNCHES["scan"] == 0 and not FK.STREAMS


def test_kernels_build_once_under_threads(monkeypatch):
    """Eight threads asking for the kernels at once run one build."""
    from vdf_tpu_torch import _build

    builds = []

    def fake_build(out_dir):
        builds.append(out_dir)
        time.sleep(0.2)
        return out_dir, 0.0, ""

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build, "Kernels", lambda *args: ("kernels", args))
    _build.load_kernels.cache_clear()
    try:
        got = []
        threads = [threading.Thread(target=lambda: got.append(_build.load_kernels()))
                   for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        _build.load_kernels.cache_clear()
    assert len(builds) == 1 and len(got) == 8 and all(g is got[0] for g in got)
