"""Pipelined and interleaved VDF proving (the SURVEY §2.4 PP axis).

Port of ``vdf_tpu.nova.pipeline``.  Fold order forbids eval-vs-fold
overlap *inside* one statement: Nova folding consumes inverse-direction
segments starting from the FINAL state (the reference reverses its segment
list before proving, src/nova/proof.rs:294), so the first fold already
needs the finished slow evaluation.  The pipeline therefore overlaps at
*statement* granularity: a proving service receives a stream of VDF
statements; stage E runs statement k+1's slow evaluation (K1) while stage
F (host witness synthesis plus the device folds) proves statement k.

Stage E runs in a thread of its own, on a CUDA stream of its own
(``torch.cuda.Stream``), so its K1 launch is not queued behind stage F's
work on the default stream.  It waits for K1 with ``stream.synchronize()``,
which releases the GIL, so stage F's Python synthesis runs meanwhile, and
it hands stage F canonical ints, so no tensor crosses between the streams.

``InterleavedProver`` (and ``prove_interleaved`` on it) folds K independent
chains on K threads, so each chain's host work runs while the others wait on
the card.  Its chains share one stream (the default): their lazily made
constants (``Field.const_like``, the keys) are shared tensors, and a tensor
made on one stream and read on another needs a synchronisation between them
that nothing here would make.

Reference anchor: the sequential prove loop this pipelines around is
``prove_recursively``'s fold loop (src/nova/proof.rs:316-355) fed by
``eval_and_make_circuits`` (:262-298).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import queue
import threading
import time

import torch

from ..device import resolve_device
from ..errors import NovaError
from ..minroot import MinRootVDF
from .ivc import IVCParams, IVCProof, RecursiveIVC, ivc_verify


@dataclasses.dataclass(frozen=True)
class VDFStatement:
    """One proving request: run ``num_steps * pp.t`` slow MinRoot rounds
    from ``start`` and produce an IVC proof of the chain."""

    start: tuple[int, int, int]  # (x, y, i) as canonical ints
    num_steps: int

    def __post_init__(self):
        # The reference asserts num_steps > 0 (src/nova/proof.rs:268): a
        # zero-step statement would otherwise come back as verified=False.
        if self.num_steps < 1:
            raise ValueError("VDFStatement.num_steps must be >= 1")


@dataclasses.dataclass
class StatementProof:
    statement: VDFStatement
    z0: list[int]  # final VDF state = the IVC chain's input
    proof: IVCProof
    verified: bool
    eval_seconds: float
    fold_seconds: float


def _eval_statement(pp: IVCParams, vdf: MinRootVDF, stmt: VDFStatement, device: torch.device,
                    stream):
    """The slow direction (K1 on a CUDA device, on ``stream``); returns
    (z0 as canonical ints, wall seconds)."""
    f = vdf.field
    t0 = time.perf_counter()
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        s = vdf.state_from_ints(*([v] for v in stmt.start), device=device)
        res = vdf.eval(s, pp.t * stmt.num_steps)
        if stream is not None:
            stream.synchronize()  # releases the GIL while K1 runs
        z0 = [f.decode(a)[0] for a in res]
    return z0, time.perf_counter() - t0


def _fold_statement(pp: IVCParams, stmt: VDFStatement, z0: list[int]):
    """Prove the statement's inverse chain; returns (proof, ok, wall s)."""
    t0 = time.perf_counter()
    ivc = RecursiveIVC(pp, z0)
    for _ in range(stmt.num_steps - 1):
        ivc.prove_step()
    proof = ivc.proof()
    ok = ivc_verify(pp, proof, stmt.num_steps, z0, list(stmt.start))
    return proof, ok, time.perf_counter() - t0


def prove_stream(
    pp: IVCParams,
    statements: list[VDFStatement],
    vdf: MinRootVDF | None = None,
    pipelined: bool = True,
    depth: int = 2,
    device=None,
) -> list[StatementProof]:
    """Prove a stream of VDF statements, overlapping stage E (the eval of
    statement k+1) with stage F (the folds of statement k).

    ``pipelined=False`` runs the two stages strictly in sequence a
    statement, the reference's execution model and the baseline of the
    pipeline.  ``depth`` bounds how many evaluated-but-unproven statements
    may be in flight.  ``device`` is stage E's (None: the card, or
    ``KernelError`` where there is none).  An exception of either stage
    reaches the caller with ``partial_proofs``, the statements proven so
    far, attached."""
    device = resolve_device(device)
    if vdf is None:
        from ..minroot import pallas_vdf

        vdf = pallas_vdf()
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    if not pipelined:
        out = []
        try:
            for stmt in statements:
                z0, dt_e = _eval_statement(pp, vdf, stmt, device, stream)
                proof, ok, dt_f = _fold_statement(pp, stmt, z0)
                out.append(StatementProof(stmt, z0, proof, ok, dt_e, dt_f))
        except BaseException as exc:
            exc.partial_proofs = out
            raise
        return out

    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    err: list[BaseException] = []
    consumer_dead = threading.Event()

    def stage_e():
        try:
            for stmt in statements:
                item = (stmt, *_eval_statement(pp, vdf, stmt, device, stream))
                # A bounded put that notices a dead consumer: otherwise a
                # consumer failure leaves this thread blocked on q.put.
                while not consumer_dead.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if consumer_dead.is_set():
                    return
        except BaseException as exc:  # surfaced by the consumer
            err.append(exc)
        finally:
            while True:
                try:
                    q.put(None, timeout=0.2)
                    break
                except queue.Full:
                    if consumer_dead.is_set():
                        break

    th = threading.Thread(target=stage_e, name="vdf-eval-stage", daemon=True)
    th.start()
    out = []
    try:
        while True:
            item = q.get()
            if item is None:
                break
            stmt, z0, dt_e = item
            proof, ok, dt_f = _fold_statement(pp, stmt, z0)
            out.append(StatementProof(stmt, z0, proof, ok, dt_e, dt_f))
    except BaseException as exc:
        consumer_dead.set()
        th.join()
        # partial progress, so a proving service can resume from the
        # failed statement
        exc.partial_proofs = out
        raise
    th.join()
    if err:
        err[0].partial_proofs = out
        raise err[0]
    return out


def _warm(pp: IVCParams) -> None:
    """Build, single-threaded, everything the chains would otherwise build
    lazily at once: ``functools.cached_property`` is not safe under
    concurrent first access, and two first launches would both run nvcc."""
    from ..fields import get_field

    for side in (pp.primary, pp.secondary):
        if not side.use_device:
            _ = side.host_plane
            continue
        _ = side.dev_shape, side.ck
        if not side._use_tp:
            _ = side.ck.table
    dev = pp.primary.device
    if pp.primary.use_device:
        for name in ("Fq", "Fp"):
            get_field(name).consts(dev)
        if dev.type == "cuda":
            from .._build import load_kernels

            load_kernels()
            torch.cuda.synchronize(dev)


class InterleavedProver:
    """K independent IVC chains folded concurrently on one device, in runs
    that can stop and resume.

    A single chain's fold loop alternates host work (witness synthesis,
    Fiat–Shamir) with device work (matvecs, commits) and waits on the card
    a few times a step, so neither side is ever fully busy.  K chains on K
    threads overlap one chain's host time with the others' waits: torch
    releases the GIL while it waits on the card, and the native tier's calls
    release it too.  This is the proving service's throughput mode: the
    aggregate folds/s across chains is the BASELINE north star's
    "aggregate" axis; a chain's own latency is the single-chain mode's.

    The constructor builds what the chains share (``_warm``) and runs each
    chain's base step.  ``run`` folds on one thread a chain (named
    ``ivc-chain-<k>``) and returns when every thread has stopped; a later
    ``run`` continues every chain where it stopped.  The counters, one slot a
    chain, each written only by its chain's thread: ``steps[k]``,
    ``wall_s[k]`` (the summed wall time of ``prove_step``) and ``cpu_s[k]``
    (the thread's own CPU time inside ``prove_step``, ``time.thread_time``);
    ``wall_s[k] - cpu_s[k]`` is the time the thread spent inside a step off
    the CPU: waiting for the GIL or blocked on the card.  Each chain keeps
    its own ``timer``."""

    def __init__(self, pp: IVCParams, z0s: list[list[int]]):
        _warm(pp)
        self.chains = [RecursiveIVC(pp, z0) for z0 in z0s]
        self.reset_counters()

    def reset_counters(self) -> None:
        k = len(self.chains)
        self.steps = [0] * k
        self.wall_s = [0.0] * k
        self.cpu_s = [0.0] * k

    def run(self, num_steps: int | None = None, until=None, on_step=None) -> None:
        """Fold every chain until it has ``num_steps - 1`` folds (its proof
        then covers ``num_steps`` steps), or until ``until()`` returns true;
        ``until`` is asked before each step, so a step begun finishes.
        ``on_step(k, seconds)``, where given, is called from chain k's thread
        after each of its steps with that step's wall time.  An exception in
        a chain's thread stops that chain and reaches the caller, once every
        thread has stopped, with ``partial_proofs`` attached: each chain's
        proof, None for a chain that failed."""
        if num_steps is None and until is None:
            raise ValueError("run needs num_steps or until")
        errs: list[BaseException | None] = [None] * len(self.chains)

        def fold(k: int):
            chain = self.chains[k]
            todo = math.inf if num_steps is None else num_steps - chain.i
            try:
                while todo > 0 and not (until is not None and until()):
                    w0, c0 = time.perf_counter(), time.thread_time()
                    chain.prove_step()
                    c1, w1 = time.thread_time(), time.perf_counter()
                    self.steps[k] += 1
                    self.wall_s[k] += w1 - w0
                    self.cpu_s[k] += c1 - c0
                    todo -= 1
                    if on_step is not None:
                        on_step(k, w1 - w0)
            except BaseException as exc:  # raised in the caller's thread below
                errs[k] = exc

        threads = [threading.Thread(target=fold, args=(k,), name=f"ivc-chain-{k}")
                   for k in range(len(self.chains))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        failed = next((exc for exc in errs if exc is not None), None)
        if failed is not None:
            failed.partial_proofs = [None if e is not None else c.proof()
                                     for c, e in zip(self.chains, errs)]
            raise failed

    def proofs(self) -> list[IVCProof]:
        return [c.proof() for c in self.chains]


def prove_interleaved(
    pp: IVCParams,
    z0s: list[list[int]],
    num_steps: int,
    starts: list[tuple[int, int, int]] | None = None,
) -> list[IVCProof]:
    """Fold several independent IVC chains concurrently on one device
    (``InterleavedProver``), ``num_steps`` steps each.

    Returns one IVCProof per chain, in z0s order.  Each chain is verified
    here when its ``starts`` entry (the chain's original VDF input) is
    given; a failure raises NovaError.  An exception in a chain's thread
    reaches the caller with ``partial_proofs`` attached: each chain's
    proof, None for a chain that failed."""
    prover = InterleavedProver(pp, z0s)
    prover.run(num_steps=num_steps)
    proofs = prover.proofs()
    if starts is not None:
        for proof, z0, start in zip(proofs, z0s, starts):
            if not ivc_verify(pp, proof, num_steps, z0, list(start)):
                raise NovaError("interleaved chain failed verification")
    return proofs
