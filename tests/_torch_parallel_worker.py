"""Worker for tests/test_torch_parallel.py: one rank of a gloo process group.

Joins the group through a ``file://`` store, builds the global mesh, and
runs the port's sharded functions against host ints through the dry run's
sections (``vdf_tpu_torch.entry``): ``section_dp`` (``sharded_eval`` and
``sharded_check``, K1/K2's plain versions on the rank's lanes) and a
tampered lane, ``section_matvec``, ``sharded_msm`` (the port's ``msm`` on
the rank's block) at a padded length, and ``section_tp_fold`` (a
tensor-parallel IVC fold on a 16-point key against the native fold) with a
deferred-commit fold and its check_sat.  Prints ``ok <check>`` for each
check and ``PARALLEL_OK`` at the end.  Env: VDF_COORD, VDF_NPROC, VDF_PID.
Imports neither jax nor vdf_tpu.
"""

from __future__ import annotations

import dataclasses
import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

torch.set_num_threads(1)


def check_eval(mesh) -> None:
    from vdf_tpu_torch.entry import DP_T, minroot_oracle, section_dp
    from vdf_tpu_torch.minroot import pallas_vdf
    from vdf_tpu_torch.parallel import sharded_check

    vdf = pallas_vdf()
    f = vdf.field
    p, e = f.params.modulus, f.params.inv_alpha
    rng = random.Random(5)
    starts = [(rng.randrange(p), rng.randrange(p), k) for k in range(6)]
    t = DP_T
    assert section_dp(mesh, starts) == {"lanes": 6, "t": t, "valid": 6}
    print("ok eval", flush=True)

    s0 = vdf.state_from_ints(*(list(c) for c in zip(*starts)), device="cpu")
    bad = [minroot_oracle(p, e, s, t) for s in starts]
    bad[5] = (bad[5][0] ^ 1, *bad[5][1:])  # a lane of the last rank's block
    check = sharded_check(vdf, t, mesh)
    assert check(vdf.state_from_ints(*(list(c) for c in zip(*bad)), device="cpu"), s0) == 5
    print("ok check", flush=True)


def check_matvec(mesh) -> None:
    from vdf_tpu_torch.entry import section_matvec
    from vdf_tpu_torch.nova import public_params

    pp = public_params(32, device="cpu")
    rng = random.Random(6)
    z = [rng.randrange(pp.field.params.modulus) for _ in range(pp.dev_shape.shape.num_vars)]
    got = section_matvec(mesh, 32, z)
    print(f"ok matvec ({got['rows']} rows, {got['entries']} entries of A, B and C)", flush=True)


def check_msm(mesh) -> None:
    from vdf_tpu_torch.curves import get_curve, get_int_curve, hash_to_curve_ints
    from vdf_tpu_torch.curves.int_ops import IDENTITY
    from vdf_tpu_torch.curves.point import Point
    from vdf_tpu_torch.parallel import sharded_msm

    curve, ic = get_curve("pallas"), get_int_curve("pallas")
    n = 63  # padded to 64: a zero scalar on the last rank
    aff = hash_to_curve_ints("pallas", n, domain=b"multihost")
    pts = curve.from_affine_ints(aff, mesh.device)
    scal = [7 * k + 3 for k in range(n)]
    got = sharded_msm(curve, pts, curve.scalar.encode(scal, mesh.device), mesh)
    acc = IDENTITY
    for a, s in zip(aff, scal):
        acc = ic.add(acc, ic.scalar_mul(ic.from_affine(a), s))
    assert curve.to_affine_ints(Point(*(v[None] for v in got)))[0] == ic.to_affine(acc)
    print("ok msm", flush=True)


def check_tp_fold(mesh) -> None:
    """The dry run's TP fold section on a 16-point key (the reference's
    inputs, a committed strict instance), then the device engine's fold of
    a satisfying witness with its commit deferred (sharded matvecs, two
    sharded MSMs) equal to the native fold, and its check_sat."""
    from vdf_tpu_torch.entry import TP_PATH, bare_shape, section_tp_fold
    from vdf_tpu_torch.fields import get_field, get_int_field
    from vdf_tpu_torch.nova import InverseMinRootCircuit
    from vdf_tpu_torch.nova.ivc import (
        CanonicalWitness,
        HostInstance,
        HostRelaxedInstance,
        Side,
        ivc_public_params,
    )
    from vdf_tpu_torch.r1cs.cs import Variable
    from vdf_tpu_torch.r1cs.gadgets import AllocatedNum
    from vdf_tpu_torch.r1cs.witness import WitnessCS

    got = section_tp_fold(mesh, fold_iters=2)
    assert (got["key"], got["path"]) == (16, TP_PATH)

    fq = get_field("Fq")
    shape = bare_shape(2)  # InverseMinRootCircuit(2), z_x and z_y public: a key of 16
    dev = Side(None, shape, fq, "pallas", "Fp", "device", mesh.device, mesh)
    nat = Side(None, shape, fq, "pallas", "Fp", "native")
    assert dev._use_tp and dev.ck.n == 16

    rng = random.Random(7)
    x, y, i = (rng.randrange(1 << 250) for _ in range(3))
    wcs = WitnessCS(get_int_field("Fq"), inputs=[x, y], check=True)
    zw = [AllocatedNum(Variable("input", 1), x), AllocatedNum(Variable("input", 2), y),
          AllocatedNum(wcs.alloc("z_i", value=i), i)]
    InverseMinRootCircuit(2).synthesize(wcs, zw)
    assert not wcs.failed
    w = wcs.aux

    d = 0xD16E57
    U0 = HostRelaxedInstance.default()
    u_n = HostInstance(nat.host_plane.commit(w), [x, y])
    u_d = HostInstance(None, [x, y])
    U_n, W_n, E_n, ct_n, r_n = nat.fold(d, U0, nat.zero_w(), nat.zero_e(), u_n, w)
    U_d, W_d, E_d, ct_d, r_d, _ = dev.fold_cached(
        d, U0, dev.zero_w(), dev.zero_e(), u_d, CanonicalWitness(fq.encode_canonical(w, mesh.device)),
        None)
    assert u_d.comm_w == u_n.comm_w and (ct_d, r_d) == (ct_n, r_n), "TP fold commitments"
    assert dataclasses.asdict(U_d) == dataclasses.asdict(U_n), "TP fold instance"
    assert fq.decode(W_d) == W_n and fq.decode(E_d) == E_n, "TP fold witnesses"
    assert dev.check_sat(U_d, W_d, E_d) and nat.check_sat(U_n, W_n, E_n)
    print("ok tp_fold", flush=True)

    pp = ivc_public_params(1, device=mesh.device, mesh=mesh)
    assert pp.primary.mesh is mesh and pp.secondary._use_tp
    assert pp is ivc_public_params(1, device=mesh.device, mesh=mesh)
    assert pp is not ivc_public_params(1, device=mesh.device)  # the cache key holds the mesh
    print("ok tp_params", flush=True)


def main() -> None:
    import torch.distributed as dist

    from vdf_tpu_torch import ProverConfig
    from vdf_tpu_torch.parallel import SHARD_AXIS, distributed, lane_sharding, make_mesh

    nproc, pid = int(os.environ["VDF_NPROC"]), int(os.environ["VDF_PID"])
    distributed.initialize(os.environ["VDF_COORD"], nproc, pid, device="cpu")
    assert dist.get_backend() == "gloo"
    mesh = distributed.global_mesh()
    assert (mesh.size, mesh.rank, mesh.device.type, mesh.axis) == (nproc, pid, "cpu", SHARD_AXIS)
    assert ProverConfig(shards=nproc, device="cpu").mesh() is mesh
    rows = np.arange(33).reshape(11, 3)
    assert distributed.distribute(mesh, rows).tolist() == rows[lane_sharding(mesh, 11)].tolist()
    assert distributed.replicate(mesh, rows).tolist() == rows.tolist()
    try:
        one = make_mesh(1)  # a smaller mesh: a new group, made by every rank
        assert pid == 0 and one.size == 1 and one.group is not None
    except ValueError:
        assert pid != 0
    try:
        ProverConfig(shards=nproc + 1).mesh()
        raise AssertionError("a mesh larger than the group was made")
    except ValueError:
        pass
    print("ok mesh", flush=True)

    check_eval(mesh)
    check_matvec(mesh)
    check_msm(mesh)
    check_tp_fold(mesh)
    dist.destroy_process_group()
    print("PARALLEL_OK", flush=True)


if __name__ == "__main__":
    main()
