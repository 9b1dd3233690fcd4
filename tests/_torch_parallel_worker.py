"""Worker for tests/test_torch_parallel.py: one rank of a gloo process group.

Joins the group through a ``file://`` store, builds the global mesh, and
runs the port's sharded functions against host ints: ``sharded_eval`` and
``sharded_check`` (K1/K2's plain versions on the rank's lanes),
``sharded_matvec``, ``sharded_msm`` (the port's ``msm`` on the rank's
block), and a tensor-parallel IVC fold on a 16-point key against the
native fold.  Prints ``ok <check>`` for each check and ``PARALLEL_OK`` at
the end.  Env: VDF_COORD, VDF_NPROC, VDF_PID.  Imports neither jax nor
vdf_tpu.
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


def _oracle(p: int, e: int, s: tuple, t: int) -> tuple:
    x, y, i = s
    for _ in range(t):
        x, y, i = pow((x + y) % p, e, p), (x + i) % p, (i + 1) % p
    return x, y, i


def check_eval(mesh) -> None:
    from vdf_tpu_torch.minroot import pallas_vdf
    from vdf_tpu_torch.parallel import lane_sharding, sharded_check, sharded_eval

    vdf = pallas_vdf()
    f = vdf.field
    p, e = f.params.modulus, f.params.inv_alpha
    rng = random.Random(5)
    starts = [(rng.randrange(p), rng.randrange(p), k) for k in range(6)]
    t = 2
    s0 = vdf.state_from_ints(*(list(c) for c in zip(*starts)), device="cpu")
    shard = sharded_eval(vdf, t, mesh)(s0)
    want = [_oracle(p, e, s, t) for s in starts]
    sl = lane_sharding(mesh, len(starts))
    assert list(zip(*vdf.state_to_ints(shard))) == want[sl], "sharded_eval"
    print("ok eval", flush=True)

    result = vdf.state_from_ints(*(list(c) for c in zip(*want)), device="cpu")
    check = sharded_check(vdf, t, mesh)
    assert check(result, s0) == 6, "sharded_check"
    bad = list(want)
    bad[5] = (bad[5][0] ^ 1, *bad[5][1:])  # a lane of the last rank's block
    assert check(vdf.state_from_ints(*(list(c) for c in zip(*bad)), device="cpu"), s0) == 5
    print("ok check", flush=True)


def check_matvec(mesh) -> None:
    from vdf_tpu_torch.fields import get_field
    from vdf_tpu_torch.nova import InverseMinRootCircuit
    from vdf_tpu_torch.nova.r1cs_device import DeviceShape
    from vdf_tpu_torch.parallel import distributed, sharded_matvec
    from vdf_tpu_torch.r1cs.cs import ShapeCS
    from vdf_tpu_torch.r1cs.gadgets import AllocatedNum

    f = get_field("Fq")
    p = f.params.modulus
    cs = ShapeCS(p)
    z = [AllocatedNum.alloc_input(cs, n) for n in ("z_x", "z_y", "z_i")]
    InverseMinRootCircuit(32).synthesize(cs, z)
    shape = cs.shape()
    dev = DeviceShape.build(f, shape, mesh.device)
    rng = random.Random(6)
    z_ints = [rng.randrange(p) for _ in range(shape.num_vars)]
    z_dev = distributed.replicate(mesh, f.encode(z_ints, "cpu").numpy())
    for name, mat, coo in (("A", dev.a, shape.a_coo), ("B", dev.b, shape.b_coo),
                           ("C", dev.c, shape.c_coo)):
        want = [0] * shape.num_cons
        for r, c, v in zip(*coo):
            want[int(r)] = (want[int(r)] + int(v) * z_ints[int(c)]) % p
        got = sharded_matvec(f, mat, z_dev, mesh)
        assert f.decode(got) == want, f"sharded_matvec {name}"
    print(f"ok matvec ({shape.num_cons} rows, {dev.a.rows.shape[0]} entries of A)", flush=True)


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
    """The device engine's fold with the mesh attached (sharded matvecs, two
    sharded MSMs) equals the native fold, and its check_sat holds."""
    from vdf_tpu_torch.fields import get_field, get_int_field
    from vdf_tpu_torch.nova import InverseMinRootCircuit
    from vdf_tpu_torch.nova.ivc import (
        CanonicalWitness,
        HostInstance,
        HostRelaxedInstance,
        Side,
        ivc_public_params,
    )
    from vdf_tpu_torch.r1cs.cs import ShapeCS, Variable
    from vdf_tpu_torch.r1cs.gadgets import AllocatedNum
    from vdf_tpu_torch.r1cs.witness import WitnessCS

    fq = get_field("Fq")
    p = get_int_field("Fq").p
    cs = ShapeCS(p)  # InverseMinRootCircuit(2), z_x and z_y public: a key of 16
    z = [AllocatedNum.alloc_input(cs, "z_x"), AllocatedNum.alloc_input(cs, "z_y"),
         AllocatedNum(cs.alloc("z_i"))]
    InverseMinRootCircuit(2).synthesize(cs, z)
    shape = cs.shape()
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
