"""The port's kernel build and wrapper dispatch (vdf_tpu_torch._build,
vdf_tpu_torch.fields.kernels, vdf_tpu_torch.curves.kernels).

On the CPU: the build refuses to go on without nvcc, a CPU tensor takes
the plain version without touching the launch counters, and malformed
input raises.  The ``gpu`` tests run the CUDA kernels against their plain
versions and skip where ``torch.cuda.is_available()`` is False:

    python -m pytest tests/test_torch_build.py -q -m gpu --noconftest
"""

import functools
import re

import numpy as np
import pytest
import torch

from vdf_tpu_torch import _build
from vdf_tpu_torch.curves import CURVES, get_curve, hash_to_curve_ints, stack_point
from vdf_tpu_torch.curves import kernels as CK
from vdf_tpu_torch.curves.bucket_msm import layout
from vdf_tpu_torch.errors import KernelError
from vdf_tpu_torch.fields import FIELDS, get_field
from vdf_tpu_torch.fields.kernels import (
    LAUNCHES,
    minroot_eval,
    minroot_eval_plain,
    minroot_inverse,
    minroot_inverse_plain,
    reset_launches,
)
from vdf_tpu_torch.fields.params import int_to_limbs

# The plain versions are many small tensor ops: one intra-op thread runs
# them fastest, and test workers sharing the cores do not oversubscribe
# them (with a thread pool per worker they ran ~10x slower under load).
torch.set_num_threads(1)


def state(name: str, lanes: int, seed: int, device="cpu"):
    p = FIELDS[name].modulus
    nrng = np.random.default_rng(seed)
    f = get_field(name)
    return tuple(
        f.encode([int(v) % p for v in nrng.integers(0, 1 << 63, size=lanes)], device)
        for _ in range(3)
    )


def test_load_kernels_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_kernels.cache_clear()
    try:
        with pytest.raises(KernelError, match="nvcc not found"):
            _build.load_kernels()
    finally:
        _build.load_kernels.cache_clear()
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").rglob("*.so"))


def test_constants_header_matches_params():
    text = _build.constants_header()
    assert int(re.search(r"VDF_N_DIGITS (\d+)", text).group(1)) == 64
    digits = re.search(r"VDF_DIGITS_INIT \{(.*)\}", text).group(1)
    rows = re.findall(r"\{([^{}]*)\}", digits)
    for name, row in zip(("Fp", "Fq"), rows):
        assert [int(d) for d in row.split(",")] == FIELDS[name].inv_alpha_digits
    consts = re.search(r"VDF_FIELD_CONSTS_INIT (.*)", text).group(1)
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]+)u", consts)]
    assert len(words) == 2 * (3 * 8 + 1)
    for k, name in enumerate(("Fp", "Fq")):
        P = FIELDS[name]
        w = words[k * 25 : (k + 1) * 25]
        assert w[0:8] == int_to_limbs(P.modulus).tolist()
        assert w[8:16] == int_to_limbs(2 * P.modulus).tolist()
        assert w[16:24] == int_to_limbs(P.mont_one).tolist()
        assert (w[24] * P.modulus) % (1 << 32) == (1 << 32) - 1  # -1/p mod 2^32
    curve = re.search(r"VDF_CURVE_CONSTS_INIT (.*)", text).group(1)
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]+)u", curve)]
    assert len(words) == 2 * 16
    for k, name in enumerate(("Fp", "Fq")):
        P = FIELDS[name]
        w = words[k * 16 : (k + 1) * 16]
        assert w[0:8] == int_to_limbs(15 * P.r % P.modulus).tolist()  # 3b, Montgomery
        assert w[8:16] == int_to_limbs(P.r * P.r % P.modulus).tolist()  # R^2 mod p
    assert _build.build_key() == _build.build_key()
    assert set(_build.LAUNCHERS) >= {"vdf_minroot_eval", "vdf_scan", "vdf_bucket", "vdf_horner"}
    assert len(_build.LAUNCHERS["vdf_canon_digits"]) == 8  # the layout flag before the stream


@pytest.mark.parametrize("name", ["Fp", "Fq"])
def test_cpu_tensor_takes_plain_version_and_counts_nothing(name):
    reset_launches()
    s = state(name, 5, seed=1)
    fwd = minroot_eval(name, *s, 2)
    assert all(torch.equal(a, b) for a, b in zip(fwd, minroot_eval_plain(name, *s, 2)))
    back = minroot_inverse(name, *fwd, 2)
    assert all(torch.equal(a, b) for a, b in zip(back, minroot_inverse_plain(name, *fwd, 2)))
    assert all(torch.equal(a, b) for a, b in zip(back, s))
    assert LAUNCHES == {"minroot_eval": 0, "minroot_inverse": 0}


def _bad_inputs():
    x, y, i = state("Fq", 4, seed=2)
    return {
        "dtype": (x.to(torch.int64), y, i),
        "width": (x[:, :7].contiguous(), y[:, :7].contiguous(), i[:, :7].contiguous()),
        "rank": (x.reshape(-1), y.reshape(-1), i.reshape(-1)),
        "strided": (x.t().contiguous().t(), y, i),
        "mismatch": (x[:3].contiguous(), y, i),
        "not_tensor": (x.numpy(), y, i),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
@pytest.mark.parametrize("wrapper", [minroot_eval, minroot_inverse], ids=["eval", "inverse"])
def test_wrappers_reject_malformed_state(wrapper, case):
    with pytest.raises(KernelError):
        wrapper("Fq", *_bad_inputs()[case], 1)


def test_wrappers_reject_bad_field_t_and_device():
    s = state("Fp", 2, seed=3)
    with pytest.raises(KernelError, match="unknown field"):
        minroot_eval("F17", *s, 1)
    with pytest.raises(KernelError, match="nonnegative"):
        minroot_inverse("Fp", *s, -1)
    meta = tuple(a.to("meta") for a in s)
    with pytest.raises(KernelError, match="no kernel for device"):
        minroot_eval("Fp", *meta, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["Fp", "Fq"])
def test_kernels_match_plain_on_card(cuda, name):
    """K1/K2 on random lanes (a ragged block edge) vs their plain versions
    on the same CUDA tensors; both launches counted."""
    reset_launches()
    s = state(name, 300, seed=4, device=cuda)
    fwd = minroot_eval(name, *s, 3)
    back = minroot_inverse(name, *fwd, 3)
    assert LAUNCHES == {"minroot_eval": 1, "minroot_inverse": 1}
    want_fwd = minroot_eval_plain(name, *s, 3)
    assert all(torch.equal(a, b) for a, b in zip(fwd, want_fwd))
    assert all(torch.equal(a, b) for a, b in zip(back, minroot_inverse_plain(name, *fwd, 3)))
    assert all(torch.equal(a, b) for a, b in zip(back, s))


@pytest.mark.gpu
def test_kernels_canonicalise_any_limbs_on_card(cuda):
    """All-ones limbs (2^256 - 1, above p) go in canonicalised, as the
    plain versions do."""
    ones = torch.full((70, 8), -1, dtype=torch.int32, device=cuda)
    for kern, plain in ((minroot_eval, minroot_eval_plain),
                        (minroot_inverse, minroot_inverse_plain)):
        got = kern("Fq", ones, ones, ones, 1)
        assert all(torch.equal(a, b) for a, b in zip(got, plain("Fq", ones, ones, ones, 1)))


def test_default_device_raises_without_a_card(monkeypatch):
    """No entry point falls back to the CPU: with no CUDA device a call
    that names no device raises, and naming the CPU still works."""
    import vdf_tpu_torch
    from vdf_tpu_torch import commitment_key, pallas_vdf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KernelError, match="no CUDA device"):
        vdf_tpu_torch.default_device()
    with pytest.raises(KernelError, match="no CUDA device"):
        pallas_vdf().state_from_ints(x=1)
    with pytest.raises(KernelError, match="no CUDA device"):
        get_field("Fq").encode([1, 2])
    with pytest.raises(KernelError, match="no CUDA device"):
        get_curve("pallas").generator()
    with pytest.raises(KernelError, match="no CUDA device"):
        commitment_key("pallas", 4)
    assert pallas_vdf().state_from_ints(x=1, device="cpu").x.device.type == "cpu"


@pytest.mark.gpu
def test_default_device_is_the_card(cuda):
    from vdf_tpu_torch import pallas_vdf

    s = pallas_vdf().state_from_ints(x=1)
    assert all(a.device == cuda for a in s)


# ---------------------------------------------------------------------
# the bucket-accumulation kernels K3-K7 and K9 (curves/kernels.py)
# ---------------------------------------------------------------------


def commit_inputs(curve_name: str, n: int, k: int, rows: int, device="cpu"):
    """Generators (n, 3, 8), their table (W n, 3, 8), and sorted keys of
    (k, n) random scalars (with 0, 1, q - 1), all on ``device``."""
    c = get_curve(curve_name)
    params = CURVES[curve_name]
    gens = stack_point(c.from_affine_ints(
        hash_to_curve_ints(curve_name, n, domain=b"vdf_tpu/t"), device="cpu")).contiguous()
    table = CK.shift_gens_plain(params.base_field, gens)
    q = c.scalar.params.modulus
    nrng = np.random.default_rng(11)
    vals = [int(v) % q for v in nrng.integers(0, 1 << 63, size=k * n)]
    vals[:3] = [0, 1, q - 1][: k * n]
    s = c.scalar.encode(vals, device="cpu").reshape(k, n, 8)
    _, m_pad = layout(n, rows)
    keys = torch.sort(CK.canon_digits_plain(params.scalar_field, s, m_pad), -1).values
    return tuple(a.to(device) for a in (gens, table, s, keys))


def commit_stages(bf: str, sf: str, gens, table, s, keys, rows: int, plain: bool):
    """Every K3-K7 and K9 stage on the same inputs, through the wrappers or
    their plain versions.  K9's window sums are the table's rows, (n, W, 3, 8);
    K3's window-row layout pads each row by one key."""
    fns = {name: getattr(CK, name + ("_plain" if plain else "")) for name in (
        "canon_digits", "canon_mont", "shift_gens", "bucket_scan", "column_carries",
        "bucket_sums", "horner")}
    n = gens.shape[0]
    window_sums = table.reshape(CK.WINDOWS, n, 3, 8).transpose(0, 1).contiguous()
    ints = gens[:, 0].contiguous()
    scan = fns["bucket_scan"](bf, table, keys, rows)
    carries = fns["column_carries"](bf, scan[2], scan[3])
    return {
        "canon_digits": fns["canon_digits"](sf, s, keys.shape[1]),
        "canon_mont": fns["canon_mont"](bf, ints),
        "shift_gens": fns["shift_gens"](bf, gens),
        "scan": scan,
        "colscan": carries,
        "bucket": fns["bucket_sums"](bf, scan[0], scan[1], carries),
        "canon_digits_rows": fns["canon_digits"](sf, s, n + 1, True),
        "horner": fns["horner"](bf, window_sums),
    }


@functools.cache
def cpu_case():
    """Pallas inputs (n = 3, K = 1, rows = 4) and each stage's plain output."""
    ins = commit_inputs("pallas", 3, 1, 4)
    return ins, commit_stages("Fp", "Fq", *ins, 4, plain=True)


def test_commit_wrappers_take_plain_version_on_cpu_and_count_nothing():
    CK.reset_launches()
    ins, want = cpu_case()
    got = commit_stages("Fp", "Fq", *ins, 4, plain=False)
    for name in got:
        g = got[name] if isinstance(got[name], tuple) else (got[name],)
        w = want[name] if isinstance(want[name], tuple) else (want[name],)
        assert all(torch.equal(a, b) for a, b in zip(g, w)), name
    assert set(CK.LAUNCHES.values()) == {0}


def _bad_commit_calls():
    (gens, table, s, keys), out = cpu_case()
    tails, tail_col, sums, flags = out["scan"]
    carries = out["colscan"]
    return {
        "digits_dtype": lambda: CK.canon_digits("Fq", s.to(torch.int64), keys.shape[1]),
        "digits_m_pad": lambda: CK.canon_digits("Fq", s, 3),
        "digits_rank": lambda: CK.canon_digits("Fq", s[0], keys.shape[1]),
        "mont_width": lambda: CK.canon_mont("Fp", gens[:, 0, :7].contiguous()),
        "gens_strided": lambda: CK.shift_gens("Fp", gens.transpose(0, 1)),
        "gens_field": lambda: CK.shift_gens("F17", gens),
        "scan_rows": lambda: CK.bucket_scan("Fp", table, keys, 5),
        "scan_keys_dtype": lambda: CK.bucket_scan("Fp", table, keys.to(torch.int32), 4),
        "scan_not_tensor": lambda: CK.bucket_scan("Fp", table.numpy(), keys, 4),
        "colscan_flags": lambda: CK.column_carries("Fp", sums, flags[:, :1].contiguous()),
        "bucket_width": lambda: CK.bucket_sums("Fp", tails[:, :100].contiguous(),
                                               tail_col, carries),
        "bucket_device": lambda: CK.bucket_sums("Fp", tails.to("meta"), tail_col.to("meta"),
                                                carries.to("meta")),
        "digits_rows_m_pad": lambda: CK.canon_digits("Fq", s, 2, True),
        "horner_windows": lambda: CK.horner("Fp", table[None, :21].contiguous()),
        "horner_dtype": lambda: CK.horner("Fp", table[None, :22].to(torch.int64)),
    }


BAD_COMMIT_CALLS = [
    "digits_dtype", "digits_m_pad", "digits_rank", "mont_width", "gens_strided", "gens_field",
    "scan_rows", "scan_keys_dtype", "scan_not_tensor", "colscan_flags", "bucket_width",
    "bucket_device", "digits_rows_m_pad", "horner_windows", "horner_dtype",
]


def test_bad_commit_call_list_is_complete():
    assert sorted(_bad_commit_calls()) == sorted(BAD_COMMIT_CALLS)


@pytest.mark.parametrize("case", BAD_COMMIT_CALLS)
def test_commit_wrappers_reject_malformed_input(case):
    with pytest.raises(KernelError):
        _bad_commit_calls()[case]()


@pytest.mark.gpu
@pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
def test_commit_kernels_match_plain_on_card(cuda, curve_name):
    """K3 (both modes, both key layouts), K4, K5, K6, K7 and K9 on the card
    vs their plain versions on the same CUDA tensors (K = 2, n = 6, rows = 5:
    a ragged last column); each launch counted once."""
    params = CURVES[curve_name]
    ins = commit_inputs(curve_name, 6, 2, 5, device=cuda)
    CK.reset_launches()
    got = commit_stages(params.base_field, params.scalar_field, *ins, 5, plain=False)
    assert CK.LAUNCHES == {**dict.fromkeys(CK.LAUNCHES, 1), "canon_digits": 2}
    want = commit_stages(params.base_field, params.scalar_field, *ins, 5, plain=True)
    for name in got:
        g = got[name] if isinstance(got[name], tuple) else (got[name],)
        w = want[name] if isinstance(want[name], tuple) else (want[name],)
        assert all(torch.equal(a, b) for a, b in zip(g, w)), name


@pytest.mark.gpu
@pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
def test_commit_on_card_matches_native(cuda, curve_name):
    """commitment_key(curve, 40).commit on CUDA == the native Pippenger."""
    from vdf_tpu_torch.native import msm_native_affine
    from vdf_tpu_torch.nova import commitment_key

    c = get_curve(curve_name)
    ck = commitment_key(curve_name, 40, device=cuda)
    q = c.scalar.params.modulus
    vals = [int(v) % q for v in np.random.default_rng(12).integers(0, 1 << 63, size=40)]
    pt = ck.commit(c.scalar.encode(vals, cuda))
    got = c.to_affine_ints(type(pt)(*(v[None] for v in pt)))[0]
    assert got == msm_native_affine(curve_name, c.to_affine_ints(ck.gens), vals)


@pytest.mark.gpu
@pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
def test_msm_on_card_matches_native(cuda, curve_name):
    """msm on CUDA (K3 window rows, K4-K6, K9) == the native Pippenger at
    n = 45 (three columns, the last ragged)."""
    from vdf_tpu_torch.curves import msm
    from vdf_tpu_torch.native import msm_native_affine

    c, n = get_curve(curve_name), 45
    pts = hash_to_curve_ints(curve_name, n, domain=b"vdf_tpu/t")
    q = c.scalar.params.modulus
    vals = [int(v) % q for v in np.random.default_rng(13).integers(0, 1 << 63, size=n)]
    CK.reset_launches()
    pt = msm(c, c.from_affine_ints(pts), c.scalar.encode(vals))
    assert CK.LAUNCHES["horner"] == 1 and CK.LAUNCHES["scan"] == 1
    got = c.to_affine_ints(type(pt)(*(v[None] for v in pt)))[0]
    assert got == msm_native_affine(curve_name, pts, vals)
