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
    assert int(re.search(r"VDF_B3 (\d+)u", text).group(1)) == 15  # 3b, for the small multiply
    digits = re.search(r"VDF_DIGITS_INIT \{(.*)\}", text).group(1)
    rows = re.findall(r"\{([^{}]*)\}", digits)
    for name, row in zip(("Fp", "Fq"), rows):
        assert [int(d) for d in row.split(",")] == FIELDS[name].inv_alpha_digits
    def table(macro):
        words = [int(w, 16) for w in re.findall(
            r"0x([0-9a-f]+)u", re.search(rf"{macro} (.*)", text).group(1))]
        assert len(words) == 2 * 8
        return words[:8], words[8:]

    for k, name in enumerate(("Fp", "Fq")):
        P = FIELDS[name]
        assert table("VDF_P_INIT")[k] == int_to_limbs(P.modulus).tolist()
        assert table("VDF_TWO_P_INIT")[k] == int_to_limbs(2 * P.modulus).tolist()
        assert table("VDF_ONE_INIT")[k] == int_to_limbs(P.mont_one).tolist()
        assert table("VDF_B3_INIT")[k] == int_to_limbs(15 * P.r % P.modulus).tolist()  # 3b
        assert table("VDF_R2_INIT")[k] == int_to_limbs(P.r * P.r % P.modulus).tolist()
        # the shape csrc/field.cuh's reduction is written for
        limbs = table("VDF_P_INIT")[k]
        assert limbs[0] == 1 and limbs[4:7] == [0, 0, 0] and limbs[7] == 1 << 30
        assert (-pow(P.modulus, -1, 1 << 32)) % (1 << 32) == (1 << 32) - 1
    assert _build.build_key() == _build.build_key()
    assert set(_build.LAUNCHERS) >= {"vdf_minroot_eval", "vdf_scan", "vdf_bucket", "vdf_horner"}
    # the layout flag and the key width before the stream
    assert len(_build.LAUNCHERS["vdf_canon_digits"]) == 9
    # K5: sums, flags, three scratch buffers, carries, cols, batch, columns a thread;
    # K6: tails, tail_col, carries, scratch, out, cols, batch, chunk bits, threads.
    assert len(_build.LAUNCHERS["vdf_colscan"]) == 11 and len(_build.LAUNCHERS["vdf_bucket"]) == 11
    # K10: field, op, a, b, c, out, n, broadcast bits; K11: field, x, offsets, out,
    # segments, segment length; K12: field, offsets, cols, vals, z, out, rows; each + stream
    assert len(_build.LAUNCHERS["vdf_field_ew"]) == 9
    assert len(_build.LAUNCHERS["vdf_field_segsum"]) == 7
    assert len(_build.LAUNCHERS["vdf_r1cs_matvec"]) == 8


@pytest.mark.parametrize("modulus", [
    (1 << 254) + (0x224698FC094CF91B992D30ED << 32) + 3,  # p[0] = 3
    (1 << 254) + (1 << 128) + 1,  # p[4] = 1
    (1 << 254) + (1 << 224) + 1,  # p[7] = 2^30 + 1
], ids=["low_limb", "middle_limb", "top_limb"])
def test_constants_header_refuses_a_modulus_of_another_shape(monkeypatch, modulus):
    """csrc/field.cuh's reduction is written for p = 1 + c 2^32 + 2^254; the
    build must refuse any other modulus, not miscompute with it."""
    from vdf_tpu_torch.fields.params import FieldParams

    other = FieldParams("Fp", modulus, FIELDS["Fp"].inv_alpha)
    monkeypatch.setitem(_build.FIELDS, "Fp", other)
    with pytest.raises(KernelError, match="needs a modulus"):
        _build.constants_header()
    monkeypatch.undo()
    assert "VDF_P_INIT" in _build.constants_header()


@pytest.mark.parametrize("name", ["Fp", "Fq"])
def test_cpu_tensor_takes_plain_version_and_counts_nothing(name):
    reset_launches()
    s = state(name, 5, seed=1)
    fwd = minroot_eval(name, *s, 2)
    assert all(torch.equal(a, b) for a, b in zip(fwd, minroot_eval_plain(name, *s, 2)))
    back = minroot_inverse(name, *fwd, 2)
    assert all(torch.equal(a, b) for a, b in zip(back, minroot_inverse_plain(name, *fwd, 2)))
    assert all(torch.equal(a, b) for a, b in zip(back, s))
    assert LAUNCHES == dict.fromkeys(LAUNCHES, 0)


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
    assert LAUNCHES == {**dict.fromkeys(LAUNCHES, 0), "minroot_eval": 1, "minroot_inverse": 1}
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
        "digits_key_bits": lambda: CK.canon_digits("Fq", s, keys.shape[1], key_bits=16),
        "mont_width": lambda: CK.canon_mont("Fp", gens[:, 0, :7].contiguous()),
        "gens_strided": lambda: CK.shift_gens("Fp", gens.transpose(0, 1)),
        "gens_field": lambda: CK.shift_gens("F17", gens),
        "scan_rows": lambda: CK.bucket_scan("Fp", table, keys, 5),
        "scan_keys_dtype": lambda: CK.bucket_scan("Fp", table, keys.to(torch.int16), 4),
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
    "digits_dtype", "digits_m_pad", "digits_rank", "digits_key_bits", "mont_width", "gens_strided", "gens_field",
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


@pytest.mark.gpu
def test_scan_and_horner_launchers_refuse_a_bad_form(cuda):
    """vdf_scan takes form 0 (a thread a column) or form 1 (a group of 8
    threads a column, columns of at most 64 rows), vdf_horner field 0 or 1:
    anything else is refused with cudaErrorInvalidValue before a launch, and
    every good call launches and equals the plain version."""
    invalid_value = 1  # cudaErrorInvalidValue
    lib = _build.load_kernels().lib
    _, table, _, keys = commit_inputs("pallas", 6, 1, 5, device=cuda)
    k, m_pad = keys.shape
    window_sums = table[: CK.WINDOWS][None].contiguous()
    stream = torch.cuda.current_stream().cuda_stream

    def scan(form, rows=5, keys=keys):
        m_pad = keys.shape[1]
        cols = m_pad // rows
        out = (CK._identity_rows("Fp", (k, CK.NB), cuda),
               torch.full((k, CK.NB), -1, dtype=torch.int32, device=cuda),
               torch.empty((k, cols, 3, 8), dtype=torch.int32, device=cuda),
               torch.empty((k, cols), dtype=torch.int32, device=cuda))
        err = lib.vdf_scan(0, table.data_ptr(), keys.data_ptr(), *(a.data_ptr() for a in out),
                           m_pad, rows, cols, k, form, CK.key_bits_of(keys), stream)
        return err, out

    def horner(field):
        out = torch.empty((1, 3, 8), dtype=torch.int32, device=cuda)
        return lib.vdf_horner(field, window_sums.data_ptr(), out.data_ptr(), 1, stream), out

    tall = torch.sort(torch.cat([keys] * 13, dim=1), dim=1).values  # 65 rows a column
    for form, rows, a in ((2, 5, keys), (-1, 5, keys), (8, 5, keys), (1, 65, tall)):
        assert scan(form, rows, a)[0] == invalid_value, (form, rows)
    for field in (-1, 2):
        assert horner(field)[0] == invalid_value, field
    for form, rows, a in ((0, 5, keys), (1, 5, keys), (0, 65, tall)):
        err, out = scan(form, rows, a)
        torch.cuda.synchronize()
        want = CK.bucket_scan_plain("Fp", table, a, rows)
        assert err == 0 and all(torch.equal(x, y) for x, y in zip(out, want)), (form, rows)
    err, out = horner(0)
    torch.cuda.synchronize()
    assert err == 0 and torch.equal(out, CK.horner_plain("Fp", window_sums))


@pytest.mark.gpu
def test_shift_gens_canon_digits_and_scan_launchers_refuse_bad_arguments(cuda):
    """vdf_shift_gens takes form 0 (a thread a generator) or 1 (a group of 8
    threads a generator), vdf_canon_digits and vdf_scan key width 32 or 64,
    and vdf_canon_digits 32-bit keys only for rows of at most 2^20 items:
    anything else is refused with cudaErrorInvalidValue before a launch, and
    every good call launches and equals the plain version."""
    invalid_value = 1  # cudaErrorInvalidValue
    lib = _build.load_kernels().lib
    gens, table, s, keys = commit_inputs("pallas", 6, 1, 5, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def shift(form):
        out = torch.empty((CK.WINDOWS * 6, 3, 8), dtype=torch.int32, device=cuda)
        return lib.vdf_shift_gens(0, gens.data_ptr(), out.data_ptr(), 6, form, stream), out

    def digits(key_bits, n=6, count=6, m_pad=None):
        m_pad = CK.WINDOWS * n if m_pad is None else m_pad
        out = torch.empty((1, m_pad), dtype=CK.KEY_DTYPES.get(key_bits, torch.int64),
                          device=cuda)
        err = lib.vdf_canon_digits(1, s.data_ptr(), out.data_ptr(), n, count, m_pad, 0,
                                   key_bits, stream)
        return err, out

    def scan(key_bits):
        cols = keys.shape[1] // 5
        out = (CK._identity_rows("Fp", (1, CK.NB), cuda),
               torch.full((1, CK.NB), -1, dtype=torch.int32, device=cuda),
               torch.empty((1, cols, 3, 8), dtype=torch.int32, device=cuda),
               torch.empty((1, cols), dtype=torch.int32, device=cuda))
        return lib.vdf_scan(0, table.data_ptr(), keys.data_ptr(), *(a.data_ptr() for a in out),
                            keys.shape[1], 5, cols, 1, 0, key_bits, stream)

    for form in (-1, 2):
        assert shift(form)[0] == invalid_value, form
    for key_bits in (0, 16, 63):
        assert digits(key_bits)[0] == invalid_value, key_bits
        assert scan(key_bits) == invalid_value, key_bits
    too_many = CK.KEY32_ITEMS // CK.WINDOWS + 1  # W n > 2^20: no 32-bit keys
    assert digits(32, n=too_many, count=0)[0] == invalid_value
    for form in (0, 1):
        err, out = shift(form)
        torch.cuda.synchronize()
        assert err == 0 and torch.equal(out, CK.shift_gens_plain("Fp", gens)), form
    for key_bits in (32, 64):
        err, out = digits(key_bits, m_pad=CK.WINDOWS * 6 + 3)
        torch.cuda.synchronize()
        want = CK.canon_digits_plain("Fq", s, CK.WINDOWS * 6 + 3, key_bits=key_bits)
        assert err == 0 and torch.equal(out, want), key_bits


@pytest.mark.gpu
def test_field_launchers_refuse_bad_arguments(cuda):
    """vdf_field_ew takes field 0 or 1, an op code below 7, broadcast bits
    below 8 and every operand its op reads; vdf_field_segsum and
    vdf_r1cs_matvec a field 0 or 1 and no negative count: anything else is
    refused with cudaErrorInvalidValue before a launch, and every good call
    launches and equals the plain version."""
    from vdf_tpu_torch.fields import kernels as FK

    invalid_value = 1  # cudaErrorInvalidValue
    lib = _build.load_kernels().lib
    stream = torch.cuda.current_stream().cuda_stream
    a, b, _ = state("Fq", 40, seed=7, device=cuda)
    out = torch.empty_like(a)

    def ew(field=1, op=2, bcast=0, b_ptr=b.data_ptr(), n=40):
        return lib.vdf_field_ew(field, op, a.data_ptr(), b_ptr, None, out.data_ptr(), n, bcast,
                                stream)

    for bad in ({"field": 2}, {"field": -1}, {"op": 7}, {"op": -1}, {"bcast": 8},
                {"bcast": -1}, {"b_ptr": None}, {"op": 6}, {"n": -1}):
        assert ew(**bad) == invalid_value, bad
    assert ew() == 0
    torch.cuda.synchronize()
    assert torch.equal(out, FK.field_ew_plain("Fq", "mul", a, b))
    offsets = torch.tensor([0, 10, 10, 40], dtype=torch.int64, device=cuda)
    sums = torch.empty((3, 8), dtype=torch.int32, device=cuda)
    for field, segs in ((2, 3), (0, -1)):
        assert lib.vdf_field_segsum(field, a.data_ptr(), offsets.data_ptr(), sums.data_ptr(),
                                    segs, 0, stream) == invalid_value
    assert lib.vdf_field_segsum(1, a.data_ptr(), offsets.data_ptr(), sums.data_ptr(), 3, 0,
                                stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(sums, FK.field_segsum_plain("Fq", a, offsets))
    cols = torch.arange(40, dtype=torch.int64, device=cuda) % 7
    rows = torch.repeat_interleave(torch.arange(3, device=cuda), offsets.diff())
    prod = torch.empty((3, 8), dtype=torch.int32, device=cuda)
    for field, n_rows, off in ((2, 3, offsets.data_ptr()), (1, -1, offsets.data_ptr()),
                               (1, 3, None)):
        assert lib.vdf_r1cs_matvec(field, off, cols.data_ptr(), a.data_ptr(), b.data_ptr(),
                                   prod.data_ptr(), n_rows, stream) == invalid_value
    assert lib.vdf_r1cs_matvec(1, offsets.data_ptr(), cols.data_ptr(), a.data_ptr(),
                               b.data_ptr(), prod.data_ptr(), 3, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(prod, FK.r1cs_matvec_plain("Fq", rows, cols, a, b, 3))


def _limbs(vals) -> torch.Tensor:
    """Integers below 2^256 as (n, 8) int32 limb bit patterns."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return torch.from_numpy(np.frombuffer(raw, dtype="<u4").reshape(-1, 8).view(np.int32).copy())


def _seeded(p: int, n: int, seed: int, canonical: bool = True) -> list[int]:
    nrng = np.random.default_rng(seed)
    vals = [int.from_bytes(nrng.bytes(32), "little") for _ in range(n)]
    return [v % p for v in vals] if canonical else vals


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["Fp", "Fq"])
def test_field_kernels_match_plain_on_card(cuda, name):
    """K10 (every op, a broadcast operand, a non-contiguous one), K11 (by
    offsets and as equal segments) and K12 (the augmented primary's A) once
    each on the card against their plain versions on the same CUDA
    tensors, bit for bit, each launch counted; no digit-level call but the
    plain versions'."""
    from vdf_tpu_torch.fields import kernels as FK
    from vdf_tpu_torch.fields import ops as field_ops
    from vdf_tpu_torch.nova import augmented
    from vdf_tpu_torch.nova.r1cs_device import DeviceShape

    ops = ["add", "sub", "mul", "sqr", "neg", "canon"]
    p = FIELDS[name].modulus
    f = get_field(name)
    a = _limbs([0, 1, p - 1, p, 2 * p - 1, 1 << 255, (1 << 256) % p, (1 << 256) - 1] * 40
               + _seeded(p, 200, 123, canonical=False)).to(cuda)
    b = _limbs(_seeded(p, a.shape[0], 124, canonical=False)).to(cuda)
    r = f.encode(_seeded(p, 1, 125)[0], cuda)
    FK.reset_launches()
    field_ops.reset_digit_calls()
    outs = {op: FK.field_ew(name, op, *((a, b) if FK.EW_OPS[op][1] == 2 else (a,)))
            for op in ops}
    outs["fold"] = FK.field_ew(name, "fold", a, r, b)
    outs["strided"] = f.sub(a[::2], b[1::2])
    offsets = torch.tensor([0, 100, 100, a.shape[0]], dtype=torch.int64, device=cuda)
    sums = FK.field_segsum(name, a, offsets), FK.field_segsum(name, a[:320], segments=4)
    assert FK.LAUNCHES["field_ew"] == len(ops) + 2 and FK.LAUNCHES["field_segsum"] == 2
    assert field_ops.digit_calls() == 0
    for op in ops:
        args = (a, b) if FK.EW_OPS[op][1] == 2 else (a,)
        assert torch.equal(outs[op], FK.field_ew_plain(name, op, *args)), op
    assert torch.equal(outs["fold"], FK.field_ew_plain(name, "fold", a, r.expand_as(b), b))
    assert torch.equal(outs["strided"], FK.field_ew_plain(name, "sub", a[::2], b[1::2]))
    assert torch.equal(sums[0], FK.field_segsum_plain(name, a, offsets))
    assert torch.equal(sums[1], FK.field_segsum_plain(name, a[:320], segments=4))
    if name == "Fq":
        shape = augmented.make_circuits(1)[0].shape()
        m = DeviceShape.build(f, shape, device=cuda).a
        z = f.encode(_seeded(p, shape.num_aux + 1 + shape.num_inputs, 126), cuda)
        FK.reset_launches()
        got = m.matvec(f, z)
        assert FK.LAUNCHES["r1cs_matvec"] == 1
        assert torch.equal(got, FK.r1cs_matvec_plain(name, m.rows, m.cols, m.vals, z,
                                                     m.num_rows))
