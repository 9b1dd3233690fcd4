"""The port's kernel build and wrapper dispatch (vdf_tpu_torch._build,
vdf_tpu_torch.fields.kernels).

On the CPU: the build refuses to go on without nvcc, a CPU tensor takes
the plain version without touching the launch counters, and malformed
input raises.  The ``gpu`` tests run the CUDA kernels against their plain
versions and skip where ``torch.cuda.is_available()`` is False:

    python -m pytest tests/test_torch_build.py -q -m gpu
"""

import re

import numpy as np
import pytest
import torch

from vdf_tpu_torch import _build
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
    assert _build.build_key() == _build.build_key()


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
