"""The readers of the spans inside the IVC step and the IPA rounds, and of the
wrappers' host-time counters, on hand-made observations: each sums its own
spans and no other, over the steps or proofs, and gives None where the
program has no such span or counter (a program without them reads nothing)."""

from __future__ import annotations

import pytest

from perfbench import spec

CHAIN = {"synthesize/Fq": 0.040, "synthesize/Fp": 0.030, "fold/primary": 0.010,
         "fold/secondary": 0.008, "synth.encode/Fq": 0.004, "synth.encode/Fp": 0.003,
         "synth.alloc/Fq": 0.001, "synth.h_in/Fq": 0.002, "synth.ro/Fq": 0.003,
         "synth.fold/Fq": 0.010, "synth.base/Fq": 0.001, "synth.stepf/Fq": 0.020,
         "synth.h_out/Fq": 0.002, "synth.alloc/Fp": 0.001, "synth.h_in/Fp": 0.004,
         "synth.ro/Fp": 0.005, "synth.fold/Fp": 0.012, "synth.base/Fp": 0.002,
         "synth.stepf/Fp": 0.0005, "synth.h_out/Fp": 0.006,
         "fold.commit/pallas": 0.002, "fold.read/pallas": 0.001,
         "fold.challenge/pallas": 0.0015, "fold.instance/pallas": 0.003,
         "fold.witness/pallas": 0.0005, "fold.commit/vesta": 0.002,
         "fold.read/vesta": 0.0012, "fold.challenge/vesta": 0.0011,
         "fold.instance/vesta": 0.0025, "fold.witness/vesta": 0.0004}
COMPRESS = {"closing fold": 0.005, "pallas": 0.2, "vesta": 0.19,
            "pallas/two IPAs": 0.1, "vesta/two IPAs": 0.09, "pallas/ipa.commit": 0.03,
            "pallas/ipa.read": 0.02, "pallas/ipa.transcript": 0.04, "pallas/ipa.fold": 0.005,
            "vesta/ipa.commit": 0.03, "vesta/ipa.read": 0.015, "vesta/ipa.transcript": 0.035,
            "vesta/ipa.fold": 0.004, "perfbench.verify": 0.1}

WANT = {  # metric: (cell's obs key, per-what count, the spans it sums)
    "ivc.synth_hash_ms": ("ivc", 2, ["synth.h_in/Fq", "synth.ro/Fq", "synth.h_out/Fq",
                                     "synth.h_in/Fp", "synth.ro/Fp", "synth.h_out/Fp"]),
    "ivc.synth_nifs_ms": ("ivc", 2, ["synth.fold/Fq", "synth.fold/Fp"]),
    "ivc.fold_host_ms": ("ivc", 2, ["fold.read/pallas", "fold.challenge/pallas",
                                    "fold.instance/pallas", "fold.read/vesta",
                                    "fold.challenge/vesta", "fold.instance/vesta"]),
    "compress.ipa_host_ms": ("compress", 4, ["pallas/ipa.read", "pallas/ipa.transcript",
                                             "vesta/ipa.read", "vesta/ipa.transcript"]),
}


def _obs(key: str, n: int, spans: dict) -> dict:
    count = "steps" if key == "ivc" else "proofs"
    return {key: {count: n, "window_s": 30.0, "spans": dict(spans)}}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_span_reader_sums_its_spans(metric):
    key, n, names = WANT[metric]
    spans = CHAIN if key == "ivc" else COMPRESS
    read = spec.metric_reader(metric)
    assert read(_obs(key, n, spans)) == pytest.approx(1e3 * sum(spans[k] for k in names) / n)
    # the program before these spans: the old spans alone read nothing
    old = {k: v for k, v in spans.items() if k not in names}
    assert read(_obs(key, n, old)) is None
    assert read(_obs(key, 0, spans)) is None and read({}) is None


def test_span_readers_leave_the_old_readers_alone():
    """The old readers' sums over spans that hold the new ones read as on
    spans that do not."""
    for metric, key in (("ivc.synth_ms", "ivc"), ("ivc.fold_ms", "ivc"),
                        ("compress.ipa_ms", "compress"), ("compress.sumcheck_ms", "compress")):
        spans = CHAIN if key == "ivc" else COMPRESS
        old = {k: v for k, v in spans.items()
               if not (k.startswith(("synth.", "fold.")) or "/ipa." in k)}
        read = spec.metric_reader(metric)
        assert read(_obs(key, 3, spans)) == read(_obs(key, 3, old)), metric


def test_wrapper_host_reader(monkeypatch):
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.fields import kernels as FK

    read = spec.metric_reader("ivc.wrapper_host_ms")
    monkeypatch.setattr(FK, "HOST_S", {"field_ew": 0.010, "r1cs_matvec": 0.002})
    monkeypatch.setattr(CK, "HOST_S", {"scan": 0.004, "bucket": 0.004})
    assert read(_obs("ivc", 4, CHAIN)) == pytest.approx(1e3 * 0.020 / 4)
    assert read(_obs("ivc", 0, CHAIN)) is None and read({}) is None
    monkeypatch.delattr(CK, "HOST_S")  # a program without the counter
    assert read(_obs("ivc", 4, CHAIN)) is None
