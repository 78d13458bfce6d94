"""The port's ratchet and roofline (``repro_torch.benchmarks.ratchet`` /
``roofline``) against the JAX harness's on the same rows.

The ratchet: the reference's eight cases (``tests/test_ratchet.py``) as
parameters; each gives the same summary and the same messages in both
packages (the port's baseline message names no ``BENCH_scaling.json``,
the JAX harness's record), and the CLIs the same exit codes.  The
roofline: ``analyze_record`` gives the reference's fields, and ``table``
its text, on the same dry-run records with the reference's constants set
to the port's H100 ones (records whose collectives stay within a host;
across hosts the port's link term is its own, checked by formula).
"""
import json

import pytest

pytest.importorskip("jax")

from benchmarks import ratchet as jratchet  # noqa: E402
from benchmarks import roofline as jroofline  # noqa: E402
from repro_torch.benchmarks import ratchet, roofline  # noqa: E402
from torch_ranks import pin_threads  # noqa: E402

pin_threads()


def _summary(impl, dtype, ratio):
    return {"bench": "error_grid_summary", "impl": impl, "dtype": dtype,
            "worst_ratio": ratio, "within_bound": ratio <= 1.0}


BASE = [_summary("cgs2", "float32", 2e-4),
        _summary("blocked", "float32", 4e-3),
        {"bench": "error_grid", "impl": "cgs2", "ratio": 0.9}]  # ignored

# The reference's eight cases: (baseline, fresh, keyword arguments).
CASES = {
    "summary_ratios_last_wins": (BASE, BASE + [_summary("cgs2", "float32",
                                                        3e-4)], {}),
    "passes_within_factor": (BASE, [_summary("cgs2", "float32", 3.9e-4),
                                    _summary("blocked", "float32", 2e-3)],
                             {}),
    "fails_on_2x_regression": (BASE, [_summary("cgs2", "float32", 2e-4),
                                      _summary("blocked", "float32",
                                               8.1e-3)], {}),
    "floor_absorbs_roundoff": ([_summary("cgs2", "float64", 1e-7)],
                               [_summary("cgs2", "float64", 9e-5)], {}),
    "flags_missing_cell": (BASE, [_summary("cgs2", "float32", 2e-4),
                                  _summary("panel_parallel", "complex64",
                                           5e-3)], {}),
    "empty_fresh_record": (BASE, [], {}),
    "empty_baseline": ([], [_summary("cgs2", "float32", 2e-4)], {}),
    "cli_roundtrip": (BASE, [_summary("cgs2", "float32", 1.0),
                             _summary("blocked", "float32", 4e-3)],
                      {"factor": 2.0, "floor": 1e-4}),
}


def _same(msgs):
    return [m.replace("BENCH_scaling.json", "baseline") for m in msgs]


@pytest.mark.parametrize("case", list(CASES))
def test_ratchet_gives_the_references_messages(case, tmp_path):
    base, fresh, kw = CASES[case]
    for rows in (base, fresh):
        assert ratchet.summary_ratios(rows) == jratchet.summary_ratios(rows)
    want = _same(jratchet.check_ratchet(base, fresh, **kw))
    assert ratchet.check_ratchet(base, fresh, **kw) == want
    if case == "empty_baseline":
        assert len(want) == 1 and "baseline" in want[0]
    if case == "cli_roundtrip":
        assert want and "cgs2/float32" in want[0]
        b, f = tmp_path / "base.json", tmp_path / "fresh.json"
        b.write_text(json.dumps(base))
        for rows, code in ((fresh, 1), (base, 0)):
            f.write_text(json.dumps(rows))
            argv = ["--baseline", str(b), "--fresh", str(f)]
            assert ratchet.main(argv) == jratchet.main(argv) == code


def _record(arch, shape, mesh, **kw):
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
           "compress": False, "mode": "tp", "flops": 3.2e13,
           "bytes_accessed": 4.1e11, "collective_total": 2.5e9,
           "interpod_bytes": 0.0, "interhost_bytes": 0.0}
    rec.update(kw)
    return rec


RECORDS = [_record("granite-3-2b", "train_4k", "pod"),
           _record("qwen2-moe-a2.7b", "decode_32k", "multipod",
                   collective_total=9e11),
           _record("xlstm-125m", "prefill_32k", "pod", flops=1e9,
                   bytes_accessed=8e12),
           {"arch": "granite-3-2b", "shape": "train_4k", "mesh": "pod",
            "status": "error"}]


@pytest.fixture
def h100_reference(monkeypatch):
    monkeypatch.setattr(jroofline, "PEAK", roofline.PEAK)
    monkeypatch.setattr(jroofline, "HBM", roofline.HBM)
    monkeypatch.setattr(jroofline, "LINK", roofline.LINK)
    monkeypatch.setattr(jroofline, "DCN", roofline.NET)


def test_analyze_record_gives_the_references_fields(h100_reference):
    for rec in RECORDS:
        want = jroofline.analyze_record(rec)
        got = roofline.analyze_record(rec)
        if want is None:
            assert got is None
            continue
        assert got.keys() == want.keys()
        for key, v in want.items():
            assert got[key] == (pytest.approx(v) if isinstance(v, float)
                                else v), key
    # the collective term with a group across hosts: NVLink + network
    rec = _record("granite-3-2b", "train_4k", "pod", interhost_bytes=1e9,
                  interpod_bytes=2e8, flops=0.0, bytes_accessed=0.0)
    got = roofline.analyze_record(rec)
    assert got["collective_s"] == pytest.approx(
        1.5e9 / roofline.LINK + 1e9 / roofline.NET)
    assert got["interpod_s"] == pytest.approx(2e8 / roofline.NET)
    assert got["dominant"] == "collective"


def test_table_reads_records_from_disk(h100_reference, tmp_path,
                                       monkeypatch, capsys):
    for i, rec in enumerate(RECORDS):
        (tmp_path / f"r{i}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(roofline, "ART_DIR", str(tmp_path))
    recs = roofline.load_records()
    assert len(recs) == len(RECORDS)
    text = roofline.table(recs)
    assert text == jroofline.table(recs)
    assert text.splitlines()[0].startswith("| arch | shape | mesh |")
    assert len(text.splitlines()) == 2 + 3          # the error is left out
    assert roofline.table(recs, markdown=False) == jroofline.table(
        recs, markdown=False)
    roofline.main(["--csv"])
    assert capsys.readouterr().out.strip() == roofline.table(
        recs, markdown=False)
