"""The port's harness (``repro_torch.benchmarks.run``) and its examples
(``examples/torch/``) on the CPU.

``_RowGuard`` fails a section that appends no row to the record; the
harness's record is its own (``BENCH_torch.json``), and the JAX harness's
``BENCH_scaling.json`` is never written or deleted; ``quickstart`` and
``serve_batched`` run at small sizes (their module constants patched),
and hold what they print (the eq. (3) bound, the same
compression report as the reference's example); no example imports JAX
or the JAX package.
"""
import ast
import importlib.util
import json
from pathlib import Path

import pytest

from repro_torch.benchmarks import common, run
from torch_ranks import pin_threads

pin_threads()

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_row_guard_fails_a_section_that_adds_no_row(tmp_path, capsys):
    record = tmp_path / "BENCH_torch.json"
    guard = run._RowGuard(str(record))
    with guard.expect_rows("adds rows"):
        common.append_json_rows(str(record), [{"bench": "x"}])
    guard.fail_if_empty()                            # every section added
    with guard.expect_rows("adds nothing"):
        pass
    with pytest.raises(SystemExit) as exc:
        guard.fail_if_empty()
    assert exc.value.code == 1
    assert "adds nothing" in capsys.readouterr().err
    assert guard.empty == ["adds nothing"]


def test_the_record_is_the_ports_own(tmp_path):
    assert common.RECORD == "BENCH_torch.json" != common.REFERENCE_RECORD
    theirs = tmp_path / "BENCH_scaling.json"
    theirs.write_text(json.dumps([{"bench": "theirs"}]))
    with pytest.raises(ValueError, match="JAX harness"):
        common.append_json_rows(str(theirs), [{"bench": "ours"}])
    # the harness refuses it before it deletes anything
    with pytest.raises(ValueError, match="JAX harness"):
        run.main(["--device", "cpu", "--bench-json", str(theirs)])
    assert json.loads(theirs.read_text()) == [{"bench": "theirs"}]
    # and its default is the port's record
    import argparse
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        ns = real(self, args, namespace)
        seen.update(vars(ns))
        raise SystemExit(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", spy)
        with pytest.raises(SystemExit):
            run.main(["--device", "cpu"])
    assert seen["bench_json"] == common.RECORD


def test_quickstart_on_the_cpu(monkeypatch):
    quick = _example("quickstart")
    monkeypatch.setattr(quick, "ROWS", 256)
    monkeypatch.setattr(quick, "COLS", 128)
    monkeypatch.setattr(quick, "RANK", 8)
    out = quick.main(["--device", "cpu"])
    assert out["satisfied"] and out["eq3_err"] <= out["eq3_bound"]
    assert set(out["sketches"]) == {"srft", "srht", "gaussian"}
    assert all(err < 1e-8 for err in out["sketches"].values())
    assert out["rsvd_err"] < 1e-8


def test_serve_batched_on_the_cpu(monkeypatch):
    serve = _example("serve_batched")
    monkeypatch.setattr(serve, "REQUESTS", 3)
    monkeypatch.setattr(serve, "MAX_NEW_TOKENS", 4)
    out = serve.main(["--device", "cpu"])
    assert sorted(out["dense"]) == sorted(out["rid"]) == [0, 1, 2]
    assert all(len(toks) == 4 for toks in out["dense"].values())
    # the reference's example compresses the same projections (5 of 7)
    assert len(out["report"]) == 7
    assert sum(r["compressed"] for r in out["report"].values()) == 5


def test_examples_import_no_jax():
    for path in sorted(EXAMPLES.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "repro"), (path.name, name)
