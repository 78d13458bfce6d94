"""repro_torch.analysis on the CPU: every rule fires on its planted fixture
and stays silent on the port's own code, and the reference's analysis
agrees with it where both look at the same thing (the ``big_copy``
fixture kernel, the fingerprints).

Tests that need a process group run in one-rank subprocesses
(``torch_ranks.run_ranks``, gloo); no test process joins a group.  The
card-side geometry check is in ``test_torch_cuda.py``.
"""
import dataclasses
import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.analysis import registry
from repro_torch.analysis.dataflow import analyze_entry, run_entry
from repro_torch.analysis.fixtures import (BAD_LINT_SRC, BAD_SERVER_SRC,
                                           BAD_SLEEP_SRC, BADKERNEL_BASE,
                                           FIXTURES)
from repro_torch.analysis.kernels import (c_constant, check_all_kernels,
                                          check_package, kernel_packages)
from repro_torch.analysis.lint import lint_file, lint_tree
from repro_torch.analysis.registry import load_entry_points, register
from repro_torch.analysis.report import (Finding, Report,
                                         diff_against_baseline, load_baseline)
from repro_torch.analysis.runner import run_controls
from repro_torch.kernels.common import SMEM_BUDGET_BYTES
from torch_ranks import failures, pin_threads, run_ranks

pin_threads()

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "csrc"


def rules(findings):
    return sorted({f.rule for f in findings})


def _one_rank(program: str, *args: str, timeout: int = 240) -> str:
    """Run ``program`` in one rank process; its stdout."""
    res = run_ranks(program, 1, *args, timeout=timeout, OMP_NUM_THREADS="1")
    assert not failures(res), failures(res)
    return res[0][1]


# --------------------------------------- dataflow rules on the fixtures

def test_complex_truncation_fixture_trips_dtype_rule():
    fs = analyze_entry(FIXTURES["fixture.complex-truncation"], device="cpu")
    assert rules(fs) == ["dataflow.dtype-promotion"], fs
    assert [f.key for f in fs] == ["complex-truncation-complex64-to-float32"]


def test_f64_leak_fixture_trips_dtype_rule():
    fs = analyze_entry(FIXTURES["fixture.f64-leak"], device="cpu")
    assert fs and rules(fs) == ["dataflow.dtype-promotion"], fs
    assert "wide-_to_copy-float64" in {f.key for f in fs}


def test_host_transfer_fixture_trips_host_rule():
    fs = analyze_entry(FIXTURES["fixture.host-transfer"], device="cpu")
    assert rules(fs) == ["dataflow.host-transfer"], fs
    assert {f.key for f in fs} == {"_local_scalar_dense"}


def test_span_timer_fixture_trips_host_rule():
    """The obs-layer positive control: a span timer that syncs the device
    inside the loop it times (reading the SANCTIONED obs clock, so only
    the sync is wrong) must trip the host-transfer rule."""
    fs = analyze_entry(FIXTURES["fixture.span-timer"], device="cpu")
    assert rules(fs) == ["dataflow.host-transfer"], fs
    assert "3 _local_scalar_dense" in fs[0].message


def test_unregistered_overlap_entry_reports_control_failure():
    # An OverlapSpec whose structures don't exist must FAIL, not pass
    # vacuously.
    ep = dataclasses.replace(
        FIXTURES["fixture.f64-leak"],
        overlap=FIXTURES["fixture.serialized-psum"].overlap)
    fs = analyze_entry(ep, device="cpu")
    assert "dataflow.control-failed" in rules(fs), fs
    assert any(f.key == "structures-not-found" for f in fs)


def test_distributed_fixture_without_group_is_a_control_failure():
    fs = analyze_entry(FIXTURES["fixture.serialized-psum"], device="cpu")
    assert [(f.rule, f.key) for f in fs] == [
        ("dataflow.control-failed", "no-group")]


def test_recorder_logs_ops_in_program_order():
    """The counterpart of the reference's dependency-cone check: the
    eager log is the program, in order, with each op's dtypes."""
    ep = registry.EntryPoint(
        name="probe", build=lambda dev: (
            lambda a, b: (a + b) * a - (b - 1.0),
            (torch.ones(3), torch.ones(3, dtype=torch.float64))))
    run = run_entry(ep, device="cpu")
    ops = [e.name for e in run.recording.events if e.kind == "op"]
    assert ops == ["add", "mul", "sub", "sub"], ops
    assert not run.inputs_32
    assert run.recording.events[0].dtypes == (torch.float64,)


@pytest.mark.parametrize("name,syncs", [("rid", 1), ("pivoted_qr.blocked", 3),
                                        ("rid_streamed.step", 3)])
def test_single_device_entries_clean_within_sync_budget(name, syncs):
    """The blocked engine reads one scalar a panel by design
    (``_panel_ok``); the declared budget holds exactly that."""
    from repro_torch.analysis.dataflow import host_syncs
    load_entry_points()
    ep = registry.get(name)
    assert ep.max_host_syncs == syncs
    assert analyze_entry(ep, device="cpu") == []
    assert host_syncs(run_entry(ep, device="cpu")) == \
        {"_local_scalar_dense": syncs}


def test_registry_names_and_duplicate_rejection():
    names = [e.name for e in load_entry_points()]
    assert names == sorted(names)
    assert names == ["panel_parallel_qr_local.fused",
                     "panel_parallel_qr_local.gram", "pivoted_qr.blocked",
                     "rid", "rid_distributed.blocked",
                     "rid_distributed.panel_parallel",
                     "rid_streamed.sharded_step", "rid_streamed.step"]
    assert "control" in registry.get("panel_parallel_qr_local.gram").tags
    assert not registry.get("panel_parallel_qr_local.gram") \
        .overlap.expect_overlap
    with pytest.raises(ValueError, match="duplicate analysis entry"):
        register("rid", lambda device: None)


def test_run_entry_exposes_recording():
    run = run_entry(registry.get("pivoted_qr.blocked"), device="cpu")
    assert run.inputs_32 and run.name == "pivoted_qr.blocked"
    # the three panels of the blocked engine, each one panel_step
    assert sum(e.name == "topk" for e in run.recording.events) == 3


# --------------------------------------------------- kernel contract pass

def test_kernel_packages_discovered():
    assert kernel_packages() == ["cgs", "flash", "panel_gram", "panel_step",
                                 "sketch_accum", "sketch_matmul", "srht",
                                 "tsolve"]


def test_all_kernel_contracts_pass():
    findings, pkgs = check_all_kernels(device="cpu")
    assert findings == [], [(f.rule, f.subject, f.key, f.message)
                            for f in findings]
    assert len(pkgs) == 8


@pytest.mark.parametrize("pkg", ["cgs", "flash", "panel_gram", "panel_step",
                                 "sketch_accum", "sketch_matmul", "srht",
                                 "tsolve"])
def test_production_example_declares_fitting_launches(pkg):
    contract = importlib.import_module(
        f"repro_torch.kernels.{pkg}.contract").CONTRACT
    launches = contract.example().launches
    assert launches
    for ln in launches:
        assert ln.smem <= SMEM_BUDGET_BYTES and ln.threads_per_block <= 1024
        assert ln.entry.startswith("repro_") and ln.library == "kernels"


def test_flash_example_sits_close_under_the_budget():
    from repro_torch.kernels.flash.contract import CONTRACT
    (ln,) = CONTRACT.example().launches
    # the q tile (64 rows of 66 chunks) and two stages of 32 k and v rows
    # (66 and 65 chunks of 16 bytes) at hd 256 in f32
    assert ln.smem == 16 * (64 * 66 + 2 * 32 * (66 + 65)) == 201728
    assert ln.kernel == "flash_fwd_kernel<float32,float32,256>"
    tight = dataclasses.replace(CONTRACT, smem_budget=201727)
    assert rules(_check_with("flash", tight)) == ["kernels.smem-overflow"]


def test_contract_examples_run_the_main_path_type_and_both_project_launches():
    """sketch_accum's example is its f64 (tensor-core) launch; cgs's runs
    panel_deflate, then project_out's two launches, declared as parts 0
    and 1 of one C call."""
    from repro_torch.kernels.cgs.contract import CONTRACT as CGS
    from repro_torch.kernels.sketch_accum.contract import CONTRACT as ACC
    (ln,) = ACC.example().launches
    assert ln.kernel == "sketch_accum_dmma_kernel<true>"
    assert (ln.grid, ln.threads, ln.smem) == ((1, 4, 1), (256, 1, 1), 229376)
    deflate, w, o = CGS.example().launches
    assert deflate.entry == "repro_panel_deflate" and deflate.parts == 1
    assert (w.kernel, o.kernel) == ("project_w_dmma_kernel<true>",
                                    "project_o_dmma_kernel<true>")
    assert [(w.part, w.parts), (o.part, o.parts)] == [(0, 2), (1, 2)]
    assert w.entry == o.entry == "repro_project_out" and w.args == o.args
    assert (w.grid, o.grid) == ((4, 32, 1), (2, 32, 1))


def _check_with(pkg, contract, base="repro_torch.kernels"):
    mod = importlib.import_module(f"{base}.{pkg}.contract")
    saved = mod.CONTRACT
    mod.CONTRACT = contract
    try:
        return check_package(pkg, base=base, device="cpu")
    finally:
        mod.CONTRACT = saved


def test_badkernel_fixture_trips_smem_rule():
    fs = check_package("badkernel", base=BADKERNEL_BASE, device="cpu")
    # and ONLY the planted failure: the package is otherwise well-formed
    assert rules(fs) == ["kernels.smem-overflow"], fs
    assert "67108864 B" in fs[0].message and "232448" in fs[0].message


def test_threads_over_1024_trip_smem_rule():
    C = importlib.import_module(f"{BADKERNEL_BASE}.badkernel.contract")
    example = C.CONTRACT.example

    def wide():
        ex = example()
        ln = dataclasses.replace(ex.launches[0], threads=(2048, 1, 1),
                                 smem=0)
        return dataclasses.replace(ex, launches=(ln,))
    fs = _check_with("badkernel", dataclasses.replace(C.CONTRACT,
                                                      example=wide),
                     BADKERNEL_BASE)
    assert [(f.rule, f.key) for f in fs] == [
        ("kernels.smem-overflow", "call-0-threads")]


@pytest.mark.parametrize("attr,value", [("ACCUM_BLOCK", 64)])
def test_constant_drift_detected(monkeypatch, attr, value):
    K = importlib.import_module("repro_torch.kernels.sketch_accum.kernel")
    monkeypatch.setattr(K, attr, value)
    fs = check_package("sketch_accum", device="cpu")
    assert {f.key for f in fs if f.rule == "kernels.constant-drift"} == \
        {"ACCUM_BLOCK", "ACCUM_BLOCK/kAccumBlock"}, fs


def test_max_panel_drift_against_the_header(monkeypatch):
    """MAX_PANEL is held to ``kMaxPanel`` parsed from panel_common.cuh,
    not to a second copy of the number."""
    assert c_constant(CSRC / "panel_common.cuh", "kMaxPanel") == 64
    K = importlib.import_module("repro_torch.kernels.panel_step.kernel")
    monkeypatch.setattr(K, "MAX_PANEL", 32)
    fs = check_package("panel_step", device="cpu")
    assert [(f.rule, f.key) for f in fs] == [
        ("kernels.constant-drift", "MAX_PANEL/kMaxPanel")], fs


def test_c_constant_parser(tmp_path):
    src = tmp_path / "k.cuh"
    src.write_text("constexpr int kGemmTX = 16, kGemmTY = 8;  // x\n"
                   "constexpr int kMaxPanel = 48;\n")
    assert c_constant(src, "kGemmTY") == 8
    assert c_constant(src, "kMaxPanel") == 48
    assert c_constant(src, "kMissing") is None


def test_missing_export_and_validation_regression_detected(monkeypatch):
    C = importlib.import_module(f"{BADKERNEL_BASE}.badkernel.contract")
    broken = dataclasses.replace(
        C.CONTRACT, ops=C.CONTRACT.ops + ("nonexistent",),
        bad_call=lambda: None)          # "validates" by not raising
    monkeypatch.setattr(C, "CONTRACT", broken)
    fs = check_package("badkernel", base=BADKERNEL_BASE, device="cpu")
    got = rules(fs)
    assert "kernels.missing-export" in got, fs
    assert "kernels.validation-missing" in got, fs


def test_removed_export_detected(monkeypatch):
    K = importlib.import_module("repro_torch.kernels.tsolve.kernel")
    monkeypatch.delattr(K, "tsolve_kernel")
    fs = check_package("tsolve", device="cpu")
    assert [(f.rule, f.key) for f in fs] == [
        ("kernels.missing-export", "kernel.tsolve_kernel")], fs


def test_ops_without_validation_detected(monkeypatch):
    """An ops.py that dispatches the known-bad call to ref.py without
    checking it first trips the rule (the CPU lane, before dispatch)."""
    O = importlib.import_module("repro_torch.kernels.sketch_accum.ops")
    monkeypatch.setattr(O, "sketch_accum", lambda x, a, acc=None: None)
    fs = check_package("sketch_accum", device="cpu")
    assert [(f.rule, f.key) for f in fs] == [
        ("kernels.validation-missing", "bad-call")], fs


def test_signature_mismatch_detected(monkeypatch):
    R = importlib.import_module(f"{BADKERNEL_BASE}.badkernel.ref")
    monkeypatch.setattr(R, "big_copy_ref", lambda y: y)
    fs = check_package("badkernel", base=BADKERNEL_BASE, device="cpu")
    assert any(f.rule == "kernels.signature-mismatch" for f in fs), fs


def test_bad_call_raising_wrong_type_detected(monkeypatch):
    C = importlib.import_module(f"{BADKERNEL_BASE}.badkernel.contract")

    def _boom():
        raise TypeError("wrong exception class")
    monkeypatch.setattr(C, "CONTRACT",
                        dataclasses.replace(C.CONTRACT, bad_call=_boom))
    fs = check_package("badkernel", base=BADKERNEL_BASE, device="cpu")
    assert any(f.rule == "kernels.validation-missing" and
               "TypeError" in f.message for f in fs), fs


def test_blinded_smem_estimator_trips_control(monkeypatch):
    C = importlib.import_module(f"{BADKERNEL_BASE}.badkernel.contract")
    monkeypatch.setattr(C, "CONTRACT", dataclasses.replace(
        C.CONTRACT, smem_budget=1 << 40))
    assert "controls.smem-rule-blind" in rules(run_controls(device="cpu"))


# ----------------------------------- parity with the reference (CPU)

def test_big_copy_matches_reference_kernel():
    """The reference's big_copy (Pallas, interpret mode, as its own tests
    run it) and the port's plain version and CPU wrapper agree exactly.
    The reference kernel stores its whole-operand input block into a
    ``bn``-column output block, so it executes only where ``bn`` covers
    ``n``: one grid step here."""
    import jax.numpy as jnp
    from repro.analysis.fixtures.badkernel.ops import big_copy as jbig_copy
    from repro_torch.analysis.fixtures.badkernel.ops import big_copy
    from repro_torch.analysis.fixtures.badkernel.ref import big_copy_ref
    x = np.random.default_rng(0).standard_normal((64, 4096)).astype(
        np.float32)
    want = np.asarray(jbig_copy(jnp.asarray(x), bn=4096, interpret=True))
    np.testing.assert_array_equal(want, x)
    np.testing.assert_array_equal(big_copy_ref(torch.from_numpy(x)).numpy(),
                                  want)
    np.testing.assert_array_equal(
        big_copy(torch.from_numpy(x), bn=4096).numpy(), want)


def test_reference_and_port_flag_the_badkernel_example():
    from repro.analysis.fixtures import BADKERNEL_BASE as JBASE
    from repro.analysis.kernels import check_package as jcheck_package
    assert rules(jcheck_package("badkernel", base=JBASE)) == \
        ["kernels.vmem-overflow"]
    assert rules(check_package("badkernel", base=BADKERNEL_BASE,
                               device="cpu")) == \
        ["kernels.smem-overflow"]


def test_fingerprints_match_the_reference():
    from repro.analysis.report import Finding as JFinding
    for args in (("kernels.smem-overflow", "badkernel", "call-0"),
                 ("lint.valueerror-no-value", "core/x.py", "raise-'a'")):
        assert Finding(*args, "m").fingerprint == \
            JFinding(*args, "other").fingerprint


# --------------------------------------------------------------- lint pass

def test_lint_fixture_trips_every_rule(tmp_path):
    p = tmp_path / "core" / "bad.py"
    p.parent.mkdir()
    p.write_text(BAD_LINT_SRC)
    got = rules(lint_file(p, pathlib.Path("core/bad.py")))
    assert got == ["lint.duplicate-validation", "lint.global-clock-prng",
                   "lint.string-switch", "lint.torch-global-mutation",
                   "lint.valueerror-no-value"], got


@pytest.mark.parametrize("scripts", ["launch", "benchmarks"])
def test_lint_rules_scoped_to_library_dirs(tmp_path, scripts):
    p = tmp_path / scripts / "bad.py"
    p.parent.mkdir()
    p.write_text(BAD_LINT_SRC)
    got = rules(lint_file(p, pathlib.Path(f"{scripts}/bad.py")))
    # behavioral rules don't apply to scripts; message rules still do
    assert got == ["lint.duplicate-validation", "lint.valueerror-no-value"]


def test_lint_torch_rule_spares_a_seeded_generator(tmp_path):
    p = tmp_path / "g.py"
    p.write_text("import torch\n\n"
                 "def draw():\n"
                 "    g = torch.Generator()\n"
                 "    g.manual_seed(0)\n"
                 "    return torch.randn(3, generator=g)\n")
    assert lint_file(p, pathlib.Path("core/g.py")) == []
    p.write_text("import torch\n\n"
                 "def setup():\n"
                 "    torch.manual_seed(0)\n"
                 "    torch.backends.cuda.matmul.allow_tf32 = True\n"
                 "    torch.set_float32_matmul_precision('high')\n")
    fs = lint_file(p, pathlib.Path("serving/s.py"))
    assert rules(fs) == ["lint.torch-global-mutation"]
    assert {f.key for f in fs} == {"manual_seed", "allow_tf32",
                                   "set_float32_matmul_precision"}


def test_lint_clock_rule_allowlists_obs_clock_home(tmp_path):
    src = ("import time\n\n"
           "def now():\n"
           "    return time.perf_counter()\n")
    home = tmp_path / "obs" / "clock.py"
    home.parent.mkdir()
    home.write_text(src)
    assert lint_file(home, pathlib.Path("obs/clock.py")) == []
    stray = tmp_path / "kernels" / "_build.py"
    stray.parent.mkdir()
    stray.write_text(src)
    fs = lint_file(stray, pathlib.Path("kernels/_build.py"))
    assert rules(fs) == ["lint.global-clock-prng"], fs
    assert {f.key for f in fs} == {"import-time", "clock-time.perf_counter"}


def test_lint_time_sleep_rule_and_allowlist(tmp_path):
    p = tmp_path / "bad_sleep.py"
    p.write_text(BAD_SLEEP_SRC)
    fs = lint_file(p, pathlib.Path("serving/bad_sleep.py"))
    assert "lint.time-sleep" in rules(fs)
    msg = next(f for f in fs if f.rule == "lint.time-sleep").message
    assert "Clock.sleep" in msg
    assert "lint.time-sleep" not in rules(
        lint_file(p, pathlib.Path("obs/clock.py")))
    assert "lint.time-sleep" not in rules(
        lint_file(p, pathlib.Path("launch/bad_sleep.py")))


def test_lint_socket_server_rule_and_allowlist(tmp_path):
    p = tmp_path / "bad_server.py"
    p.write_text(BAD_SERVER_SRC)
    fs = lint_file(p, pathlib.Path("serving/bad_server.py"))
    assert rules(fs) == ["lint.socket-server"], fs
    assert {f.key for f in fs} == {"import-socket", "import-http.server"}
    assert "obs/telemetry.py" in fs[0].message
    assert "lint.socket-server" not in rules(
        lint_file(p, pathlib.Path("obs/telemetry.py")))
    assert "lint.socket-server" not in rules(
        lint_file(p, pathlib.Path("launch/bad_server.py")))


def test_lint_clean_on_production_tree():
    findings, files = lint_tree()
    assert len(files) > 60
    assert "kernels/_build.py" in files and "kernels/flash/kernel.py" in files
    assert findings == [], [(f.rule, f.subject, f.key) for f in findings]


# -------------------------------------------------- report, baseline, CLI

def test_fingerprint_stable_under_message_changes():
    a = Finding("r.x", "s", "k", "message one")
    b = Finding("r.x", "s", "k", "completely different text")
    c = Finding("r.x", "s", "other", "message one")
    assert a.fingerprint == b.fingerprint != c.fingerprint


def test_finding_rejects_unknown_severity():
    with pytest.raises(ValueError, match="severity"):
        Finding("r", "s", "k", "m", severity="fatal")


def test_baseline_diff_new_suppressed_stale(tmp_path):
    old = Finding("r.a", "s1", "k1", "m")
    new = Finding("r.b", "s2", "k2", "m")
    gone = Finding("r.c", "s3", "k3", "m")
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"suppressions": [
        {"fingerprint": f.fingerprint, "rule": f.rule, "subject": f.subject,
         "key": f.key, "reason": "t"} for f in (old, gone)]}))
    rep = Report()
    rep.extend([old, new, Finding("r.i", "s", "k", "m", severity="info")])
    got_new, suppressed, stale = diff_against_baseline(
        rep, load_baseline(base))
    assert got_new == [new] and suppressed == [old]
    assert [e["rule"] for e in stale] == ["r.c"]


def test_checked_in_baseline_is_empty():
    # the port must stay clean; suppressions need a justification
    assert load_baseline() == {}


_DATAFLOW = """
import json, sys, tempfile
import torch.distributed as dist
from repro_torch.analysis import registry
from repro_torch.analysis.dataflow import analyze_entry
from repro_torch.analysis.fixtures import FIXTURES
from repro_torch.analysis.runner import run_all, run_controls
with tempfile.TemporaryDirectory() as td:
    dist.init_process_group("gloo", init_method=f"file://{td}/store",
                            rank=0, world_size=1)
    out = {}
    for name in ("fixture.serialized-psum", "fixture.overlapped-psum",
                 "fixture.gather-blowup"):
        out[name] = [(f.rule, f.key)
                     for f in analyze_entry(FIXTURES[name], device="cpu")]
    out["entries"] = {ep.name: [(f.rule, f.key)
                                for f in analyze_entry(ep, device="cpu")]
                      for ep in registry.load_entry_points()}
    out["controls"] = [f.rule for f in run_controls(device="cpu")]
    rep = run_all(device="cpu")
    rep.write(sys.argv[3])
    out["passes"] = rep.passes_run
    out["errors"] = [(f.rule, f.subject) for f in rep.errors()]
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_dataflow_pass_on_a_one_rank_group(tmp_path):
    """One rank process: the distributed fixtures trip (or spare) their
    rules, every registered entry is clean, every control holds, and the
    whole run's report has the reference's schema."""
    out = json.loads(_one_rank(_DATAFLOW, str(tmp_path / "r.json"))
                     .splitlines()[-1])
    assert out["fixture.serialized-psum"] == [
        ["dataflow.collective-overlap", f"panel-{p}"] for p in range(3)]
    assert out["fixture.overlapped-psum"] == []
    assert out["fixture.gather-blowup"] == [
        ["dataflow.replicated-collective", "all_gather-16x64"]]
    assert out["entries"] == {name: [] for name in out["entries"]}
    assert len(out["entries"]) == 8
    assert out["controls"] == []
    assert out["passes"] == ["dataflow", "kernels", "lint", "controls"]
    assert out["errors"] == []
    data = json.loads((tmp_path / "r.json").read_text())
    assert set(data) == {"passes_run", "subjects", "findings"}
    assert "panel_parallel_qr_local.fused" in data["subjects"]["dataflow"]
    assert "panel_parallel_qr_local.gram" in data["subjects"]["dataflow"]


_CLI = """
import json, sys
from repro_torch.analysis.__main__ import main
rc = main(["--device", "cpu", "--fail-on-new", "--report", sys.argv[3]])
assert rc == 0, rc
# plant: a serialized all_reduce in the registry -> the gate must trip
from repro_torch.analysis import registry
from repro_torch.analysis.fixtures import FIXTURES
bad = FIXTURES["fixture.serialized-psum"]
registry._REGISTRY[bad.name] = bad
rc = main(["--device", "cpu", "--fail-on-new", "--no-controls",
           "--report", sys.argv[4]])
assert rc == 1, rc
print(json.dumps(sorted({f["rule"] for f in
                         json.load(open(sys.argv[4]))["findings"]})))
"""


def test_cli_passes_here_and_gates_on_new_findings(tmp_path):
    out = _one_rank(_CLI, str(tmp_path / "a.json"), str(tmp_path / "b.json"))
    assert json.loads(out.splitlines()[-1]) == ["dataflow.collective-overlap"]
    a = json.loads((tmp_path / "a.json").read_text())
    assert a["passes_run"] == ["dataflow", "kernels", "lint", "controls"]
    assert len(a["subjects"]["kernels"]) == 8


def test_library_entry_points_default_to_the_card():
    """``run_all``, ``run_controls``, ``check_all_kernels``,
    ``check_package``, ``run_entry`` and ``analyze_entry`` run on the card
    unless the caller names the CPU, as the CLI does; without a card the
    default raises instead of falling back."""
    import inspect

    from repro_torch.analysis import runner
    for fn in (runner.run_all, runner.run_controls, check_all_kernels,
               check_package, run_entry, analyze_entry):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="is_available"):
        check_all_kernels()
    with pytest.raises(RuntimeError, match="is_available"):
        analyze_entry(FIXTURES["fixture.span-timer"])
    with pytest.raises(RuntimeError, match="is_available"):
        runner.run_controls()
