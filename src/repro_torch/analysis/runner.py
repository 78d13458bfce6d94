"""Orchestrates every analysis pass into one :class:`Report` (counterpart
of ``repro.analysis.runner``).

Order: (1) dataflow rules over every registered entry point, (2) kernel
contract checks over every ``repro_torch.kernels`` package, (3) AST lint
over ``src/repro_torch``, (4) the control pass — the serialized panel-loop
fixture, the span timer and the shared-memory-hostile fixture kernel must
each be FLAGGED, its overlapped twin and the sanctioned clock and server
homes must NOT be, otherwise a ``controls.*`` finding gates CI: an
analyzer that stops seeing planted bugs is itself the regression.  (The
gram entry is an in-registry control: registered with
``expect_overlap=False``, its rule fails loudly if the serialization it
embodies goes undetected.)

The dataflow pass runs the distributed entries on the default process
group, which the caller initializes (the CLI joins a one-rank group).
"""
from __future__ import annotations

import tempfile
from pathlib import Path

import torch

from . import registry
from .dataflow import analyze_entry
from .kernels import check_all_kernels, check_package
from .lint import lint_file, lint_tree
from .report import Finding, Report

__all__ = ["run_all", "run_controls", "CONTROLS"]

CONTROLS = ("fixture.serialized-psum", "fixture.overlapped-psum",
            "badkernel", "fixture.span-timer", "fixture.bad-sleep",
            "fixture.bad-server")


def run_controls(device="cpu") -> list:
    """Positive controls: plant a bug, require the alarm."""
    from .fixtures import BADKERNEL_BASE, FIXTURES
    device = torch.device(device)
    findings = []

    planted = analyze_entry(FIXTURES["fixture.serialized-psum"], device)
    if not any(f.rule == "dataflow.collective-overlap" for f in planted):
        findings.append(Finding(
            "controls.overlap-rule-blind", "fixture.serialized-psum",
            "no-alarm",
            f"the deliberately-serialized fixture produced "
            f"{[f.rule for f in planted]} but no "
            f"dataflow.collective-overlap — the overlap rule is blind"))

    clean = analyze_entry(FIXTURES["fixture.overlapped-psum"], device)
    if clean:
        findings.append(Finding(
            "controls.overlap-rule-noisy", "fixture.overlapped-psum",
            "false-alarm",
            f"the correctly-overlapped fixture was flagged "
            f"{[f.rule for f in clean]} — the overlap rule raises false "
            f"alarms"))

    bad = check_package("badkernel", base=BADKERNEL_BASE, device=device)
    if not any(f.rule == "kernels.smem-overflow" for f in bad):
        findings.append(Finding(
            "controls.smem-rule-blind", "badkernel", "no-alarm",
            f"the shared-memory-hostile fixture kernel produced "
            f"{[f.rule for f in bad]} but no kernels.smem-overflow — "
            f"the estimator is vacuous"))
    if device.type == "cuda":
        findings.extend(_refusal_control(device))

    timer = analyze_entry(FIXTURES["fixture.span-timer"], device)
    if not any(f.rule == "dataflow.host-transfer" for f in timer):
        findings.append(Finding(
            "controls.timer-rule-blind", "fixture.span-timer", "no-alarm",
            f"the planted in-loop span timer produced "
            f"{[f.rule for f in timer]} but no dataflow.host-transfer — "
            f"instrumentation that syncs the device would go unseen"))

    from .fixtures import BAD_SLEEP_SRC
    with tempfile.TemporaryDirectory() as td:
        p = Path(td) / "bad_sleep.py"
        p.write_text(BAD_SLEEP_SRC)
        slept = lint_file(p, Path("serving") / "bad_sleep.py")
        clock_home = lint_file(p, Path("obs") / "clock.py")
    if not any(f.rule == "lint.time-sleep" for f in slept):
        findings.append(Finding(
            "controls.sleep-rule-blind", "fixture.bad-sleep", "no-alarm",
            f"the planted time.sleep library module produced "
            f"{[f.rule for f in slept]} but no lint.time-sleep — "
            f"blocking waits could dodge the injected-Clock contract"))
    if any(f.rule == "lint.time-sleep" for f in clock_home):
        findings.append(Finding(
            "controls.sleep-rule-noisy", "obs/clock.py", "false-alarm",
            "the sanctioned Clock.sleep implementation site was flagged "
            "by lint.time-sleep — the allowlist is broken"))

    from .fixtures import BAD_SERVER_SRC
    with tempfile.TemporaryDirectory() as td:
        p = Path(td) / "bad_server.py"
        p.write_text(BAD_SERVER_SRC)
        served = lint_file(p, Path("serving") / "bad_server.py")
        server_home = lint_file(p, Path("obs") / "telemetry.py")
    if not any(f.rule == "lint.socket-server" for f in served):
        findings.append(Finding(
            "controls.server-rule-blind", "fixture.bad-server", "no-alarm",
            f"the planted HTTP-listener library module produced "
            f"{[f.rule for f in served]} but no lint.socket-server — "
            f"stray sockets could dodge the telemetry-endpoint contract"))
    if any(f.rule == "lint.socket-server" for f in server_home):
        findings.append(Finding(
            "controls.server-rule-noisy", "obs/telemetry.py", "false-alarm",
            "the sanctioned telemetry server module was flagged by "
            "lint.socket-server — the allowlist is broken"))
    return findings


# A shape of the fixture kernel inside one block's shared memory: 48 x 1024
# f32 is 196608 B, over 4 CTAs of bn = 256 columns.
_FITTING = ((48, 1024), 256)


def _refusal_control(device) -> list:
    """The smem control goes on on the card: the flagged example must be
    refused by the C side as a status (``RuntimeError``), and the same
    kernel at a shape inside the budget must launch and copy exactly — so
    the refusal is the budget's, not a broken kernel's."""
    from .fixtures.badkernel.contract import CONTRACT
    from .fixtures.badkernel.ops import big_copy
    findings = []
    ex = CONTRACT.example()
    x = torch.zeros(ex.args[0].shape, dtype=ex.args[0].dtype, device=device)
    try:
        big_copy(x, **ex.kwargs)
        torch.cuda.synchronize(device)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    del x
    if refused is None:
        findings.append(Finding(
            "controls.smem-refusal-missing", "badkernel", "no-refusal",
            "the example flagged by kernels.smem-overflow launched on the "
            "card instead of being refused"))
    (shape, bn) = _FITTING
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    y = torch.randn(shape, generator=gen, device=device)
    try:
        ok = bool(torch.equal(big_copy(y, bn=bn), y))
    except RuntimeError as e:
        ok = False
        refused = f"{refused}; at {shape}: {e}"
    if not ok:
        findings.append(Finding(
            "controls.smem-refusal-spurious", "badkernel", "fitting-shape",
            f"the fixture kernel at {shape} (inside the budget) was refused "
            f"or copied wrongly: {refused}"))
    return findings


def run_all(*, device="cpu", controls: bool = True) -> Report:
    """Every pass on ``device`` ('cpu', or a CUDA device for the card-side
    kernel checks and the entries on the card)."""
    device = torch.device(device)
    report = Report()

    entries = registry.load_entry_points()
    for ep in entries:
        report.extend(analyze_entry(ep, device))
    report.mark_pass("dataflow", [e.name for e in entries])

    findings, pkgs = check_all_kernels(device)
    report.extend(findings)
    report.mark_pass("kernels", pkgs)

    findings, files = lint_tree()
    report.extend(findings)
    report.mark_pass("lint", files)

    if controls:
        report.extend(run_controls(device))
        report.mark_pass("controls", CONTROLS)
    return report
