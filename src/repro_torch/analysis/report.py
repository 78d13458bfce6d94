"""Findings, fingerprints, and the suppression baseline (counterpart of
``repro.analysis.report``, the same fingerprint).

Every analysis pass emits :class:`Finding` records.  A finding's
``fingerprint`` is a stable hash of (rule, subject, detail-key) — line
numbers and free-text messages are deliberately EXCLUDED so the baseline
survives unrelated edits to the same file.  The CLI compares the run's
fingerprints against the checked-in baseline (``analysis/baseline.json``)
and exits nonzero only on NEW findings; fixing a suppressed finding makes
its baseline entry stale, which is reported (but not fatal) so the
baseline ratchets monotonically toward empty.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field
from pathlib import Path

__all__ = ["Finding", "Report", "load_baseline", "save_baseline",
           "diff_against_baseline", "BASELINE_PATH"]

# The one checked-in suppression file, next to this module.
BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"

SEVERITIES = ("error", "warning", "info")


@dataclass(frozen=True)
class Finding:
    """One violation of one rule.

    ``rule``     dotted rule id, e.g. ``dataflow.collective-overlap``.
    ``subject``  the thing analyzed: entry-point name, kernel package,
                 or ``path/to/file.py`` for lint findings.
    ``key``      stable discriminator WITHIN the subject (eqn role,
                 function name, constant name) — part of the fingerprint,
                 so it must not contain line numbers or array values.
    ``message``  human text with the concrete numbers; NOT fingerprinted.
    ``severity`` 'error' gates CI; 'warning'/'info' are advisory.
    """
    rule: str
    subject: str
    key: str
    message: str
    severity: str = "error"

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, got "
                             f"{self.severity!r}")

    @property
    def fingerprint(self) -> str:
        raw = f"{self.rule}\x1f{self.subject}\x1f{self.key}"
        return hashlib.sha256(raw.encode()).hexdigest()[:16]


@dataclass
class Report:
    """Accumulated findings of one analyzer run, JSON-serializable."""
    findings: list = field(default_factory=list)
    passes_run: list = field(default_factory=list)
    subjects: dict = field(default_factory=dict)   # pass -> [subject, ...]

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings) -> None:
        for f in findings:
            self.add(f)

    def mark_pass(self, name: str, subjects) -> None:
        self.passes_run.append(name)
        self.subjects[name] = sorted(subjects)

    def errors(self):
        return [f for f in self.findings if f.severity == "error"]

    def to_json(self) -> dict:
        return {
            "passes_run": self.passes_run,
            "subjects": self.subjects,
            "findings": [dict(asdict(f), fingerprint=f.fingerprint)
                         for f in self.findings],
        }

    def write(self, path) -> None:
        Path(path).write_text(json.dumps(self.to_json(), indent=2,
                                         sort_keys=True) + "\n")


def load_baseline(path=BASELINE_PATH) -> dict:
    """fingerprint -> {'rule', 'subject', 'key', 'reason'} of suppressed
    findings.  A missing file is an empty baseline."""
    p = Path(path)
    if not p.exists():
        return {}
    data = json.loads(p.read_text())
    return {e["fingerprint"]: e for e in data.get("suppressions", [])}


def save_baseline(findings, path=BASELINE_PATH, *, reason="baselined") -> None:
    """Write the suppression file for ``findings`` (the ``--update-baseline``
    path; entries keep enough context to audit without rerunning)."""
    entries = [{"fingerprint": f.fingerprint, "rule": f.rule,
                "subject": f.subject, "key": f.key, "reason": reason}
               for f in sorted(findings,
                               key=lambda f: (f.rule, f.subject, f.key))]
    Path(path).write_text(json.dumps({"suppressions": entries}, indent=2,
                                     sort_keys=True) + "\n")


def diff_against_baseline(report: Report, baseline: dict):
    """Split error findings into (new, suppressed) and list stale
    suppressions (baseline entries nothing matched this run)."""
    seen = set()
    new, suppressed = [], []
    for f in report.errors():
        seen.add(f.fingerprint)
        (suppressed if f.fingerprint in baseline else new).append(f)
    stale = [e for fp, e in sorted(baseline.items()) if fp not in seen]
    return new, suppressed, stale
