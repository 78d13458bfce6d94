"""AST convention lint (``lint.*`` rules) over ``src/repro_torch``
(counterpart of ``repro.analysis.lint``).

The conventions are the repo's own, turned into checks:

  ``lint.valueerror-no-value``    ``raise ValueError(...)`` whose message
                                  interpolates NO value (no f-string
                                  field): the error cannot name the
                                  argument or the offending value.
  ``lint.torch-global-mutation``  ``torch.set_default_dtype``,
                                  ``torch.set_default_device``, the global
                                  ``torch.manual_seed`` (a
                                  ``Generator.manual_seed`` is fine),
                                  ``torch.set_float32_matmul_precision``
                                  or an assignment to
                                  ``torch.backends.*.allow_tf32`` in
                                  library code — process-global state that
                                  silently changes every caller's dtypes,
                                  draws or GEMM precision (TF32 would
                                  break the eq. (3) error bound); the
                                  counterpart of the reference's
                                  ``lint.jax-config-mutation``.
  ``lint.global-clock-prng``      wall-clock calls (``time.time()`` et
                                  al.), ``import time`` for timing, or
                                  global PRNG (``random.*``,
                                  ``np.random.*``) in library code;
                                  randomness flows through seeded
                                  ``torch.Generator`` objects, clocks
                                  flow through ``repro_torch.obs.clock``
                                  — the ONE allowlisted wall-clock call
                                  site — and are injected.
  ``lint.time-sleep``             ``time.sleep(...)`` in library code —
                                  an untestable blocking wait; waits go
                                  through an injected ``Clock.sleep``
                                  (``obs.clock`` is the one sanctioned
                                  implementation, and ``FakeClock``
                                  makes retry/backoff tests instant).
  ``lint.string-switch``          an if/elif chain comparing one variable
                                  against >= 3 string literals — dispatch
                                  tables are the convention.
  ``lint.socket-server``          ``socket`` / ``socketserver`` /
                                  ``http.server`` imports in library code
                                  — a stray listener in a numeric library
                                  is an attack surface and a test hazard;
                                  ``obs/telemetry.py`` is the ONE
                                  sanctioned server module (the
                                  ``/metrics``, ``/healthz`` and
                                  ``/progress`` endpoint), mirroring the
                                  ``obs/clock.py`` clock allowlist.
  ``lint.duplicate-validation``   a re-inlined copy of the canonical
                                  rank/panel bound messages outside
                                  ``core/validate.py`` — shared
                                  validation must go through it.

Scope: the ValueError and duplicate-validation rules run on ALL of
``src/repro_torch``; the behavioral rules (global state, clock, switch)
run on the LIBRARY dirs only — ``launch/`` and ``benchmarks/`` are
scripts that legitimately time things, as the repository's root
``benchmarks/`` is outside the reference's lint.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .report import Finding

__all__ = ["lint_file", "lint_tree", "LIBRARY_DIRS"]

LIBRARY_DIRS = ("core", "kernels", "models", "serving", "data", "analysis",
                "obs")

# The single sanctioned wall-clock call site: every other library module
# gets its time through an injected Clock (or the ambient tracer), so
# both the clock-call rule and the import-time rule skip exactly here.
_CLOCK_HOME = ("obs", "clock.py")

# The single sanctioned socket/server module: the telemetry endpoint
# (/metrics, /healthz, /progress).  Anywhere else, a listening socket in
# library code is a lint.socket-server finding.
_SERVER_HOME = ("obs", "telemetry.py")

# Modules whose import anywhere else in the library trips the rule
# (http.server pulls in socketserver pulls in socket — ban all three
# entry points so the finding names the door actually used).
_SERVER_MODULES = ("socket", "socketserver", "http.server")

# The canonical shared-validation message prefixes (core/validate.py);
# their reappearance elsewhere is a copy-paste of the helpers.
_CANON_VALIDATION = ("need 0 < k <= min(l, n)", "need l >= k")

_CLOCK_CALLS = {("time", "time"), ("time", "monotonic"),
                ("time", "perf_counter"), ("time", "process_time")}

# Process-global torch state: the calls, and the attribute assigned under
# torch.backends.
_TORCH_GLOBAL_CALLS = {("torch", "set_default_dtype"),
                       ("torch", "set_default_device"),
                       ("torch", "manual_seed"),
                       ("torch", "set_float32_matmul_precision")}
_TORCH_GLOBAL_ATTR = "allow_tf32"


def _attr_chain(node):
    """('np', 'random', 'default_rng') for np.random.default_rng, else ()."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _is_library(rel: Path) -> bool:
    return len(rel.parts) > 1 and rel.parts[0] in LIBRARY_DIRS


def _string_switch_runs(tree):
    """Yield (lineno, var, n) for if/elif chains comparing one Name
    against n >= 3 distinct string literals."""
    chained = set()          # elif nodes already counted in a parent chain
    for node in ast.walk(tree):
        if not isinstance(node, ast.If) or id(node) in chained:
            continue
        n, cur, var = 0, node, None
        while isinstance(cur, ast.If):
            t = cur.test
            if (isinstance(t, ast.Compare) and isinstance(t.left, ast.Name)
                    and len(t.ops) == 1 and isinstance(t.ops[0], ast.Eq)
                    and isinstance(t.comparators[0], ast.Constant)
                    and isinstance(t.comparators[0].value, str)
                    and var in (None, t.left.id)):
                var = t.left.id
                n += 1
            else:
                break
            nxt = cur.orelse[0] if (len(cur.orelse) == 1 and
                                    isinstance(cur.orelse[0], ast.If)) \
                else None
            if nxt is not None:
                chained.add(id(nxt))
            cur = nxt
        if n >= 3:
            yield node.lineno, var, n


def lint_file(path, rel: Path) -> list:
    """All lint findings for one file; ``rel`` is the path relative to
    ``src/repro_torch`` (the finding subject and the scoping key)."""
    src = Path(path).read_text()
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding("lint.parse-error", str(rel), "syntax",
                        f"file does not parse: {e}")]
    findings = []
    subject = str(rel)
    in_library = _is_library(rel)
    is_validate = rel.parts[-2:] == ("core", "validate.py")
    is_clock_home = rel.parts[-2:] == _CLOCK_HOME
    is_server_home = rel.parts[-2:] == _SERVER_HOME

    for node in ast.walk(tree):
        # -- ValueError without an interpolated value ------------------
        if (isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)
                and isinstance(node.exc.func, ast.Name)
                and node.exc.func.id == "ValueError"):
            interpolated = any(isinstance(sub, ast.FormattedValue)
                               for a in node.exc.args for sub in ast.walk(a))
            if not interpolated:
                findings.append(Finding(
                    "lint.valueerror-no-value", subject,
                    f"raise-{_raise_key(node)}",
                    f"line {node.lineno}: raise ValueError(...) without an "
                    f"interpolated value — the message must name the "
                    f"argument and the value it got"))
            elif not is_validate:
                msg_text = "".join(
                    sub.value for a in node.exc.args
                    for sub in ast.walk(a)
                    if isinstance(sub, ast.Constant)
                    and isinstance(sub.value, str))
                for canon in _CANON_VALIDATION:
                    if canon in msg_text:
                        findings.append(Finding(
                            "lint.duplicate-validation", subject, canon,
                            f"line {node.lineno}: re-inlines the canonical "
                            f"message {canon!r} — call the core/validate.py "
                            f"helper instead"))

        if not in_library:
            continue

        # -- process-global torch state ---------------------------------
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if chain[:2] in _TORCH_GLOBAL_CALLS:
                findings.append(Finding(
                    "lint.torch-global-mutation", subject, chain[1],
                    f"line {node.lineno}: {'.'.join(chain)}() in library "
                    f"code mutates process-global dtype/RNG/precision "
                    f"state"))
            # -- global clock / PRNG -----------------------------------
            if chain[:2] in _CLOCK_CALLS and not is_clock_home:
                findings.append(Finding(
                    "lint.global-clock-prng", subject,
                    f"clock-{'.'.join(chain[:2])}",
                    f"line {node.lineno}: {'.'.join(chain)}() — inject a "
                    f"clock (repro_torch.obs.clock) instead of reading the "
                    f"wall clock in library code"))
            if chain[:2] == ("time", "sleep") and not is_clock_home:
                findings.append(Finding(
                    "lint.time-sleep", subject, "time.sleep",
                    f"line {node.lineno}: time.sleep in library code is an "
                    f"untestable blocking wait — route it through an "
                    f"injected Clock.sleep (obs.clock owns the real one; "
                    f"FakeClock makes retry/backoff tests instant)"))
            if chain[:2] in {("np", "random"), ("numpy", "random")} or \
                    (len(chain) == 2 and chain[0] == "random"):
                findings.append(Finding(
                    "lint.global-clock-prng", subject,
                    f"prng-{'.'.join(chain[:2])}",
                    f"line {node.lineno}: {'.'.join(chain)}(...) — global "
                    f"PRNG in library code; thread a seeded "
                    f"torch.Generator instead"))
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                chain = _attr_chain(tgt)
                if chain[:2] == ("torch", "backends") and \
                        chain[-1] == _TORCH_GLOBAL_ATTR:
                    findings.append(Finding(
                        "lint.torch-global-mutation", subject, "allow_tf32",
                        f"line {node.lineno}: assigning "
                        f"{'.'.join(chain)} in library code turns TF32 "
                        f"GEMMs on or off for every caller"))
        # -- importing the time module for timing ----------------------
        if not is_clock_home:
            timed = ()
            if isinstance(node, ast.Import):
                timed = tuple(a.name for a in node.names if a.name == "time")
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                timed = ("time",)
            if timed:
                findings.append(Finding(
                    "lint.global-clock-prng", subject, "import-time",
                    f"line {node.lineno}: imports the time module in "
                    f"library code — timing goes through repro_torch.obs "
                    f"(obs.clock is the one sanctioned call site)"))
        # -- socket / HTTP-server imports ------------------------------
        if not is_server_home:
            served = ()
            if isinstance(node, ast.Import):
                served = tuple(a.name for a in node.names
                               if a.name in _SERVER_MODULES)
            elif isinstance(node, ast.ImportFrom) and \
                    node.module in _SERVER_MODULES:
                served = (node.module,)
            for mod in served:
                findings.append(Finding(
                    "lint.socket-server", subject, f"import-{mod}",
                    f"line {node.lineno}: imports {mod} in library code — "
                    f"a listening socket outside obs/telemetry.py (the one "
                    f"sanctioned /metrics server) is an attack surface and "
                    f"a test hazard"))

    if in_library:
        for lineno, var, n in _string_switch_runs(tree):
            findings.append(Finding(
                "lint.string-switch", subject, f"switch-{var}",
                f"line {lineno}: if/elif chain compares {var!r} against "
                f"{n} string literals — use a dispatch dict"))
    return findings


def _raise_key(node) -> str:
    """Fingerprint key for a raise site: the enclosing text is volatile,
    so key on the exception arg source (stable under line moves)."""
    try:
        return ast.unparse(node.exc.args[0])[:60] if node.exc.args else "empty"
    except Exception:
        return "unparse-failed"


def lint_tree(root=None) -> tuple:
    """(findings, files-scanned) over every .py under ``src/repro_torch``."""
    root = Path(root) if root is not None else \
        Path(__file__).resolve().parents[1]
    findings, files = [], []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root)
        files.append(str(rel))
        findings.extend(lint_file(path, rel))
    return findings, files
