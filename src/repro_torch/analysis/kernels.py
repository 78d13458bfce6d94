"""Kernel contract checker (``kernels.*`` rules; counterpart of
``repro.analysis.kernels``).

Every ``kernels/<name>/`` package ships a ``contract.py`` declaring a
:class:`~repro_torch.kernels.common.KernelContract`; this pass verifies
the declarations against the code:

  ``kernels.missing-contract``    a kernel package without a contract.py
  ``kernels.missing-export``      a declared ops/kernel/ref name that the
                                  module does not export
  ``kernels.signature-mismatch``  an (ops, ref) pair whose leading
                                  positional parameter names disagree
  ``kernels.constant-drift``      a pinned kernel.py constant whose value
                                  changed, or that no longer equals the
                                  ``constexpr int`` of the CUDA source it
                                  must equal (parsed from the source)
  ``kernels.validation-missing``  the declared known-bad call did not
                                  raise ValueError eagerly on CPU tensors
  ``kernels.smem-overflow``       a declared launch asks for more shared
                                  memory per block than the budget
                                  (232448 B on Hopper; dynamic bytes, plus
                                  the kernel's static bytes on the card),
                                  or for more than 1024 threads per block
  ``kernels.control-failed``      the example declares no launch, cannot
                                  be built, or (on the card) ran without
                                  launching a kernel
  ``kernels.geometry-drift``      (on the card) the wrapper's calls of the
                                  C entry points differ from the declared
                                  launches, the C side would launch
                                  another number of kernels a call, or
                                  another grid, block or shared size, or a
                                  declared kernel uses more than 255
                                  registers or spills (``-Xptxas -v``)
  ``kernels.residency`` (info)    (on the card, ``measure_residency``) the
                                  example's live device bytes before and
                                  after (``residency.live_device_bytes``)
                                  and its peak allocated bytes

The static part runs anywhere, without nvcc or a card: the declared
launches are computed by the kernel modules' geometry functions.  With
``device="cuda"`` the example also runs once for real, its calls of the
C library are recorded, and each declared launch is held to what the C
entry point would launch (``_build.query_launches``, which launches
nothing, so an over-budget launch is still checked).
"""
from __future__ import annotations

import contextlib
import importlib
import inspect
import pkgutil
import re
from pathlib import Path

import torch

from ..core.rng import check_device
from ..kernels import _build
from ..kernels.common import MAX_THREADS_PER_BLOCK, LaunchCounter
from .report import Finding
from .residency import live_device_bytes

__all__ = ["kernel_packages", "check_package", "check_all_kernels",
           "c_constant", "record_library_calls", "hold_launch",
           "geometry_report", "KERNELS_BASE"]

KERNELS_BASE = "repro_torch.kernels"
_CSRC = Path(_build.__file__).resolve().parents[1] / "csrc"
# A query argument standing for a device pointer (never dereferenced).
_FAKE_PTR = 16


def kernel_packages() -> list:
    """Names of all ``repro_torch.kernels.*`` packages (directories)."""
    import repro_torch.kernels as K
    return sorted(m.name for m in pkgutil.iter_modules(K.__path__)
                  if m.ispkg)


def _positional_names(fn) -> list:
    """Leading POSITIONAL_OR_KEYWORD parameter names (tuning kwargs are
    keyword-only and excluded)."""
    sig = inspect.signature(fn)
    return [p.name for p in sig.parameters.values()
            if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]


def c_constant(path: Path, name: str):
    """The value of ``constexpr int <name> = <value>`` in ``path``, or
    ``None`` if the file does not declare it."""
    m = re.search(rf"constexpr\s+int\b[^;]*?\b{re.escape(name)}\s*=\s*(\d+)",
                  path.read_text())
    return int(m.group(1)) if m else None


def _source(pkg_dir: Path, fname: str) -> Path:
    """A CUDA source named by a contract: beside the package, else in
    ``csrc``."""
    local = pkg_dir / fname
    return local if local.exists() else _CSRC / fname


# ------------------------------------------------------ library recorder

class _Recorder:
    """A library stand-in that logs every C entry call, then makes it."""

    def __init__(self, lib, log: list):
        self._lib, self._log = lib, log

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not name.startswith("repro_") or name in (
                "repro_error_string", "repro_query_begin", "repro_query_end"):
            return fn

        def call(*args):
            self._log.append((name, args))
            return fn(*args)
        return call


@contextlib.contextmanager
def record_library_calls(names):
    """Log the C entry calls made through the loaded libraries ``names``
    (``_build``'s cache) while the context is open: ``[(entry, args)]``."""
    log: list = []
    saved = {name: _build._libs[name] for name in names}
    try:
        for name, lib in saved.items():
            _build._libs[name] = _Recorder(lib, log)
        yield log
    finally:
        _build._libs.update(saved)


def _library(launch, base: str, pkg: str):
    if launch.library == "kernels":
        return _build.load_library()
    return importlib.import_module(f"{base}.{pkg}.kernel").library()


def _materialize(t: torch.Tensor, device, gen) -> torch.Tensor:
    if t.dtype.is_floating_point or t.dtype.is_complex:
        return torch.randn(t.shape, dtype=t.dtype, device=device,
                           generator=gen)
    return torch.zeros(t.shape, dtype=t.dtype, device=device)


def _launch_count(mod) -> int:
    return sum(v.count for v in vars(mod).values()
               if isinstance(v, LaunchCounter))


def _ptxas(kernel: str):
    """The ``-Xptxas -v`` record of ``kernel`` from any library built."""
    for info in _build.build_info["libraries"].values():
        for rec in info["ptxas"]:
            if rec["kernel"] == kernel:
                return rec
    return None


def _card_checks(pkg: str, base: str, contract, example, over: set,
                 device) -> list:
    """Run the example on the card once (unless a launch is already over
    budget) and hold every declared launch to the C side."""
    findings = []
    launches = example.launches
    kmod = importlib.import_module(f"{base}.{pkg}.kernel")
    libs = {ln.library: _library(ln, base, pkg) for ln in launches}
    if not over:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        args = [_materialize(a, device, gen) for a in example.args]
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = live_device_bytes()
        n0 = _launch_count(kmod)
        try:
            with record_library_calls(libs) as calls:
                example.fn(*args, **example.kwargs)
            torch.cuda.synchronize(device)
        except Exception as e:
            return [Finding("kernels.control-failed", pkg, "example-run",
                            f"example failed on the card: "
                            f"{type(e).__name__}: {e}")]
        if _launch_count(kmod) == n0:
            findings.append(Finding(
                "kernels.control-failed", pkg, "no-launch-on-card",
                "the example ran on the card without launching a kernel"))
        # One C call per launch declared as the first part of its call.
        firsts = [ln for ln in launches if ln.part == 0]
        got = []
        for i, (entry, cargs) in enumerate(calls):
            mask = firsts[i].args if i < len(firsts) else ()
            if len(mask) == len(cargs):      # pointers and stream masked
                cargs = tuple(None if d is None else a
                              for a, d in zip(cargs, mask))
            got.append((entry, tuple(cargs)))
        want = [(ln.entry, ln.args) for ln in firsts]
        if got != want:
            findings.append(Finding(
                "kernels.geometry-drift", pkg, "wrapper-calls",
                f"the wrapper called {got}, the contract declares {want}"))
        if contract.measure_residency:
            peak = torch.cuda.max_memory_allocated(device)
            findings.append(Finding(
                "kernels.residency", pkg, "measured",
                f"example call: live device bytes {before} -> "
                f"{live_device_bytes()} (residency.live_device_bytes), peak "
                f"{peak} (torch.cuda.max_memory_allocated)",
                severity="info"))
    for i, ln in enumerate(launches):
        row = hold_launch(ln, libs[ln.library], contract.smem_budget)
        if row["status"] or row["c_smem"] is None:
            findings.append(Finding(
                "kernels.geometry-drift", pkg, f"call-{i}-query",
                f"{ln.entry}{ln.args}: the C side returned status "
                f"{row['status']} and not the {ln.parts} launch(es) "
                f"declared for the call"))
            continue
        if not row["equal"]:
            findings.append(Finding(
                "kernels.geometry-drift", pkg, f"call-{i}",
                f"{ln.kernel}: declared grid {ln.grid}, block {ln.threads}, "
                f"{ln.smem} B dynamic shared memory; the C side differs "
                f"({row})"))
        total = row["c_smem"] + row["static_smem"]
        if total > contract.smem_budget and i not in over:
            findings.append(Finding(
                "kernels.smem-overflow", pkg, f"call-{i}",
                f"{ln.kernel}: {row['static_smem']} B static + "
                f"{row['c_smem']} B dynamic shared memory per block exceeds "
                f"the {contract.smem_budget}-byte budget"))
        rec = _ptxas(ln.kernel)
        if rec is None:
            findings.append(Finding(
                "kernels.geometry-drift", pkg, f"call-{i}-ptxas",
                f"{ln.kernel} is not in the build's -Xptxas -v report"))
        elif rec.get("registers", 0) > 255 or row["spills"]:
            findings.append(Finding(
                "kernels.geometry-drift", pkg, f"call-{i}-registers",
                f"{ln.kernel}: {rec.get('registers')} registers, "
                f"{rec.get('spill_stores')} B spill stores, "
                f"{rec.get('spill_loads')} B spill loads (need <= 255, no "
                f"spills)"))
    return findings


def hold_launch(ln, lib, budget: int) -> dict:
    """One declared launch beside the C side's answer for the same call
    (``_build.query_launches``, which launches nothing): the call's
    launch number ``ln.part``, when the call issues ``ln.parts`` launches,
    and the kernel's static attributes; ``equal`` when grid, block and
    dynamic shared bytes agree.  Needs a card."""
    rc, recs = _build.query_launches(
        lib, ln.entry, tuple(_FAKE_PTR if a is None else a for a in ln.args))
    r = recs[ln.part] if len(recs) == ln.parts else {}
    rec = _ptxas(ln.kernel) or {}
    return {"kernel": ln.kernel, "grid": list(ln.grid),
            "threads": ln.threads_per_block, "declared_smem": ln.smem,
            "c_smem": r.get("smem"), "static_smem": r.get("static_smem"),
            "registers": r.get("registers"),
            "spills": rec.get("spill_stores", 0) + rec.get("spill_loads", 0),
            "budget": budget, "status": rc,
            "equal": bool(r) and (
                (r["gx"], r["gy"], r["gz"]) == tuple(ln.grid)
                and (r["bx"], r["by"], r["bz"]) == tuple(ln.threads)
                and r["smem"] == ln.smem)}


def geometry_report(pkg: str, *, base: str = KERNELS_BASE) -> list:
    """``hold_launch`` for every launch of ``pkg``'s contract example (a
    card is needed)."""
    contract = importlib.import_module(f"{base}.{pkg}.contract").CONTRACT
    return [hold_launch(ln, _library(ln, base, pkg), contract.smem_budget)
            for ln in contract.example().launches]


def check_package(pkg: str, *, base: str = KERNELS_BASE,
                  device="cuda") -> list:
    """All contract checks for one ``<base>.<pkg>`` kernel package; the
    card-side checks run when ``device`` is a CUDA device (the default)."""
    findings = []
    device = check_device(device)
    try:
        contract = importlib.import_module(f"{base}.{pkg}.contract").CONTRACT
    except (ImportError, AttributeError) as e:
        return [Finding("kernels.missing-contract", pkg, "contract",
                        f"kernel package has no importable contract.py "
                        f"with a CONTRACT: {e}")]

    mods = {}
    for role, names in (("ops", contract.ops), ("kernel", contract.kernels),
                        ("ref", contract.refs)):
        try:
            mods[role] = importlib.import_module(f"{base}.{pkg}.{role}")
        except ImportError as e:
            findings.append(Finding(
                "kernels.missing-export", pkg, f"{role}-module",
                f"contract names {role}.py exports but the module does "
                f"not import: {e}"))
            continue
        for name in names:
            if not hasattr(mods[role], name):
                findings.append(Finding(
                    "kernels.missing-export", pkg, f"{role}.{name}",
                    f"contract declares {role}.py exports {name!r} but "
                    f"the module has no such attribute"))

    # --- (ops, ref) signature coupling -------------------------------
    if "ops" in mods and "ref" in mods:
        for ops_name, ref_name in contract.pairs:
            ops_fn = getattr(mods["ops"], ops_name, None)
            ref_fn = getattr(mods["ref"], ref_name, None)
            if ops_fn is None or ref_fn is None:
                continue          # already reported as missing-export
            got, want = _positional_names(ops_fn), _positional_names(ref_fn)
            if got != want:
                findings.append(Finding(
                    "kernels.signature-mismatch", pkg,
                    f"{ops_name}/{ref_name}",
                    f"positional parameters disagree: {ops_name}{got} "
                    f"vs {ref_name}{want} — the kernel drifted from its "
                    f"plain version"))

    # --- pinned constants, in Python and against the CUDA source ------
    if "kernel" in mods:
        for cname, expect in contract.constants.items():
            got = getattr(mods["kernel"], cname, None)
            if got != expect:
                findings.append(Finding(
                    "kernels.constant-drift", pkg, cname,
                    f"kernel.py {cname} = {got!r}, contract pins "
                    f"{expect!r} (a replay/bit-for-bit constant)"))
        pkg_dir = Path(mods["kernel"].__file__).parent
        for cname, (fname, cdef) in contract.c_constants.items():
            got = getattr(mods["kernel"], cname, None)
            path = _source(pkg_dir, fname)
            want = c_constant(path, cdef) if path.exists() else None
            if want is None or got != want:
                findings.append(Finding(
                    "kernels.constant-drift", pkg, f"{cname}/{cdef}",
                    f"kernel.py {cname} = {got!r}, but {fname} declares "
                    f"{cdef} = {want!r}: the wrapper and the CUDA source "
                    f"disagree"))

    # --- eager validation ---------------------------------------------
    if contract.bad_call is not None:
        try:
            contract.bad_call()
        except ValueError:
            pass
        except Exception as e:
            findings.append(Finding(
                "kernels.validation-missing", pkg, "bad-call",
                f"known-bad call raised {type(e).__name__} instead of "
                f"ValueError: {e}"))
        else:
            findings.append(Finding(
                "kernels.validation-missing", pkg, "bad-call",
                "known-bad call returned without raising — the ops "
                "wrapper no longer validates its arguments eagerly"))

    # --- shared memory and threads of the declared launches -----------
    if contract.example is None:
        return findings
    try:
        example = contract.example()
    except Exception as e:
        findings.append(Finding(
            "kernels.control-failed", pkg, "example-build",
            f"example failed to build: {type(e).__name__}: {e}"))
        return findings
    if not example.launches:
        findings.append(Finding(
            "kernels.control-failed", pkg, "no-launch",
            "example declares no launch — the shared-memory check was "
            "vacuous"))
    over = set()
    for i, ln in enumerate(example.launches):
        if ln.smem > contract.smem_budget:
            over.add(i)
            findings.append(Finding(
                "kernels.smem-overflow", pkg, f"call-{i}",
                f"{ln.kernel} #{i}: {ln.smem} B of dynamic shared memory "
                f"per block exceeds the {contract.smem_budget}-byte budget "
                f"(grid {ln.grid})"))
        if ln.threads_per_block > MAX_THREADS_PER_BLOCK:
            over.add(i)
            findings.append(Finding(
                "kernels.smem-overflow", pkg, f"call-{i}-threads",
                f"{ln.kernel} #{i}: {ln.threads_per_block} threads per "
                f"block, more than {MAX_THREADS_PER_BLOCK}"))
    if device.type == "cuda" and example.launches:
        findings.extend(_card_checks(pkg, base, contract, example, over,
                                     device))
    return findings


def check_all_kernels(device="cuda") -> tuple:
    """(findings, packages-checked) across every kernel package, on the
    card unless ``device`` names the CPU."""
    device = check_device(device)
    findings, pkgs = [], kernel_packages()
    for pkg in pkgs:
        findings.extend(check_package(pkg, device=device))
    return findings, pkgs
