"""repro_torch.analysis: the port's performance invariants as CI-enforced
contracts (counterpart of ``repro.analysis``).

Three passes (see README.md in this directory for the rule catalog):

  * :mod:`.dataflow` — rules over one recorded eager call of each
                       registered entry point (collective overlap,
                       replication blowups, dtype leaks, host syncs);
  * :mod:`.kernels`  — kernel package contracts (exports, ops/ref
                       signature coupling, pinned constants against the
                       CUDA sources, eager validation, shared memory per
                       block, and on a card the launch geometry);
  * :mod:`.lint`     — AST conventions over ``src/repro_torch``.

Entry points self-register via :mod:`.registry`; run everything with
``python -m repro_torch.analysis`` (see :mod:`.__main__`).  This package
import stays light — the passes import lazily.
"""
from .registry import EntryPoint, OverlapSpec, register  # noqa: F401
from .report import Finding, Report                      # noqa: F401

__all__ = ["EntryPoint", "OverlapSpec", "register", "Finding", "Report"]
