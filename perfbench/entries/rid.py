"""The entry ``rid``: the port's randomized ID (``repro_torch``) of one
matrix held on the device, and the check of its answers.

A traffic file names its entry (``"entry": "rid"``); the harness loads
``entries/<entry>.py`` and builds its ``System(config, traffic, seed,
device)``.  This is the one module of the benchmark that imports the
program.  The untraced window calls ``rid`` as a user does.  The traced
window calls the two public stages that ``rid`` composes, ``sketch`` then
``rid_from_sketch``, under the benchmark's own profiler ranges, so that
each kernel's device time falls to the stage that launched it.

After the window, ``check`` holds a sample of the window's answers to the
plain reference (``reference.py``), number by number, each against its
limit (``limits/<dtype>.json``).
"""
from __future__ import annotations

import math
import sys

import torch
from torch.profiler import record_function

from perfbench import reference
from perfbench.workload import ROOT, dtype_of, make_factors, make_matrix

__all__ = ["ID_RANGE", "STAGE_RANGES", "CHECK_SEED", "System", "compare"]

ID_RANGE = "bench.id"
SKETCH_RANGE = "bench.sketch"
QR_RANGE = "bench.qr_interp"
STAGE_RANGES = (SKETCH_RANGE, QR_RANGE)

# Seeds the power iteration of eq. (3), apart from every sketch seed.
CHECK_SEED = 0x0E93


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """``||got - want||_F / ||want||_F`` in ``want``'s dtype; ``inf`` where
    the shapes differ."""
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    d = torch.linalg.vector_norm(got.to(want.dtype) - want)
    return float(d / torch.linalg.vector_norm(want))


def compare(A: torch.Tensor, out, ref, Y_ref: torch.Tensor, k: int,
            seed: int, sigma: float) -> dict:
    """The numbers compared for one ID: the program's ``out`` (B, P, J, Q,
    R) against the reference ``ref`` of the same seed; ``eq3`` is the
    residual over eq. (3)'s right-hand side with ``sigma_{k+1} = sigma``."""
    m, n = A.shape
    J, J_ref = out.J.to(A.device), ref.J
    if J.shape == J_ref.shape:
        pivots = int((J != J_ref).sum())
    else:
        pivots = k
    B = out.B.to(A.dtype)
    B_ref = A.index_select(1, J_ref)
    if B.shape == B_ref.shape:
        subset = float((B - B_ref).abs().max())
    else:
        subset = math.inf
    bound = reference.error_bound(m, n, k) * sigma
    P = out.P.to(torch.promote_types(A.dtype, out.P.dtype))
    Y = out.Q @ out.R
    return {
        "pivots": pivots,
        "subset": subset,
        "sketch": _rel(Y, Y_ref),
        "r": _rel(out.R, ref.R),
        "p": _rel(out.P, ref.P),
        "eq3": reference.spectral_error(CHECK_SEED ^ seed, A, B, P) / bound,
    }


class System:
    """The port's ID of the configuration's ``A = B0 P0`` (made on the
    device from ``seed``) at one traffic mix: ``call(seed)`` runs one ID
    and waits for the device."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        src = str(ROOT / "src")
        if src not in sys.path:
            sys.path.insert(0, src)
        from repro_torch.core.rid import rid, rid_from_sketch
        from repro_torch.core.sketch import sketch
        self._rid, self._rid_from_sketch = rid, rid_from_sketch
        self._sketch = sketch
        self.config, self.traffic = config, traffic
        self.seed = seed
        self.device = torch.device(device)
        self.k = config["k"]
        self.l = config["l_over_k"] * self.k
        self.kind = traffic["sketch_kind"]
        self.qr_impl = traffic["qr_impl"]
        self.qr_panel = traffic["qr_panel"]
        self.A = make_matrix(seed, config, self.device)
        if self.A.dtype != dtype_of(config["dtype"]):
            raise TypeError(f"matrix dtype {self.A.dtype} is not "
                            f"{config['dtype']}")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, seed: int):
        """One ID through ``rid``, as a user calls it."""
        out = self._rid(seed, self.A, self.k, l=self.l,
                        sketch_kind=self.kind, qr_impl=self.qr_impl,
                        qr_panel=self.qr_panel)
        self._sync()
        return out

    def call_staged(self, seed: int):
        """One ID through the stages ``rid`` composes, under the ranges
        ``bench.id`` (the whole call with its wait), ``bench.sketch`` and
        ``bench.qr_interp``."""
        with record_function(ID_RANGE):
            with record_function(SKETCH_RANGE):
                Y = self._sketch(seed, self.A, self.l, kind=self.kind).Y
            with record_function(QR_RANGE):
                out = self._rid_from_sketch(self.A, Y, self.k,
                                            qr_impl=self.qr_impl,
                                            qr_panel=self.qr_panel)
            del Y
            self._sync()
        return out

    def check(self, sample, limits: dict, control: bool = False):
        """Worst of each number over ``sample`` (``(seed, out)`` pairs), and
        whether every one is within its limit.  With ``control`` the
        reference in the next lower precision stands in the program's
        place."""
        A, k = self.A, self.k
        B0, P0 = make_factors(self.seed, self.config, A.device)
        sigma = reference.sigma_kp1_lower(A, B0, P0, k)
        del B0, P0
        worst = {}
        for seed, out in sample:
            ref, Y_ref = reference.decompose(self.kind, seed, A, k, self.l,
                                             self.qr_panel)
            if control:
                out, _ = reference.decompose(
                    self.kind, seed, A, k, self.l, self.qr_panel,
                    dtype_of(limits["control_dtype"]))
            nums = compare(A, out, ref, Y_ref, k, seed, sigma)
            del ref, Y_ref, out
            for key, v in nums.items():
                if not (v == v) or v > worst.get(key, -1.0):   # NaN is worst
                    worst[key] = v if v == v else math.inf
        lim = limits["limits"]
        check = {key: {"value": v, "limit": lim[key]}
                 for key, v in worst.items()}
        ok = bool(sample) and all(c["value"] <= c["limit"]
                                  for c in check.values())
        return check, ok
