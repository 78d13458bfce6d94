"""CPU tests of the plain reference and of the check that decides
``correct``: the reference against dense computations at a tiny size, its
frozen copies against the program's, the lower-precision control, and a run
with the timed path broken underneath for each fault the cells can have."""
from __future__ import annotations

import math
import time

import pytest
import torch

import numpy as np

from perfbench import harness, reference
from perfbench.workload import (HERE, load_entry, load_json, load_limits,
                                make_factors, make_matrix)

System = load_entry("rid").System

TINY = dict(load_json(HERE / "configs" / "rid-row0-c128.json"),
            m=512, n=384, k=40)
KINDS = ("gaussian", "srft")


def _traffic(kind):
    return load_json(HERE / "traffic" / f"{kind}.json")


@pytest.mark.parametrize("kind", KINDS)
def test_reference_sketch_is_the_dense_operator_times_a(kind):
    A = make_matrix(3, TINY, "cpu")
    m, l = A.shape[0], 80
    Y = reference.sketch(kind, 17, A, l, A.dtype, A.dtype)
    if kind == "gaussian":
        omega = reference.gaussian_omega(17, l, m, A.dtype, "cpu")
        want = omega @ A / math.sqrt(2 * l)
    else:     # S F D A through the FFT, not the DFT rows written out
        phases, rows = reference.srft_operator(17, l, m, A.dtype, "cpu")
        want = torch.fft.fft(phases[:, None] * A, dim=0)[rows] / math.sqrt(l)
    assert torch.allclose(Y, want, rtol=0, atol=1e-12 * want.abs().max())


@pytest.mark.parametrize("kind", KINDS)
def test_reference_decomposition_is_an_exact_id(kind):
    A = make_matrix(4, TINY, "cpu")
    k = TINY["k"]
    dec, Y = reference.decompose(kind, 5, A, k, 2 * k, 32)
    eye = torch.eye(k, dtype=A.dtype)
    assert dec.J.unique().numel() == k
    assert torch.allclose(dec.Q.mH @ dec.Q, eye, atol=1e-12)
    R1 = dec.R[:, dec.J]
    assert torch.allclose(R1, torch.triu(R1), atol=1e-9 * R1.abs().max())
    d = torch.diagonal(R1)
    assert (d.real > 0).all() and (d.imag.abs() < 1e-9 * d.abs()).all()
    assert torch.equal(dec.P[:, dec.J], eye)
    assert torch.equal(dec.B, A[:, dec.J])
    err = torch.linalg.svdvals(A - dec.B @ dec.P)[0]
    assert err < 1e-9 * torch.linalg.svdvals(A)[0]
    # the power iteration against the dense norm, on an error well above
    # rounding
    g = torch.Generator().manual_seed(0)
    P2 = dec.P + 1e-6 * torch.randn(dec.P.shape, generator=g, dtype=A.dtype)
    want = torch.linalg.svdvals(A - dec.B @ P2)[0]
    est = reference.spectral_error(1, A, dec.B, P2)
    assert est == pytest.approx(float(want), rel=1e-4)   # from below
    # the first panel's pivots are the top residual norms of Y itself
    top = torch.topk((Y.abs() ** 2).sum(0), 32).indices
    assert torch.equal(dec.J[:32], top)


def test_sigma_lower_bound_is_below_the_matrix_and_above_the_estimate():
    from repro_torch.core.errors import expected_sigma_kp1
    B0, P0 = make_factors(6, TINY, "cpu")
    A, k = B0 @ P0, TINY["k"]
    # the product formed exactly: A - B0 P0 against long double (64 bits)
    E = reference.exact_product_residual(A, B0, P0)
    want = (A.numpy().astype(np.clongdouble)
            - B0.numpy().astype(np.clongdouble)
            @ P0.numpy().astype(np.clongdouble)).astype(np.complex128)
    assert np.abs(want).max() > 0
    assert np.linalg.norm(E.numpy() - want) < 2e-3 * np.linalg.norm(want)
    low = reference.sigma_kp1_lower(A, B0, P0, k)
    # the paper's noise-floor estimate lies far under it for A as stored
    assert low > 10 * expected_sigma_kp1(*A.shape)
    # with noise far above rounding the dense SVD is exact enough to hold
    # the bound to: sigma_{2k+1} of the noise, under sigma_{k+1}(A)
    g = torch.Generator().manual_seed(1)
    N = 1e-6 * torch.complex(
        torch.randn(A.shape, generator=g, dtype=torch.float64),
        torch.randn(A.shape, generator=g, dtype=torch.float64))
    low = reference.sigma_kp1_lower(A + N, B0, P0, k)
    assert low == pytest.approx(float(torch.linalg.svdvals(N)[2 * k]),
                                rel=1e-9)
    assert low < float(torch.linalg.svdvals(A + N)[k])
    assert reference.sigma_kp1_lower(A + N, B0, P0, k, cols=128) < low


def test_frozen_copies_equal_the_program_today():
    from repro_torch.core import errors, rng
    from repro_torch.kernels.sketch_accum import ACCUM_BLOCK
    assert reference.ACCUM_BLOCK == ACCUM_BLOCK
    for seed, b in ((0, 0), (2**31 + 5, 511), (2**64 - 1, 3)):
        assert reference.block_seed(seed, b) == rng.block_seed(seed, b)
    for m, n, k in ((2**14, 2**14, 100), (2**16, 2**14, 400)):
        assert reference.error_bound(m, n, k) == errors.error_bound(m, n, k)


def test_limits_sit_between_the_program_and_the_control():
    lim = load_limits("complex128")
    assert lim["control_dtype"] == "complex64"
    assert lim["limits"]["pivots"] == 0 and lim["limits"]["subset"] == 0
    assert lim["limits"]["eq3"] == 1.0


def _run(kind, system_cls=System, control=False, seed=2**31 + 11):
    return harness.run_cell(TINY, _traffic(kind), seed=seed, seconds=1.0,
                            trace=False, device="cpu",
                            t_start=time.perf_counter(), control=control,
                            system_cls=system_cls)


@pytest.mark.parametrize("kind", KINDS)
def test_sound_run_is_correct_and_the_control_is_not(kind):
    run = _run(kind)
    assert run.correct and run.failed == 0 and run.attempted >= 3
    assert list(run.check) == ["pivots", "subset", "sketch", "r", "p", "eq3"]
    ctl = _run(kind, control=True)
    assert not ctl.correct
    failing = {k for k, c in ctl.check.items() if c["value"] > c["limit"]}
    assert {"sketch", "r", "p", "subset", "eq3"} <= failing


class _Stale(System):
    """A step that returns its state unchanged: every ID hands back the
    first one's answer."""

    def call(self, seed):
        if not hasattr(self, "_first"):
            self._first = super().call(seed)
        return self._first


class _HalfRows(System):
    """Half of the batch left out: the sketch reduces over A's first half of
    rows only, scaled as a mean over them."""

    def call(self, seed):
        m = self.A.shape[0]
        Y = self._sketch(seed, self.A[: m // 2], self.l,
                         kind=self.kind).Y * math.sqrt(2)
        return self._rid_from_sketch(self.A, Y, self.k, qr_impl=self.qr_impl,
                                     qr_panel=self.qr_panel)


class _Altered(System):
    """An answer altered where it is produced: one entry of P."""

    def call(self, seed):
        out = super().call(seed)
        col = next(c for c in range(self.A.shape[1])
                   if c not in set(out.J.tolist()))
        out.P[0, col] += 1.0
        return out


@pytest.mark.parametrize("fault", [_Stale, _HalfRows, _Altered],
                         ids=["unchanged", "half_rows", "altered"])
def test_a_broken_timed_path_comes_out_not_correct(fault):
    run = _run("srft", system_cls=fault)
    assert not run.correct
