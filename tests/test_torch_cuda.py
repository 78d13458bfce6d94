"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and the slice on the card end to end.

Every test here carries the ``cuda`` marker and skips inside its body when
there is no CUDA device (so every worker collects the same tests).  Run on
a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*.py

This file imports neither jax nor the reference package, so it also runs
where JAX is not installed.
"""
import math

import pytest
import torch

from repro_torch.core import error_bound, expected_sigma_kp1, rid, spectral_error
from repro_torch.kernels.panel_step import panel_step
from repro_torch.kernels.panel_step.kernel import LAUNCHES as PANEL_LAUNCHES
from repro_torch.kernels.panel_step.ref import panel_step_ref
from repro_torch.kernels.sketch_accum import sketch_accum
from repro_torch.kernels.sketch_accum.kernel import LAUNCHES as ACCUM_LAUNCHES
from repro_torch.kernels.sketch_accum.ref import sketch_accum_ref

DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]
# Relative to the largest entry of the plain output: the kernel and the
# plain version (library GEMMs) sum in different orders.
REL_TOL = {torch.float32: 1e-4, torch.complex64: 1e-4,
           torch.float64: 1e-10, torch.complex128: 1e-10}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev):
    if dtype.is_complex:
        rdt = dtype.to_real()
        return torch.complex(torch.randn(shape, generator=gen, dtype=rdt, device=dev),
                             torch.randn(shape, generator=gen, dtype=rdt, device=dev))
    return torch.randn(shape, generator=gen, dtype=dtype, device=dev)


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_sketch_accum_matches_plain(dtype):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(0)
    for l, m, n in [(8, 128, 32), (70, 300, 150), (130, 1037, 257)]:
        x, a, acc = (_randn(gen, s, dtype, dev) for s in ((l, m), (m, n), (l, n)))
        before = ACCUM_LAUNCHES.count
        got = sketch_accum(x, a, acc)
        assert ACCUM_LAUNCHES.count == before + 1
        assert _rel(got, sketch_accum_ref(x, a, acc)) <= REL_TOL[dtype]
        acc_c = acc
        for r0 in range(0, m, 256):                 # block-multiple chunks
            acc_c = sketch_accum(x[:, r0:r0 + 256].contiguous(), a[r0:r0 + 256], acc_c)
        assert torch.equal(acc_c, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [32, 16, 7, 64])
def test_cuda_panel_step_matches_plain(dtype, b):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(1)
    l, n = 200, 300
    c, z = _randn(gen, (l, b), dtype, dev), _randn(gen, (l, n), dtype, dev)
    before = PANEL_LAUNCHES.count
    got = panel_step(c, z)
    assert PANEL_LAUNCHES.count == before + 1
    for g, w in zip(got, panel_step_ref(c, z)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _rel(g, w) <= REL_TOL[dtype]
    qp, o, w_none, r2 = panel_step(c, z, emit_w=False)
    assert w_none is None and torch.equal(o, got[1]) and torch.equal(r2, got[3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_panel_step_duplicate_columns_finite(dtype):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(2)
    c8 = _randn(gen, (64, 8), dtype, dev)
    qp, o, _, r2 = panel_step(torch.cat([c8, c8], 1), _randn(gen, (64, 100), dtype, dev),
                              emit_w=False)
    assert all(bool(torch.isfinite(t).all()) for t in (qp, o, r2))
    eps = torch.finfo(dtype.to_real() if dtype.is_complex else dtype).eps
    orth = float((qp.mH @ qp - torch.eye(16, dtype=dtype, device=dev)).abs().max())
    assert orth > math.sqrt(eps)


@pytest.mark.cuda
def test_cuda_kernels_refuse_other_dtypes():
    dev = _device()
    with pytest.raises(TypeError):
        panel_step(torch.ones(8, 2, dtype=torch.float16, device=dev),
                   torch.ones(8, 4, dtype=torch.float16, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("sketch_kind,dtype", [("gaussian", torch.float64),
                                               ("srft", torch.complex128),
                                               ("gaussian", torch.float32)])
def test_cuda_rid_end_to_end(sketch_kind, dtype):
    """rid on the card: the kernels carry the path (panel_step once per
    panel), J and P are well formed, and eq. (3) holds (f64/c128)."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(3)
    m, n, k = 1024, 768, 40
    A = _randn(gen, (m, k), dtype, dev) @ _randn(gen, (k, n), dtype, dev)
    ACCUM_LAUNCHES.reset()
    PANEL_LAUNCHES.reset()
    dec = rid(5, A, k, sketch_kind=sketch_kind, qr_panel=16)
    assert PANEL_LAUNCHES.count == math.ceil(k / 16)
    assert ACCUM_LAUNCHES.count == (1 if sketch_kind == "gaussian" else 0)
    assert int(torch.unique(dec.J).numel()) == k
    assert torch.equal(dec.P[:, dec.J], torch.eye(k, dtype=dec.P.dtype, device=dev))
    if dtype in (torch.float64, torch.complex128):
        err = float(spectral_error(6, A, dec.B, dec.P))
        assert err <= error_bound(m, n, k) * expected_sigma_kp1(m, n)
