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
import os

import pytest
import torch

from repro_torch.core import error_bound, expected_sigma_kp1, rid, spectral_error
from repro_torch.kernels.cgs import panel_deflate, project_out
from repro_torch.kernels.cgs.kernel import DEFLATE_LAUNCHES
from repro_torch.kernels.cgs.kernel import LAUNCHES as PROJECT_LAUNCHES
from repro_torch.kernels.cgs.ref import panel_deflate_ref, project_out_ref
from repro_torch.kernels.panel_gram import panel_gram
from repro_torch.kernels.panel_gram.kernel import LAUNCHES as GRAM_LAUNCHES
from repro_torch.kernels.panel_gram.ref import panel_gram_ref
from repro_torch.kernels.panel_step import panel_apply, panel_coeff, panel_step
from repro_torch.kernels.panel_step.kernel import (APPLY_LAUNCHES,
                                                   APPLY_NORMS_LAUNCHES,
                                                   COEFF_LAUNCHES)
from repro_torch.kernels.panel_step.kernel import LAUNCHES as PANEL_LAUNCHES
from repro_torch.kernels.panel_step.ref import (panel_apply_norms_ref,
                                                panel_apply_ref,
                                                panel_coeff_ref,
                                                panel_step_ref)
from repro_torch.kernels.sketch_accum import sketch_accum
from repro_torch.kernels.sketch_accum.kernel import LAUNCHES as ACCUM_LAUNCHES
from repro_torch.kernels.sketch_accum.ref import sketch_accum_ref
from repro_torch.kernels.sketch_matmul import sketch_matmul
from repro_torch.kernels.sketch_matmul.kernel import LAUNCHES as MATMUL_LAUNCHES
from repro_torch.kernels.sketch_matmul.ref import sketch_matmul_ref
from repro_torch.kernels.srht import fwht, fwht_factors, srht
from repro_torch.kernels.srht.kernel import LAUNCHES as FWHT_LAUNCHES
from repro_torch.kernels.srht.ref import fwht_ref, srht_ref
from repro_torch.kernels.tsolve import tsolve
from repro_torch.kernels.tsolve.kernel import LAUNCHES as TSOLVE_LAUNCHES
from repro_torch.kernels.tsolve.ref import tsolve_ref
from torch_ranks import failures, run_ranks

# The train step is deterministic on the card (``launch.steps``): cuBLAS
# reads its workspace setting when the process makes its first GEMM, so it
# is set here, at collection, before any test runs one.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
@pytest.mark.parametrize("l,m,n", [(800, 1024, 300), (130, 1037, 257),
                                   (100, 777, 129)])
def test_cuda_sketch_accum_f64_on_dmma_matches_plain_and_replays(l, m, n):
    """f64 on the FP64 tensor cores: within 1e-10 of the plain version,
    and chunked calls of 128 and of 384 rows (a nonzero acc carried
    through) give the bits of one call."""
    dev = _device()
    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(5)
    x, a, acc = (_randn(gen, s, f64, dev) for s in ((l, m), (m, n), (l, n)))
    got = sketch_accum(x, a, acc)
    assert _rel(got, sketch_accum_ref(x, a, acc)) <= REL_TOL[f64]
    for chunk in (128, 384):
        acc_c = acc
        for r0 in range(0, m, chunk):
            acc_c = sketch_accum(x[:, r0:r0 + chunk].contiguous(),
                                 a[r0:r0 + chunk], acc_c)
        assert torch.equal(acc_c, got), chunk


@pytest.mark.cuda
def test_cuda_sketch_accum_unaligned_operand_gives_the_aligned_bits():
    """a[1:] of an (m + 1, 129) tensor (odd pitch, base 8 bytes off 16)
    against its copy, and an even-pitch operand 8 bytes off 16 against the
    aligned one: the 8-byte copies give the bits of the 16-byte ones."""
    dev = _device()
    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(6)
    l, m = 100, 777
    x = _randn(gen, (l, m), f64, dev)
    a_odd = _randn(gen, (m + 1, 129), f64, dev)[1:]
    assert a_odd.data_ptr() % 16 == 8 and a_odd.is_contiguous()
    acc = _randn(gen, (l, 129), f64, dev)
    got = sketch_accum(x, a_odd, acc)
    assert torch.equal(got, sketch_accum(x, a_odd.clone(), acc))
    assert _rel(got, sketch_accum_ref(x, a_odd, acc)) <= REL_TOL[f64]
    a, acc = _randn(gen, (m, 256), f64, dev), _randn(gen, (l, 256), f64, dev)
    a_off = torch.empty(m * 256 + 1, dtype=f64, device=dev)[1:].view(m, 256)
    a_off.copy_(a)
    assert a_off.data_ptr() % 16 == 8
    assert torch.equal(sketch_accum(x, a_off, acc), sketch_accum(x, a, acc))


@pytest.mark.cuda
def test_cuda_dmma_kernels_run_on_the_tensor_cores_without_spills():
    """DMMA in every f64 kernel of sketch_accum and project_out, no
    tensor-core instruction in their f32 kernels (no TF32), and no spills
    in any of their kernels (cuobjdump -sass, ptxas -v)."""
    from repro_torch.kernels import _build
    _device()
    _build.load_library()
    ops = _build.tensor_core_ops(_build.build_info["path"])
    ptxas = {r["kernel"]: r for r in _build.build_info["ptxas"]}
    for name in ("sketch_accum_dmma_kernel", "project_w_dmma_kernel",
                 "project_o_dmma_kernel"):
        for flag in ("true", "false"):
            assert ops[f"{name}<{flag}>"] == ["DMMA"]
    for name in ("sketch_accum_kernel", "project_w_kernel", "project_o_kernel"):
        assert ops[f"{name}<float32>"] == []
    for kernel, rec in ptxas.items():
        if kernel.startswith(("sketch_accum", "project_")):
            assert not rec.get("spill_stores") and not rec.get("spill_loads"), rec


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
@pytest.mark.parametrize("b", [1, 17, 32, 33, 64])
def test_cuda_panel_step_ragged_shapes(dtype, b):
    """l not a multiple of the ring's 16-row chunk, n not of the slab; W in
    registers up to b = 32, in shared memory past it; against ref.py, and
    a repeated call gives the same bits."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(21)
    l, n = 777, 1001
    c, z = _randn(gen, (l, b), dtype, dev), _randn(gen, (l, n), dtype, dev)
    got = panel_step(c, z)
    for g, w in zip(got, panel_step_ref(c, z)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _rel(g, w) <= REL_TOL[dtype]
    again = panel_step(c, z)
    assert all(torch.equal(u, v) for u, v in zip(got, again))


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


def _norms2(z):
    return (z.abs() ** 2).sum(0).to(z.real.dtype if z.is_complex() else z.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [32, 16, 7, 64])
def test_cuda_panel_coeff_matches_plain(dtype, b):
    """Factor, W and the downdated norms (ragged n), against ref.py."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(4)
    l, n = 200, 301
    c, z = _randn(gen, (l, b), dtype, dev), _randn(gen, (l, n), dtype, dev)
    r2 = _norms2(z)
    r2[::7] = -1.0                              # picked columns' sentinel
    before = COEFF_LAUNCHES.count
    got = panel_coeff(c, z, r2)
    assert COEFF_LAUNCHES.count == before + 1
    for g, w in zip(got, panel_coeff_ref(c, z, r2)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _rel(g, w) <= REL_TOL[dtype]
    assert bool((got[2][::7] == 0).all())
    assert torch.equal(got[0], panel_step(c, z)[0])   # one factor launch


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("emit_norms", [False, True])
def test_cuda_panel_apply_matches_plain(dtype, emit_norms):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(5)
    for l, b, n in [(200, 32, 300), (64, 7, 33), (90, 64, 1)]:
        qp, w, z = (_randn(gen, s, dtype, dev) for s in ((l, b), (b, n), (l, n)))
        before, before_n = APPLY_LAUNCHES.count, APPLY_NORMS_LAUNCHES.count
        got = panel_apply(qp, w, z, emit_norms=emit_norms)
        assert APPLY_LAUNCHES.count == before + 1
        assert APPLY_NORMS_LAUNCHES.count == before_n + int(emit_norms)
        if emit_norms:
            want = panel_apply_norms_ref(qp, w, z)
            assert all(_rel(g, v) <= REL_TOL[dtype] for g, v in zip(got, want))
            assert torch.equal(got[0], panel_apply(qp, w, z))
        else:
            assert _rel(got, panel_apply_ref(qp, w, z)) <= REL_TOL[dtype]


# (l, b, n): the distributed main shape (64-vector slabs in f64/c64/c128,
# 32 in f32), a 4-rank shard (16), l off the 32-row chunk, n off every slab
# width, b not a multiple of a 16-byte vector, b = 1 and the widest panel.
APPLY_SHAPES = [(800, 32, 2 ** 14), (800, 32, 4096), (800, 64, 2 ** 14 + 3),
                (131, 17, 1037), (77, 1, 4099), (800, 64, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l,b,n", APPLY_SHAPES)
def test_cuda_panel_apply_shapes_norms_and_repeat_bits(dtype, l, b, n):
    """Each slab width the shape selects, ragged l, n and b: O and
    colnorms^2(O) within tolerance of the plain versions, O the same with
    and without emit_norms, and a repeated call bit for bit."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(2000 + l + b)
    qp = _orthonormal(gen, l, b, dtype, dev)
    w, z = _randn(gen, (b, n), dtype, dev), _randn(gen, (l, n), dtype, dev)
    o, r2 = panel_apply(qp, w, z, emit_norms=True)
    assert _rel(o, panel_apply_ref(qp, w, z)) <= REL_TOL[dtype]
    want_o, want_r2 = panel_apply_norms_ref(qp, w, z)
    assert _rel(r2, want_r2) <= REL_TOL[dtype] and r2.dtype == want_r2.dtype
    o2, r22 = panel_apply(qp, w, z, emit_norms=True)
    assert torch.equal(o, panel_apply(qp, w, z))
    assert torch.equal(o, o2) and torch.equal(r2, r22)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_panel_apply_unaligned_operands_give_the_aligned_bits(dtype):
    """z, w and o on bases off 16 bytes (or rows of odd length) take the
    element-copy twin, with the bits of the 16-byte kernel."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(21)
    l, b, n = 200, 32, 1024
    qp = _orthonormal(gen, l, b, dtype, dev)
    w, z = _randn(gen, (b, n), dtype, dev), _randn(gen, (l, n), dtype, dev)
    o, r2 = panel_apply(qp, w, z, emit_norms=True)

    def off(t):  # the same values on a base one element further on
        u = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:]
        return u.view(t.shape).copy_(t)

    if dtype != torch.complex128:  # a c128 element is itself 16 bytes
        assert off(z).data_ptr() % 16 != 0
    o2, r22 = panel_apply(qp, off(w), off(z), emit_norms=True)
    assert torch.equal(o, o2) and torch.equal(r2, r22)


@pytest.mark.cuda
def test_cuda_panel_apply_and_tsolve_declared_launches_equal_the_c_side():
    """apply_launch (slabs of 64, 32 and 16 vectors, 16-byte and element
    copies) and tsolve_launch (resident and re-reading) equal what the C
    side launches: grid, block and dynamic shared bytes."""
    from repro_torch.analysis.kernels import hold_launch
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import SMEM_BUDGET_BYTES
    from repro_torch.kernels.panel_step.kernel import apply_launch
    from repro_torch.kernels.tsolve.kernel import tsolve_launch
    _device()
    lib = _build.load_library()
    launches = [apply_launch(dtype, l, b, n) for dtype in DTYPES
                for l, b, n in APPLY_SHAPES + [(800, 17, 2 ** 14), (800, 32, 4095),
                                               (800, 32, 12288)]]
    launches += [tsolve_launch(dtype, k, n) for dtype in DTYPES
                 for k, n in ((1, 5), (400, 2 ** 14), (352, 300), (416, 300),
                              (1000, 70))]
    kernels = set()
    for ln in launches:
        row = hold_launch(ln, lib, SMEM_BUDGET_BYTES)
        assert row["equal"] and row["status"] == 0, row
        assert row["c_smem"] + row["static_smem"] <= SMEM_BUDGET_BYTES, row
        assert row["spills"] == 0, row
        kernels.add(ln.kernel)
    # panel_apply<T, slab columns, 16-byte copies>: the three widths (f64
    # 32, 64 and 128 columns) and both copy widths; tsolve<T, resident>:
    # both.
    apply = [k for k in kernels if k.startswith("panel_apply_kernel<")]
    solve = [k for k in kernels if k.startswith("tsolve_kernel<")]
    assert {"panel_apply_kernel<float64,32,true>",
            "panel_apply_kernel<float64,64,true>",
            "panel_apply_kernel<float64,128,true>",
            "panel_apply_kernel<float64,128,false>"} <= set(apply)
    assert {k.rsplit(",", 1)[1] for k in solve} == {"true>", "false>"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [32, 16, 7, 64])
def test_cuda_panel_gram_matches_plain(dtype, b):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(6)
    l, n = 200, 301
    c, z = _randn(gen, (l, b), dtype, dev), _randn(gen, (l, n), dtype, dev)
    before = GRAM_LAUNCHES.count
    got = panel_gram(c, z)
    assert GRAM_LAUNCHES.count == before + 1
    for g, w in zip(got, panel_gram_ref(c, z)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _rel(g, w) <= REL_TOL[dtype]
    g0, v0 = panel_gram(c, z[:, :0])            # n = 0: the Gram alone
    assert v0.shape == (b, 0) and torch.equal(g0, got[0])


def _bits(t):
    """A real tensor's bits as integers (NaN compares equal to itself)."""
    return t.view({8: torch.int64, 4: torch.int32}[t.element_size()])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l,b,n", [(800, 32, 4096), (777, 1, 1001),
                                   (777, 17, 1001), (777, 33, 1001),
                                   (777, 64, 1001), (4000, 32, 333)])
def test_cuda_panel_coeff_keeps_the_parent_arithmetic(dtype, l, b, n):
    """panel_coeff's sweep (panel_gram's W pass, the downdate in its
    epilogue) bit-equal to the arithmetic of the sweep it replaced: W one
    in-order sum over l (panel_gram's V of Q_p), and colnorms^2(W) as 8
    partials over the rows = g (mod 8) added in g order (panel_apply's
    norms of O = W with Q_p = 0), subtracted from r2 and clamped at 0 with
    NaN kept."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(22)
    c, z = _randn(gen, (l, b), dtype, dev), _randn(gen, (l, n), dtype, dev)
    r2in = _norms2(z)
    r2in[::7] = -1.0
    r2in[3::101] = float("nan")
    qp, w, r2 = panel_coeff(c, z, r2in)
    assert torch.equal(w, panel_gram(qp, z)[1])
    t = panel_apply(torch.zeros((b, 1), dtype=dtype, device=dev),
                    torch.zeros((1, n), dtype=dtype, device=dev), w,
                    emit_norms=True)[1]
    d = r2in - t
    assert torch.equal(_bits(r2), _bits(torch.where(d < 0, torch.zeros_like(d), d)))
    assert bool(r2[3::101].isnan().all())
    again = panel_coeff(c, z, r2in)
    assert torch.equal(again[1], w) and torch.equal(_bits(again[2]), _bits(r2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_panel_coeff_duplicate_columns_finite(dtype):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(7)
    c8 = _randn(gen, (64, 8), dtype, dev)
    z = _randn(gen, (64, 100), dtype, dev)
    qp, w, r2 = panel_coeff(torch.cat([c8, c8], 1), z, _norms2(z))
    assert all(bool(torch.isfinite(t).all()) for t in (qp, w, r2))
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_sketch_matmul_matches_plain(dtype):
    """One launch per call, complex included; ragged l, m and n."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(12)
    for l, m, n in [(8, 64, 32), (70, 777, 150), (130, 1037, 257), (3, 0, 5)]:
        omega, a = _randn(gen, (l, m), dtype, dev), _randn(gen, (m, n), dtype, dev)
        before = MATMUL_LAUNCHES.count
        got = sketch_matmul(omega, a)
        assert MATMUL_LAUNCHES.count == before + 1
        want = sketch_matmul_ref(omega, a)
        if m == 0:
            assert torch.equal(got, want)
        else:
            assert _rel(got, want) <= REL_TOL[dtype]


@pytest.mark.cuda
def test_cuda_sketch_matmul_f64_unaligned_operands_give_the_aligned_bits():
    """f64 on the DMMA tile: a[1:] of an (m + 1, 129) tensor (odd pitch,
    base 8 bytes off 16) within tolerance and deterministic; an even-pitch
    a, and omega, each 8 bytes off 16-byte alignment (the <false> twin's
    8-byte copies) give the bits of the aligned operands."""
    dev = _device()
    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(15)
    l, m = 100, 778
    omega = _randn(gen, (l, m), f64, dev)
    a_odd = _randn(gen, (m + 1, 129), f64, dev)[1:]
    assert a_odd.data_ptr() % 16 == 8 and a_odd.is_contiguous()
    got = sketch_matmul(omega, a_odd)
    assert torch.equal(got, sketch_matmul(omega, a_odd.clone()))
    assert _rel(got, sketch_matmul_ref(omega, a_odd)) <= REL_TOL[f64]
    a = _randn(gen, (m, 256), f64, dev)
    want = sketch_matmul(omega, a)
    om_off = torch.empty(l * m + 1, dtype=f64, device=dev)[1:].view(l, m)
    a_off = torch.empty(m * 256 + 1, dtype=f64, device=dev)[1:].view(m, 256)
    om_off.copy_(omega)
    a_off.copy_(a)
    assert om_off.data_ptr() % 16 == 8 and a_off.data_ptr() % 16 == 8
    for om, x in ((om_off, a), (omega, a_off), (om_off, a_off)):
        assert torch.equal(sketch_matmul(om, x), want)


@pytest.mark.cuda
def test_cuda_sketch_matmul_f64_at_the_paper_l_is_deterministic():
    """l = 800 (a ragged 7th row block of 32 rows), ragged m and n: one
    launch a call, within tolerance of the plain version, and two calls
    give the same bits (one in-order sum, no split-K, no atomics)."""
    dev = _device()
    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(16)
    l, m, n = 800, 4100, 1000
    omega, a = _randn(gen, (l, m), f64, dev), _randn(gen, (m, n), f64, dev)
    before = MATMUL_LAUNCHES.count
    got = sketch_matmul(omega, a)
    again = sketch_matmul(omega, a)
    assert MATMUL_LAUNCHES.count == before + 2
    assert torch.equal(got, again)
    assert _rel(got, sketch_matmul_ref(omega, a)) <= REL_TOL[f64]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_sketch_matmul_refuses_more_than_65535_column_slabs(dtype):
    """The grid puts column slabs on blockIdx.y: n = 65535 BN + 1 is
    refused as a status (raised, nothing launched), n = 65535 BN runs."""
    from repro_torch.kernels.common import product_tile
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(17)
    bn = product_tile(dtype)[1]
    omega = _randn(gen, (1, 2), dtype, dev)
    a = _randn(gen, (2, 65535 * bn + 1), dtype, dev)
    before = MATMUL_LAUNCHES.count
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        sketch_matmul(omega, a)
    assert MATMUL_LAUNCHES.count == before
    a = a[:, :65535 * bn].contiguous()
    assert _rel(sketch_matmul(omega, a), sketch_matmul_ref(omega, a)) <= REL_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 7, 32, 64])
def test_cuda_panel_gram_identities(dtype, b):
    """n smaller than one slab and n over several (l = 200: a ragged last
    chunk of 8 rows): G and V within tolerance of the plain version; V of
    z[:, :h] is the first h columns of V, and G the n = 0 call's G, bit for
    bit; a c or z 4 or 8 bytes off 16-byte alignment (the <T, false> twin)
    gives the same bits."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(18)
    l = 200
    c = _randn(gen, (l, b), dtype, dev)
    g0, v0 = panel_gram(c, torch.empty((l, 0), dtype=dtype, device=dev))
    assert v0.shape == (b, 0)
    assert _rel(g0, panel_gram_ref(c, c[:, :0])[0]) <= REL_TOL[dtype]
    for n, cuts in ((37, (0, 1, 13)), (301, (1, 64, 128, 129, 200))):
        z = _randn(gen, (l, n), dtype, dev)
        g, v = panel_gram(c, z)
        wg, wv = panel_gram_ref(c, z)
        assert _rel(g, wg) <= REL_TOL[dtype] and _rel(v, wv) <= REL_TOL[dtype]
        assert torch.equal(g, g0)
        for h in cuts:
            gh, vh = panel_gram(c, z[:, :h])
            assert torch.equal(gh, g0) and torch.equal(vh, v[:, :h]), h
        item = c.element_size()
        if item < 16:
            c_off = torch.empty(l * b + 1, dtype=dtype, device=dev)[1:].view(l, b)
            z_off = torch.empty(l * n + 1, dtype=dtype, device=dev)[1:].view(l, n)
            c_off.copy_(c)
            z_off.copy_(z)
            assert c_off.data_ptr() % 16 == item % 16
            for cc, zz in ((c_off, z), (c, z_off)):
                gu, vu = panel_gram(cc, zz)
                assert torch.equal(gu, g) and torch.equal(vu, v)


@pytest.mark.cuda
def test_cuda_sketch_matmul_and_panel_gram_instructions_without_spills():
    """DMMA in both f64 kernels of sketch_matmul, no tensor-core
    instruction in its f32 kernel (no TF32) nor in any panel_gram kernel
    (its sums are in-order FMA chains), no spills in any of them
    (cuobjdump -sass, ptxas -v)."""
    from repro_torch.kernels import _build
    _device()
    _build.load_library()
    ops = _build.tensor_core_ops(_build.build_info["path"])
    ptxas = {r["kernel"]: r for r in _build.build_info["ptxas"]}
    for flag in ("true", "false"):
        assert ops[f"sketch_matmul_dmma_kernel<{flag}>"] == ["DMMA"]
    assert ops["sketch_matmul_kernel<float32>"] == []
    # <T, copy width, columns a lane>: 1, 2, 4 for three types, 1, 2 for c128
    gram = [k for k in ops if k.startswith("panel_gram_kernel<")]
    assert len(gram) == 2 * (3 * 3 + 2) and all(ops[k] == [] for k in gram)
    for kernel, rec in ptxas.items():
        if kernel.startswith(("sketch_matmul", "panel_gram")):
            assert not rec.get("spill_stores") and not rec.get("spill_loads"), rec


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 2, 64, 256, 512, 8192, 2 ** 16, 2 ** 18])
def test_cuda_fwht_matches_plain(dtype, m):
    """One launch per Kronecker factor (two at m = 2^18); bit-equal to
    the plain version in the real dtypes (exact butterflies in the same
    order, one scale)."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(13)
    x = _randn(gen, (m, 40 if m < 2 ** 16 else 3), dtype, dev)
    before = FWHT_LAUNCHES.count
    got = fwht(x)
    assert FWHT_LAUNCHES.count == before + len(fwht_factors(m))
    want = fwht_ref(x)
    if dtype.is_complex:
        assert _rel(got, want) <= REL_TOL[dtype]
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_srht_sketch_launches_fwht(dtype):
    """``core.srht_sketch`` on the card runs the fwht kernel (once a
    factor) and gives the plain version's bits; ``core.fwht`` too."""
    from repro_torch.core import fwht as core_fwht
    from repro_torch.core import srht_sketch
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(15)
    m, n, l = 3000, 64, 48
    a = _randn(gen, (m, n), dtype, dev)
    signs = torch.randint(0, 2, (m,), generator=gen, device=dev) * 2 - 1
    rows = torch.randint(0, 4096, (l,), generator=gen, device=dev)
    before = FWHT_LAUNCHES.count
    got = srht_sketch(0, a, l, signs=signs, rows=rows)
    assert FWHT_LAUNCHES.count == before + len(fwht_factors(4096))
    assert torch.equal(got, srht_ref(signs, a, rows))
    x = _randn(gen, (1024, 33), dtype, dev)
    before = FWHT_LAUNCHES.count
    assert torch.equal(core_fwht(x), fwht_ref(x))
    assert FWHT_LAUNCHES.count == before + len(fwht_factors(1024))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_srht_matches_plain(dtype):
    """A non-power-of-two m: signs, zero pad, the kernel's transform, row
    gather and scale give the plain version's bits."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(14)
    m, n, l = 700, 96, 32
    a = _randn(gen, (m, n), dtype, dev)
    signs = (torch.randint(0, 2, (m,), generator=gen, device=dev) * 2 - 1).to(dtype)
    rows = torch.randint(0, 1024, (l,), generator=gen, device=dev)
    before = FWHT_LAUNCHES.count
    got = srht(signs, a, rows)
    assert FWHT_LAUNCHES.count == before + len(fwht_factors(1024))
    assert torch.equal(got, srht_ref(signs, a, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n", [(1, 5), (31, 40), (33, 257), (150, 100), (400, 300),
                                 (1000, 70), (400, 2 ** 14 + 5), (416, 129)])
def test_cuda_tsolve_matches_plain(dtype, k, n):
    """A well-conditioned R1 (the R of a QR, junk below the diagonal,
    which must not be read): one launch, agreement with the plain
    version relative to the largest entry of T."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(15)
    r = torch.linalg.qr(_randn(gen, (k + 20, k), dtype, dev)).R
    r1 = r + torch.tril(_randn(gen, (k, k), dtype, dev), -1)
    r2 = _randn(gen, (k, n), dtype, dev)
    before = TSOLVE_LAUNCHES.count
    got = tsolve(r1, r2)
    assert TSOLVE_LAUNCHES.count == before + 1
    assert _rel(got, tsolve_ref(r1, r2)) <= REL_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n", [(33, 70), (400, 1000), (1000, 129)])
def test_cuda_tsolve_never_reads_below_the_diagonal(dtype, k, n):
    """NaN below R1's diagonal gives the bits of zeros there (the kernel
    never reads the strict lower triangle), in the resident and the
    re-reading geometry; a repeated call gives the same bits."""
    from repro_torch.kernels.tsolve.kernel import tsolve_geometry
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(17)
    r = torch.linalg.qr(_randn(gen, (k + 20, k), dtype, dev)).R
    r2 = _randn(gen, (k, n), dtype, dev)
    nan = torch.full((k, k), float("nan"), dtype=dtype, device=dev)
    got = tsolve(r + torch.tril(nan, -1), r2)
    want = tsolve(torch.triu(r), r2)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want) and torch.equal(got, tsolve(torch.triu(r), r2))
    assert _rel(got, tsolve_ref(r, r2)) <= REL_TOL[dtype]
    resident = tsolve_geometry(dtype, k)[1]
    assert resident == (k <= (352 if dtype == torch.complex128 else 400))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_tsolve_backward_error_on_bench_system(dtype):
    """The bench's R1 = triu(randn) + 3 I is exponentially ill-conditioned
    in k, so the kernel is held to a normwise backward error of 4 k eps."""
    from repro_torch.benchmarks.bench_tsolve import backward_error, bench_system
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(16)
    k = 200
    r1, r2 = bench_system(gen, k, 300, dtype, dev)
    eps = torch.finfo(dtype.to_real() if dtype.is_complex else dtype).eps
    assert backward_error(r1, r2, tsolve(r1, r2)) <= 4 * k * eps


@pytest.mark.cuda
def test_cuda_bench_modules_run_one_small_row():
    from repro_torch.benchmarks import bench_sketch, bench_total, bench_tsolve
    from repro_torch.configs import SMALL_GRID
    _device()
    rows = (bench_sketch.run(SMALL_GRID[:1], torch.float32)
            + bench_tsolve.run(SMALL_GRID[:1], torch.float32)
            + bench_total.run(SMALL_GRID[:1], "srft", torch.complex64))
    for row in rows:
        assert row["device"] == "cuda"
        assert all(math.isfinite(v) for v in row.values() if isinstance(v, float))


def _orthonormal(gen, l, k, dtype, dev):
    return torch.linalg.qr(_randn(gen, (l, k), dtype, dev)).Q.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l,k,n", [(8, 1, 5), (70, 33, 150), (130, 64, 257),
                                   (333, 150, 129), (800, 400, 300),
                                   (2000, 1000, 700)])
def test_cuda_project_out_matches_plain(dtype, l, k, n):
    """One launch per call, ragged l, k and n (Z is never padded), k up to
    1000 and l up to 2000 (the paper's largest basis): agreement with the
    plain version relative to its largest entry, and the same bits from a
    second call (fixed summation order)."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(17)
    q, z = _orthonormal(gen, l, k, dtype, dev), _randn(gen, (l, n), dtype, dev)
    before = PROJECT_LAUNCHES.count
    got = project_out(q, z)
    assert PROJECT_LAUNCHES.count == before + 1
    assert _rel(got, project_out_ref(q, z)) <= REL_TOL[dtype]
    assert torch.equal(project_out(q, z), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l,k,n", [(5, 1, 3), (100, 60, 130), (300, 100, 257),
                                   (2000, 1000, 300)])
def test_cuda_project_out_two_launches_at_the_tile_edges(dtype, l, k, n):
    """k = 1, l and k under one 128-row tile, k under it, and the paper's
    largest basis (k = 1000, l = 2000): one counted call, its two launches
    within the tolerance of the plain version, the same bits again."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(18)
    q, z = _orthonormal(gen, l, k, dtype, dev), _randn(gen, (l, n), dtype, dev)
    before = PROJECT_LAUNCHES.count
    got = project_out(q, z)
    assert PROJECT_LAUNCHES.count == before + 1
    assert _rel(got, project_out_ref(q, z)) <= REL_TOL[dtype]
    assert torch.equal(project_out(q, z), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [16, 32, 64])
def test_cuda_panel_deflate_matches_plain(dtype, b):
    """Both outputs, ``Z - Q_p W`` and ``W``, against the plain version;
    one launch per call, counted apart from panel_step's."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(18)
    for l, n in [(70, 150), (800, 1037)]:
        q, z = _orthonormal(gen, l, b, dtype, dev), _randn(gen, (l, n), dtype, dev)
        before = (DEFLATE_LAUNCHES.count, PANEL_LAUNCHES.count)
        o, w = panel_deflate(q, z)
        assert (DEFLATE_LAUNCHES.count, PANEL_LAUNCHES.count) == \
            (before[0] + 1, before[1])
        want_o, want_w = panel_deflate_ref(q, z)
        assert _rel(o, want_o) <= REL_TOL[dtype]
        assert _rel(w, want_w) <= REL_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l", [800, 256, 77])
@pytest.mark.parametrize("b", [1, 3, 16, 32, 64])
def test_cuda_panel_deflate_own_kernel_matches_plain_and_repeats(dtype, l, b):
    """panel_deflate's own kernel (the slab resident where it fits) against
    the plain version at a ragged n, both outputs; a repeated call gives
    the same bits; the sweep of panel_step is not launched."""
    from repro_torch.kernels.cgs.kernel import deflate_geometry
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(19 * l + b)
    n = 301
    q, z = _orthonormal(gen, l, b, dtype, dev), _randn(gen, (l, n), dtype, dev)
    before = (DEFLATE_LAUNCHES.count, PANEL_LAUNCHES.count)
    o, w = panel_deflate(q, z)
    o2, w2 = panel_deflate(q, z)
    assert (DEFLATE_LAUNCHES.count, PANEL_LAUNCHES.count) == \
        (before[0] + 2, before[1])
    want_o, want_w = panel_deflate_ref(q, z)
    assert _rel(o, want_o) <= REL_TOL[dtype] and _rel(w, want_w) <= REL_TOL[dtype]
    assert torch.equal(o, o2) and torch.equal(w, w2)
    # c128 re-reads a 32-row-padded slab of 800 rows with W and its ring.
    resident = deflate_geometry(dtype, l, b)[1]
    assert resident or (dtype == torch.complex128 and l == 800)


# (dtype, l, geometry the shape selects at b = 32): a 32-column slab
# resident, a 16-column slab resident (32 would not fit), re-reading (no
# slab fits); c128 has 16 columns only.
DEFLATE_GEOMETRY_CASES = [
    (torch.float32, 800, (32, True)), (torch.float32, 2400, (16, True)),
    (torch.float32, 4000, (32, False)),
    (torch.float64, 800, (32, True)), (torch.float64, 1200, (16, True)),
    (torch.float64, 4000, (32, False)),
    (torch.complex64, 800, (32, True)), (torch.complex64, 1200, (16, True)),
    (torch.complex64, 4000, (32, False)),
    (torch.complex128, 256, (16, True)), (torch.complex128, 4000, (16, False)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,l,geometry", DEFLATE_GEOMETRY_CASES)
def test_cuda_panel_deflate_rereading_geometry_and_both_widths(dtype, l,
                                                               geometry):
    """Each geometry the shape selects (both slab widths resident, and the
    re-reading one, where pass 2 reads Z again) gives results within
    tolerance and the same bits when repeated."""
    from repro_torch.kernels.cgs.kernel import (deflate_geometry,
                                                panel_deflate_kernel)
    dev = _device()
    assert deflate_geometry(dtype, l, 32) == geometry
    gen = torch.Generator(device=dev).manual_seed(1900 + l)
    q = _orthonormal(gen, l, 32, dtype, dev)
    z = _randn(gen, (l, 257), dtype, dev)
    o, w = panel_deflate_kernel(q, z)
    want_o, want_w = panel_deflate_ref(q, z)
    assert _rel(o, want_o) <= REL_TOL[dtype]
    assert _rel(w, want_w) <= REL_TOL[dtype]
    o2, w2 = panel_deflate_kernel(q, z)
    assert torch.equal(o, o2) and torch.equal(w, w2)


@pytest.mark.cuda
def test_cuda_panel_deflate_declared_launches_equal_the_c_side():
    """panel_deflate_launch's grid, block and shared bytes, with the slab
    resident at either width and re-reading, equal what the C side
    launches."""
    from repro_torch.analysis.kernels import hold_launch
    from repro_torch.kernels import _build
    from repro_torch.kernels.cgs.kernel import panel_deflate_launch
    from repro_torch.kernels.common import SMEM_BUDGET_BYTES
    _device()
    lib = _build.load_library()
    for dtype in DTYPES:
        for l, b, n in ((800, 32, 2 ** 14), (800, 64, 1000), (77, 3, 301),
                        (1200, 32, 1037), (2400, 32, 1037), (4000, 32, 257)):
            row = hold_launch(panel_deflate_launch(dtype, l, b, n), lib,
                              SMEM_BUDGET_BYTES)
            assert row["equal"] and row["status"] == 0, row


@pytest.mark.cuda
def test_cuda_panel_deflate_and_flash_instructions_without_spills():
    """DMMA in every f64 panel_deflate kernel and no tensor-core instruction
    in its other types' (f32 stays FFMA), the TF32 HMMA in every flash
    kernel, no spills in any of them (cuobjdump -sass, ptxas -v)."""
    from repro_torch.kernels import _build
    _device()
    _build.load_library()
    ops = _build.tensor_core_ops(_build.build_info["path"])
    ptxas = {r["kernel"]: r for r in _build.build_info["ptxas"]}
    deflate = [k for k in ops if k.startswith("panel_deflate_kernel<")]
    flash = [k for k in ops if k.startswith("flash_fwd_kernel<")]
    # <T, width, resident, 16-byte copies>: widths 16 and 32, c128 16 only
    assert len(deflate) == 4 * (3 * 2 + 1) and len(flash) == 4 * 3
    for k in deflate:
        assert ops[k] == (["DMMA"] if "float64" in k else []), (k, ops[k])
    assert all(ops[k] == ["HMMA"] for k in flash), {k: ops[k] for k in flash}
    for k in deflate + flash:
        rec = ptxas[k]
        assert not rec.get("spill_stores") and not rec.get("spill_loads"), rec


@pytest.mark.cuda
def test_cuda_cgs_kernels_refuse_other_dtypes_and_wide_panels():
    dev = _device()
    h = torch.ones(8, 2, dtype=torch.float16, device=dev)
    with pytest.raises(TypeError):
        project_out(h, torch.ones(8, 4, dtype=torch.float16, device=dev))
    with pytest.raises(ValueError, match="b <= 64, got b=65"):
        panel_deflate(torch.ones(80, 65, device=dev), torch.ones(80, 3, device=dev))


@pytest.mark.cuda
def test_cuda_bench_qr_and_error_run_one_small_row():
    """Table 3 at SMALL_GRID[0]: one project_out and one panel_deflate
    launch per call of their columns (2 warm-up + 5 timed); Table 5 at
    SMALL_GRID[0] within the eq. (3) bound."""
    from repro_torch.benchmarks import bench_error, bench_qr
    from repro_torch.benchmarks.common import ITERS, WARMUP
    from repro_torch.configs import SMALL_GRID
    _device()
    before = (PROJECT_LAUNCHES.count, DEFLATE_LAUNCHES.count)
    rows = bench_qr.run(SMALL_GRID[:1], torch.float32)
    assert (PROJECT_LAUNCHES.count - before[0],
            DEFLATE_LAUNCHES.count - before[1]) == (WARMUP + ITERS,) * 2
    rows += bench_error.run(SMALL_GRID[:1])
    assert rows[1]["within_bound"]
    for row in rows:
        assert row["device"] == "cuda"
        assert all(math.isfinite(v) for v in row.values() if isinstance(v, float))


# A one-rank process group runs in a subprocess (tests/torch_ranks.py), so
# that this process never joins one.  argv: rank, world, work dir, backend.
ONE_RANK_PROGRAM = r"""
import datetime, math, sys
import torch
import torch.distributed as dist
work, backend = sys.argv[3], sys.argv[4]
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group(backend, init_method="file://" + work + "/store",
                        rank=0, world_size=1,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.core import (error_bound, expected_sigma_kp1,
                              panel_parallel_pivoted_qr, rid_distributed,
                              sketch, spectral_error)
from repro_torch.kernels.panel_gram.kernel import LAUNCHES as GRAM
from repro_torch.kernels.panel_step.kernel import (APPLY_LAUNCHES,
                                                   APPLY_NORMS_LAUNCHES,
                                                   COEFF_LAUNCHES, LAUNCHES)
g = dist.group.WORLD
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(8)
m, n, k, b = 1024, 768, 40, 16
A = (torch.randn((m, k), generator=gen, dtype=torch.float64, device=dev)
     @ torch.randn((k, n), generator=gen, dtype=torch.float64, device=dev))
if backend == "gloo":
    try:
        rid_distributed(0, A, k, group=g, qr_impl="panel_parallel")
    except ValueError as e:
        print("RAISED", e)
else:
    for c in (COEFF_LAUNCHES, APPLY_LAUNCHES, APPLY_NORMS_LAUNCHES, LAUNCHES, GRAM):
        c.reset()
    dec = rid_distributed(9, A, k, group=g, qr_impl="panel_parallel",
                          qr_panel=b, qr_norm_recompute=2)
    panels = math.ceil(k / b)
    assert COEFF_LAUNCHES.count == panels and APPLY_LAUNCHES.count == panels
    assert APPLY_NORMS_LAUNCHES.count == 1 and LAUNCHES.count == 0
    assert int(torch.unique(dec.J).numel()) == k
    assert torch.equal(dec.P[:, dec.J], torch.eye(k, dtype=dec.P.dtype, device=dev))
    err = float(spectral_error(10, A, dec.B, dec.P))
    assert err <= error_bound(m, n, k) * expected_sigma_kp1(m, n), err
    Y = sketch(9, A, 2 * k, kind="gaussian").Y
    qr = panel_parallel_pivoted_qr(Y, k, group=g, panel=b, panel_impl="gram")
    assert GRAM.count == panels
    orth = float((qr.Q.mH @ qr.Q - torch.eye(k, dtype=Y.dtype, device=dev)).abs().max())
    assert orth < 1e-10, orth
    print("OK")
dist.destroy_process_group()
"""


def _one_rank(backend: str, tmp_path) -> str:
    """The one rank's standard output, after it exited cleanly."""
    _device()
    results = run_ranks(ONE_RANK_PROGRAM, 1, str(tmp_path), backend,
                        timeout=300)
    assert not failures(results), failures(results)
    return results[0][1]


@pytest.mark.cuda
def test_cuda_gloo_group_refuses_cuda_tensors(tmp_path):
    """gloo would stage CUDA tensors through host memory: refused."""
    assert "RAISED tensors on cuda:0 need a nccl process group" in \
        _one_rank("gloo", tmp_path)


@pytest.mark.cuda
def test_cuda_rid_distributed_one_rank_nccl(tmp_path):
    """The distributed path on a one-rank NCCL group: panel_coeff and
    panel_apply once per panel (one recompute panel with emit_norms),
    no panel_step, eq. (3); the gram path launches panel_gram per panel."""
    assert "OK" in _one_rank("nccl", tmp_path)


# One rank per card; argv: rank, world, work dir (holds the inputs).
MULTI_RANK_PROGRAM = r"""
import datetime, sys
import torch
import torch.distributed as dist
rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(rank)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("nccl", init_method="file://" + work + "/store",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.core import (panel_parallel_pivoted_qr, rid_distributed,
                              shard_columns)
g = dist.group.WORLD
dev = torch.device("cuda", rank)
inputs = torch.load(work + "/inputs.pt")
out = {}
for name, A in inputs.items():
    A_loc = shard_columns(A.to(dev), g)
    for impl in ("panel_parallel", "blocked"):
        dec = rid_distributed(9, A_loc, 40, group=g, qr_impl=impl,
                              qr_panel=16, qr_norm_recompute=2)
        out[name, impl] = {f: getattr(dec, f).cpu() for f in "JQPB"}
    Y_loc = shard_columns(A[:80].to(dev), g)
    qr = panel_parallel_pivoted_qr(Y_loc, 40, group=g, panel=16,
                                   panel_impl="gram")
    out[name, "gram"] = {"J": qr.piv.cpu(), "Q": qr.Q.cpu()}
torch.save(out, work + f"/rank{rank}.pt")
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_cuda_rid_distributed_across_cards(tmp_path):
    """``rid_distributed`` with one NCCL rank per card (all the cards
    there are, at least two): J and Q bitwise identical on every rank, the
    pivot set and P of the single-card ``rid``, eq. (3) with the exact
    sigma_{k+1}; the gram oracle likewise identical on every rank."""
    _device()
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more CUDA devices")
    from repro_torch.kernels._build import load_library
    load_library()                              # build once, not per rank
    gen = torch.Generator().manual_seed(11)
    m, n, r, k = 1024, 256 * world, 60, 40
    scale = torch.logspace(0, 2, n, dtype=torch.float64)[torch.randperm(n, generator=gen)]
    real = (torch.randn((m, r), generator=gen, dtype=torch.float64)
            @ (torch.randn((r, n), generator=gen, dtype=torch.float64) * scale))
    cplx = torch.complex(real, torch.randn((m, r), generator=gen, dtype=torch.float64)
                         @ torch.randn((r, n), generator=gen, dtype=torch.float64))
    inputs = {"float64": real, "complex128": cplx}
    torch.save(inputs, tmp_path / "inputs.pt")
    errors = failures(run_ranks(MULTI_RANK_PROGRAM, world, str(tmp_path),
                                timeout=300))
    assert not errors, errors
    outs = [torch.load(tmp_path / f"rank{rank}.pt") for rank in range(world)]
    dev = torch.device("cuda", 0)
    for key, first in outs[0].items():
        for other in outs[1:]:
            assert torch.equal(other[key]["J"], first["J"]), key
            assert torch.equal(other[key]["Q"], first["Q"]), key
    for name, A in inputs.items():
        want = rid(9, A.to(dev), k, sketch_kind="gaussian", qr_impl="blocked",
                   qr_panel=16)
        wJ, wP = want.J.cpu(), want.P.cpu()
        sigma = torch.linalg.svdvals(A)[k]
        for impl in ("panel_parallel", "blocked"):
            got = outs[0][name, impl]
            P = torch.cat([o[name, impl]["P"] for o in outs], dim=1)
            assert set(got["J"].tolist()) == set(wJ.tolist()), (name, impl)
            assert torch.equal(got["B"], A[:, got["J"]])
            go, wo = torch.argsort(got["J"]), torch.argsort(wJ)
            assert float((P[go] - wP[wo]).abs().max()) <= 1e-8 * float(wP.abs().max())
            err = torch.linalg.matrix_norm(A - got["B"] @ P, ord=2)
            assert float(err) <= error_bound(m, n, k) * float(sigma), (name, impl)
        Q = outs[0][name, "gram"]["Q"]
        assert float((Q.mH @ Q - torch.eye(k, dtype=Q.dtype)).abs().max()) < 1e-10


# ------------------------------------------------- flash attention (slice 5)

FLASH_CASES = [  # (BH, S, T, hd, causal, window)
    (4, 300, 300, 64, True, None),
    (3, 257, 700, 80, True, None),        # ragged, T > S
    (3, 400, 400, 80, True, 96),          # window skips blocks at both ends
    (2, 130, 90, 128, False, None),       # non-causal, S != T
    (2, 200, 200, 128, True, 64),
    (2, 100, 100, 8, True, None),         # the reference test's smallest hd
    (2, 300, 40, 64, True, None),         # T < 64: one ragged kv block
    (2, 200, 200, 256, True, None),       # the widest head: 32-row kv blocks
    (2, 150, 130, 256, False, 48),        # non-causal window, S != T
]
FLASH_DTYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", FLASH_DTYPES)
@pytest.mark.parametrize("bh,s,t,hd,causal,window", FLASH_CASES)
def test_cuda_flash_matches_plain(bh, s, t, hd, causal, window, qdt, kvdt):
    """The kernel against ``ref.py`` on the same inputs.  Tolerance: 1e-5 of
    the largest output entry in f32 q (f32 sums in another order), 1e-2 in
    bf16 q (one rounding of the output to bf16)."""
    from repro_torch.kernels.flash.kernel import LAUNCHES, flash_attention_kernel
    from repro_torch.kernels.flash.ref import flash_ref
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(bh * s + hd)
    q = (torch.randn((bh, s, hd), generator=gen, device=dev) * hd ** -0.5).to(qdt)
    k = torch.randn((bh, t, hd), generator=gen, device=dev).to(kvdt)
    v = torch.randn((bh, t, hd), generator=gen, device=dev).to(kvdt)
    before = LAUNCHES.count
    got = flash_attention_kernel(q, k, v, causal=causal, window=window)
    assert LAUNCHES.count == before + 1 and got.dtype == qdt
    want = flash_ref(q, k, v, causal=causal, window=window)
    tol = 1e-5 if qdt == torch.float32 else 1e-2
    assert _rel(got.float(), want.float()) <= tol


@pytest.mark.cuda
def test_cuda_flash_ops_never_reach_the_plain_version(monkeypatch):
    """Through ``ops`` a CUDA tensor goes to the kernel or raises."""
    from repro_torch.kernels.flash import ops
    from repro_torch.kernels.flash.kernel import LAUNCHES
    dev = _device()

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached ref.py")

    monkeypatch.setattr(ops, "flash_ref", refuse)
    q = torch.randn((1, 70, 4, 80), device=dev)
    kv = torch.randn((1, 70, 4, 80), device=dev, dtype=torch.bfloat16)
    before = LAUNCHES.count
    out = ops.flash_attention(q, kv, kv, causal=True, window=32)
    assert LAUNCHES.count == before + 1 and out.shape == (1, 70, 320)
    with pytest.raises(TypeError, match="dtypes"):
        ops.flash_attention(q.half(), kv, kv)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_attention(q[..., :20], kv[..., :20], kv[..., :20])


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", FLASH_DTYPES)
@pytest.mark.parametrize("bh,s,t,hd,causal,window", FLASH_CASES[:5])
def test_cuda_flash_lse_matches_plain_and_keeps_o(bh, s, t, hd, causal,
                                                  window, qdt, kvdt):
    """With ``return_lse`` the kernel's o keeps its bits, and its lse is
    ``flash_ref``'s to 1e-5 of the largest entry (f32 in both; the
    kernel's online max and sum against a dense logsumexp)."""
    from repro_torch.kernels.flash.kernel import flash_attention_kernel
    from repro_torch.kernels.flash.ref import flash_ref
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(bh * s + hd + 1)
    q = (torch.randn((bh, s, hd), generator=gen, device=dev) * hd ** -0.5).to(qdt)
    k = torch.randn((bh, t, hd), generator=gen, device=dev).to(kvdt)
    v = torch.randn((bh, t, hd), generator=gen, device=dev).to(kvdt)
    o = flash_attention_kernel(q, k, v, causal=causal, window=window)
    o2, lse = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    assert torch.equal(o.view(torch.int16 if qdt == torch.bfloat16 else torch.int32),
                       o2.view(torch.int16 if qdt == torch.bfloat16 else torch.int32))
    _, want = flash_ref(q, k, v, causal=causal, window=window, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (bh, s)
    assert _rel(lse, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kvdt,tol", [(torch.float32, 1e-4),
                                      (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 96),
                                           (False, None)])
def test_cuda_flash_function_grads_match_autograd_through_plain(causal, window,
                                                                kvdt, tol):
    """``FlashAttention`` (the kernel forward with lse, the plain backward
    in kv blocks of 128, ragged T) against autograd through ``flash_ref``.
    Tolerance relative to the largest entry: 1e-4 with f32 k and v (the
    kernel's 1e-5, then f32 sums over the keys in another order), 1e-2
    with bf16 k and v (dk and dv rounded to bf16 on both sides)."""
    from repro_torch.kernels.flash.kernel import LAUNCHES
    from repro_torch.kernels.flash.ref import flash_ref
    from repro_torch.kernels.flash import FlashAttention
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((6, 333, 64), generator=gen, device=dev) * 0.125
    k, v = (torch.randn((6, 333, 64), generator=gen, device=dev).to(kvdt)
            for _ in range(2))
    dout = torch.randn((6, 333, 64), generator=gen, device=dev)
    res = []
    for fn in (lambda a, b, c: FlashAttention.apply(a, b, c, causal, window, 128),
               lambda a, b, c: flash_ref(a, b, c, causal=causal, window=window)):
        a, b, c = (x.clone().requires_grad_(True) for x in (q, k, v))
        before = LAUNCHES.count
        out = fn(a, b, c)
        res.append((LAUNCHES.count - before, out.detach(),
                    *torch.autograd.grad(out, (a, b, c), dout)))
    assert res[0][0] == 1 and res[1][0] == 0
    for got, want in zip(res[0][1:], res[1][1:]):
        assert got.dtype == want.dtype
        assert _rel(got.float(), want.float()) <= tol


@pytest.mark.cuda
def test_cuda_train_steps_repeat_bit_for_bit_through_flash(monkeypatch):
    """Three SMOKE steps with per-block remat and the blockwise threshold
    lowered, so every layer runs the flash kernel forward and again in its
    recompute: two runs from one seed give the same losses and
    parameters, bit for bit (atomics-free or deterministic backward)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash.kernel import LAUNCHES
    from repro_torch.launch.steps import TrainConfig
    from repro_torch.launch.train import train_loop
    from repro_torch.models import attention as attn_mod
    dev = _device()
    monkeypatch.setattr(attn_mod, "BLOCKWISE_THRESHOLD", 16)
    cfg = get_smoke_config("granite_3_2b").replace(remat=True)
    outs = []
    for _ in range(2):
        LAUNCHES.reset()
        out = train_loop(cfg, TrainConfig(peak_lr=3e-3, warmup_steps=1,
                                          total_steps=3),
                         global_batch=4, seq_len=96, steps=3,
                         log=lambda *a: None, device=dev)
        outs.append((out["losses"], LAUNCHES.count,
                     [p.detach().clone() for p in out["state"].params.parameters()]))
    assert outs[0][1] == 2 * cfg.n_layers * 3
    assert outs[0][0] == outs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][2], outs[1][2]))


@pytest.mark.cuda
def test_cuda_serve_path_launches_flash_once_per_layer():
    """A prompt over the blockwise threshold launches the kernel once per
    attention layer of its prefill (2 on the SMOKE config), and the
    engine's greedy tokens equal those of the CPU's plain path."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash.kernel import LAUNCHES
    from repro_torch.models import init_params, params_from_jax, params_to_numpy
    from repro_torch.serving import GenerationRequest, ServeEngine
    dev = _device()
    cfg = get_smoke_config("granite_3_2b").replace(dtype="float32")
    model = init_params(0, cfg, device=dev)
    cpu_model = params_from_jax(params_to_numpy(model), cfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 2100)
    outs = []
    for m in (model, cpu_model):
        eng = ServeEngine(cfg, m, max_batch=2, max_len=2112)
        req = GenerationRequest(request_id=0, prompt=prompt.astype(np.int32),
                                max_new_tokens=4)
        eng.submit(req)
        LAUNCHES.reset()
        eng.run()
        outs.append((req.status, req.output, LAUNCHES.count))
    assert outs[0][2] == cfg.n_layers and outs[1][2] == 0
    assert outs[0][:2] == outs[1][:2]


@pytest.mark.cuda
def test_cuda_compress_params_runs_the_id_kernels():
    """The paper's ID inside the LM stack: probing a model's projections on
    the card runs ``sketch_accum`` and ``panel_step``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving import compress_params
    dev = _device()
    cfg = get_smoke_config("granite_3_2b")
    model = init_params(0, cfg, device=dev)
    ACCUM_LAUNCHES.reset()
    PANEL_LAUNCHES.reset()
    _, report = compress_params(1, model, rank=8)
    # one report entry per projection (7), each probed in both layers
    assert len(report) == 7
    assert ACCUM_LAUNCHES.count == 14 and PANEL_LAUNCHES.count >= 14


@pytest.mark.cuda
def test_cuda_big_copy_exact_and_example_refused_as_status():
    """The analysis fixture kernel copies exactly where the operand fits
    one block's shared memory, and its 64 MiB contract example is refused
    as a status (RuntimeError) that leaves the context usable."""
    from repro_torch.analysis.fixtures.badkernel.kernel import (
        LAUNCHES as COPY_LAUNCHES)
    from repro_torch.analysis.fixtures.badkernel.ops import big_copy
    dev = _device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for shape, dtype, bn in (((48, 1024), torch.float32, 256),
                             ((32, 448), torch.complex128, 128)):
        x = _randn(gen, shape, dtype, dev)
        n0 = COPY_LAUNCHES.count
        assert torch.equal(big_copy(x, bn=bn), x)
        assert COPY_LAUNCHES.count == n0 + 1
    with pytest.raises(RuntimeError, match="big_copy"):
        big_copy(torch.zeros((4096, 4096), device=dev), bn=2048)
        torch.cuda.synchronize()
    x, a = _randn(gen, (96, 1024), torch.float64, dev), \
        _randn(gen, (1024, 512), torch.float64, dev)
    acc = torch.zeros((96, 512), dtype=torch.float64, device=dev)
    assert _rel(sketch_accum(x, a), sketch_accum_ref(x, a, acc)) <= \
        REL_TOL[torch.float64]


@pytest.mark.cuda
def test_cuda_contract_geometry_equals_the_c_side():
    """Every production contract's declared launches equal what the
    wrapper calls and what the C side launches, within the budget; the
    fixture's example is over it on the card too."""
    from repro_torch.analysis.fixtures import BADKERNEL_BASE
    from repro_torch.analysis.kernels import (check_all_kernels,
                                              check_package, geometry_report,
                                              kernel_packages)
    dev = _device()
    findings, pkgs = check_all_kernels(dev)
    assert [f for f in findings if f.severity == "error"] == [], findings
    assert any(f.rule == "kernels.residency" for f in findings)
    for pkg in kernel_packages():
        assert all(row["equal"] and row["status"] == 0
                   for row in geometry_report(pkg)), pkg
    bad = check_package("badkernel", base=BADKERNEL_BASE, device=dev)
    assert sorted({f.rule for f in bad}) == ["kernels.smem-overflow"], bad
    (row,) = geometry_report("badkernel", base=BADKERNEL_BASE)
    assert row["equal"] and row["c_smem"] == 4096 * 4096 * 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("chunk_rows", [128, 384, 2048])
def test_cuda_streamed_rid_equals_in_memory_rid(dtype, chunk_rows):
    """rid_streamed from a host ArraySource (each chunk through the pinned
    ring and the copy stream) gives the card's in-memory gaussian rid bit
    for bit in all five fields, one sketch_accum launch a chunk."""
    from repro_torch.stream import ArraySource, rid_streamed
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(30)
    m, n, k = 2048, 384, 24
    A = _randn(gen, (m, k), dtype, dev) @ _randn(gen, (k, n), dtype, dev)
    want = rid(5, A, k, sketch_kind="gaussian")
    before = ACCUM_LAUNCHES.count
    got = rid_streamed(5, ArraySource(A.cpu(), chunk_rows), k)
    assert ACCUM_LAUNCHES.count - before == -(-m // chunk_rows)
    assert got.B.device.type == "cpu"
    for f in "BPJQR":
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()), f


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_cuda_pinned_ring_overlapped_equals_serialized(dtype):
    """The two-buffer pinned ring on a copy stream (overlap=True) against
    every copy and accumulation serialized on the compute stream, and a
    SpectrumSource whose chunks are made on the card (no copy): the same
    bits, run after run."""
    from repro_torch.stream import ArraySource, SpectrumSource, rid_streamed
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(31)
    m, n, k = 4096, 512, 32
    A = (_randn(gen, (m, k), dtype, dev) @ _randn(gen, (k, n), dtype, dev)).cpu()
    src = ArraySource(A, 256)
    runs = [rid_streamed(2, src, k, overlap=o) for o in (True, False, True)]
    for f in "BPJQR":
        a = getattr(runs[0], f)
        assert all(torch.equal(getattr(r, f), a) for r in runs[1:]), f
    spec = SpectrumSource(3, m, n, "fast_decay", k, chunk_rows=512,
                          dtype=dtype, floor=1e-12, device=dev)
    s1, s2 = (rid_streamed(2, spec, k, overlap=o) for o in (True, False))
    assert all(torch.equal(getattr(s1, f), getattr(s2, f)) for f in "BPJQR")
    dense = rid(2, spec.materialize(), k, sketch_kind="gaussian")
    assert all(torch.equal(getattr(s1, f).cpu(), getattr(dense, f).cpu())
               for f in "BPJQR")


@pytest.mark.cuda
def test_cuda_row_diagonal_matches_the_cpu():
    """The splitmix64 row diagonal evaluated on the card (int64 wrap-around
    and masked shifts) gives the CPU's signs exactly and its phases to the
    last bits of the card's sin and cos."""
    from repro_torch.data import row_diagonal
    dev = _device()
    for seed in (0, 7, 2 ** 63 + 5):
        rows = (10 ** 6, 10 ** 6 + 4096)
        assert torch.equal(row_diagonal(seed, *rows, torch.float64, dev).cpu(),
                           row_diagonal(seed, *rows, torch.float64, "cpu"))
        z = row_diagonal(seed, *rows, torch.complex128, dev).cpu()
        assert float((z - row_diagonal(seed, *rows, torch.complex128,
                                       "cpu")).abs().max()) <= 1e-15


@pytest.mark.cuda
def test_cuda_moe_ffn_matches_the_cpu_and_repeats():
    """One SMOKE qwen2-moe layer's ``moe_ffn`` (24-token groups, 8 experts
    top-4, the gated shared expert) in f32 on the card against the CPU on
    the same weights and input: the routing (top-k, keep) equal, y and the
    aux values within 1e-5 of the largest entry (f32 sums in another
    order), and two card calls bit-equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe as moe_mod
    dev = _device()
    cfg = get_smoke_config("qwen2_moe_a2_7b").replace(dtype="float32")
    cpu = moe_mod.MoE(cfg).init_(torch.Generator().manual_seed(0))
    card = moe_mod.MoE(cfg, device=dev)
    for a, b in zip(card.parameters(), cpu.parameters()):
        a.copy_(b)
    x = torch.randn((4, 24, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    want, want_aux = moe_mod.moe_ffn(cpu, cfg, x)
    got, aux = moe_mod.moe_ffn(card, cfg, x.to(dev))
    again, aux2 = moe_mod.moe_ffn(card, cfg, x.to(dev))
    assert torch.equal(got, again) and all(
        torch.equal(a, b) for a, b in zip(aux, aux2))
    assert _rel(got.cpu(), want) <= 1e-5
    for a, b in zip(aux, want_aux):
        assert abs(float(a) - float(b)) <= 1e-5
    C = moe_mod.moe_capacity(cfg, 24)
    routing = []
    for mod, t in ((cpu, x), (card, x.to(dev))):
        _, _, top_i = moe_mod.route(mod, cfg, t)
        _, keep = moe_mod.dispatch_indices(top_i.reshape(4, -1),
                                           cfg.n_experts, C)
        routing.append((top_i.cpu(), keep.cpu()))
    assert torch.equal(routing[0][0], routing[1][0])
    assert torch.equal(routing[0][1], routing[1][1])


@pytest.mark.cuda
def test_cuda_moe_train_steps_repeat_bit_for_bit():
    """Three SMOKE qwen2-moe steps (remat on, so each block's dispatch,
    combine and their backward also run in the recompute) under the
    step's deterministic mode: no error, and two runs from one seed give
    the same losses, last MoE metrics and parameters, bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import TrainConfig
    from repro_torch.launch.train import train_loop
    dev = _device()
    cfg = get_smoke_config("qwen2_moe_a2_7b").replace(remat=True)
    outs = []
    for _ in range(2):
        out = train_loop(cfg, TrainConfig(peak_lr=3e-3, warmup_steps=1,
                                          total_steps=3),
                         global_batch=4, seq_len=96, steps=3,
                         log=lambda *a: None, device=dev)
        outs.append((out["losses"],
                     (out["final"]["moe_lb"], out["final"]["moe_drop"]),
                     [p.detach().clone()
                      for p in out["state"].params.parameters()]))
    assert all(math.isfinite(v) for v in outs[0][0])
    assert outs[0][:2] == outs[1][:2]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][2], outs[1][2]))
