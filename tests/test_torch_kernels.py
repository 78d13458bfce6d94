"""Parity of the port's kernel packages (``repro_torch.kernels``) with the
JAX reference, on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode (real dtypes) or its jnp
oracles (complex), exactly as the reference's own tests do.  Inputs are
made with a seeded numpy generator and cross as numpy arrays.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import PAPER_GRID  # noqa: E402
from repro_torch.kernels.common import (DMMA_BM, DMMA_BN,  # noqa: E402
                                        DMMA_THREADS, GEMM_THREADS,
                                        SMEM_BUDGET_BYTES, acc_dtype_for,
                                        cdiv, dmma_smem_bytes, dtype_code,
                                        gemm_tile, pad_to, product_tile,
                                        round_up, type_name)
from repro_torch.kernels.panel_step import panel_step  # noqa: E402
from repro_torch.kernels.sketch_accum import (ACCUM_BLOCK,  # noqa: E402
                                              sketch_accum)
from repro_torch.kernels.sketch_accum.kernel import (  # noqa: E402
    ACCUM_STAGES, sketch_accum_launch)
from repro_torch.kernels.sketch_matmul.kernel import (  # noqa: E402
    MATMUL_STAGES, sketch_matmul_launch)
from repro_torch.kernels.panel_gram.kernel import (  # noqa: E402
    GRAM_ROWS, GRAM_STAGES, GRAM_WARP_ROWS, GRAM_WARPS, gram_cols,
    gram_warps, panel_gram_launch)
from repro_torch.kernels.panel_step.kernel import (  # noqa: E402
    APPLY_MIN_CTAS, APPLY_NORM_GROUPS, APPLY_ROWS, APPLY_STAGES,
    apply_geometry, apply_launch)
from repro_torch.kernels.tsolve.kernel import (  # noqa: E402
    DEPTH, SLAB_BYTES, STAGES, THREADS, tsolve_geometry, tsolve_launch)
from repro_torch.kernels.tsolve.ref import BLOCK_ROWS  # noqa: E402
from torch_ranks import pin_threads  # noqa: E402

pin_threads()


def _t(x):
    """numpy -> torch on the CPU, dtype kept."""
    return interop.to_torch(x, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _x64_scope():
    """f64 for this module only, restored afterwards (the x64 flag is
    process-wide and would leak into other modules on the same worker)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


DTYPES = ["float32", "float64", "complex64", "complex128"]


def _rand(rng, shape, dtype):
    dt = np.dtype(dtype)
    if dt.kind == "c":
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(dt)
    return rng.standard_normal(shape).astype(dt)


def _is_single(dtype):
    return dtype in ("float32", "complex64")


# ------------------------------------------------------------------ common

def test_common_helpers():
    assert cdiv(7, 3) == 3 and cdiv(6, 3) == 2
    assert round_up(129, 128) == 256
    x = torch.ones((3, 5), dtype=torch.float64)
    y = pad_to(x, (4, 8))
    assert y.shape == (4, 8) and y.dtype == torch.float64
    assert float(y.sum()) == 15.0 and pad_to(x, (3, 5)) is x
    assert acc_dtype_for(torch.float64) == torch.float64
    assert acc_dtype_for(torch.bfloat16) == torch.float32


@pytest.mark.parametrize("dtype", DTYPES + ["int32"])
def test_interop_roundtrip_keeps_dtype(dtype):
    rng = np.random.default_rng(0)
    x = (_rand(rng, (4, 3), dtype) if dtype != "int32"
         else rng.integers(0, 9, (4, 3)).astype(np.int32))
    t = _t(x[:, ::2])            # non-contiguous view in
    back = interop.to_numpy(t)
    assert back.dtype == x.dtype
    np.testing.assert_array_equal(back, x[:, ::2])


# ------------------------------------------------------------ sketch_accum

@pytest.mark.parametrize("l,m,n", [(8, 128, 32), (24, 1000, 150),
                                   (17, 300, 129)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sketch_accum_matches_jax_ref(l, m, n, dtype):
    """The port's canonically blocked sum against JAX's
    ``sketch_accum_ref``, ragged m and n included.  Tolerance
    ``1e-4 sqrt(m)`` (single) / ``1e-10 sqrt(m)`` (double), as in
    tests/test_kernels.py: the two libraries sum inside a block in
    different orders, so bits are not expected to match."""
    from repro.kernels.sketch_accum.ref import sketch_accum_ref
    rng = np.random.default_rng(1)
    x, a, acc = (_rand(rng, (l, m), dtype), _rand(rng, (m, n), dtype),
                 _rand(rng, (l, n), dtype))
    want = np.asarray(sketch_accum_ref(jnp.asarray(x), jnp.asarray(a),
                                       jnp.asarray(acc)))
    got = sketch_accum(_t(x), _t(a), _t(acc))
    assert got.dtype == _t(acc).dtype
    tol = (1e-4 if _is_single(dtype) else 1e-10) * np.sqrt(m)
    np.testing.assert_allclose(interop.to_numpy(got), want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sketch_accum_chunk_invariance(dtype):
    """The replay pin: chunked calls at ACCUM_BLOCK multiples (an uneven
    last chunk included) give the bits of one call."""
    rng = np.random.default_rng(2)
    m = 5 * ACCUM_BLOCK + 37
    x = _t(_rand(rng, (16, m), dtype))
    a = _t(_rand(rng, (m, 40), dtype))
    whole = sketch_accum(x, a)
    for cut in ([256, 640], [128, 384, 512]):
        acc, r0 = None, 0
        for r1 in cut + [m]:
            acc = sketch_accum(x[:, r0:r1], a[r0:r1], acc)
            r0 = r1
        assert torch.equal(acc, whole), cut


def test_sketch_accum_eager_validation():
    with pytest.raises(ValueError, match=r"x columns \(64\) must match a "
                                         r"rows \(128\)"):
        sketch_accum(torch.ones(4, 64), torch.ones(128, 8))
    with pytest.raises(ValueError, match=r"acc shape \(4, 7\) must be "
                                         r"\(4, 8\)"):
        sketch_accum(torch.ones(4, 64), torch.ones(64, 8), torch.ones(4, 7))


# The paper's rows (l = 2k) and ragged small shapes, for the launch
# geometry of sketch_accum and project_out.
GEOMETRY_SHAPES = ([(2 * c.k, c.m, c.n) for c in PAPER_GRID]
                   + [(1, 5, 1), (100, 777, 129), (130, 1037, 257),
                      (128, 128, 128), (129, 384, 131)])
TORCH_DTYPES = [torch.float32, torch.float64, torch.complex64,
                torch.complex128]


@pytest.mark.parametrize("dtype", TORCH_DTYPES)
@pytest.mark.parametrize("l,m,n", GEOMETRY_SHAPES)
def test_sketch_accum_launch_tiles_the_output(dtype, l, m, n):
    """One CTA per output tile, the row blocks the fastest grid index
    (blockIdx.x), every tile holding at least one output element, within
    the grid limits and one block's shared memory; f64 on the DMMA
    kernel, the others on the register tile."""
    ln = sketch_accum_launch(dtype, l, m, n)
    bm, bn = product_tile(dtype)
    gx, gy, gz = ln.grid
    assert (gx, gy, gz) == (cdiv(l, bm), cdiv(n, bn), 1)
    assert (gx - 1) * bm < l <= gx * bm and (gy - 1) * bn < n <= gy * bn
    assert gx <= 2 ** 31 - 1 and gy <= 65535
    assert ln.smem <= SMEM_BUDGET_BYTES and ln.threads_per_block <= 1024
    assert ln.args == (dtype_code(dtype), None, None, None, None, l, m, n,
                       None)
    if dtype == torch.float64:
        assert (bm, bn) == (DMMA_BM, DMMA_BN) == (128, 128)
        assert ln.kernel == "sketch_accum_dmma_kernel<true>"
        assert ln.threads == (DMMA_THREADS, 1, 1)
        # the ring of ACCUM_STAGES stages (32 KB each) and the 128 KB
        # running tile
        assert ln.smem == ACCUM_STAGES * 32768 + 131072 == 229376
    else:
        assert ln.kernel == f"sketch_accum_kernel<{type_name(dtype)}>"
        assert ln.smem == 0 and ln.threads == GEMM_THREADS


def test_sketch_matmul_f64_launch_is_the_dmma_kernel_at_the_paper_row():
    """Table 2's row (f64, l=800, m=2^16, n=2^14): the DMMA kernel, row
    blocks fastest (7 of 128 rows, 128 slabs of 128 columns), a ring of
    MATMUL_STAGES 32 KB stages within one block's shared memory."""
    ln = sketch_matmul_launch(torch.float64, 800, 2 ** 16, 2 ** 14)
    assert ln.kernel == "sketch_matmul_dmma_kernel<true>"
    assert ln.grid == (7, 128, 1) and ln.threads == (DMMA_THREADS, 1, 1)
    assert ln.smem == dmma_smem_bytes(MATMUL_STAGES) <= SMEM_BUDGET_BYTES
    assert MATMUL_STAGES >= 6 and ln.smem == MATMUL_STAGES * 32768
    assert ln.entry == "repro_sketch_matmul"


@pytest.mark.parametrize("dtype", TORCH_DTYPES)
@pytest.mark.parametrize("l,m,n", GEOMETRY_SHAPES)
def test_sketch_matmul_launch_tiles_the_output(dtype, l, m, n):
    """One CTA per output tile, row blocks on blockIdx.x, every tile
    holding an output element, within the grid limits; f64 on the DMMA
    tile, f32, c64 and c128 on the register tile (never the tensor cores:
    no TF32 for f32)."""
    ln = sketch_matmul_launch(dtype, l, m, n)
    bm, bn = product_tile(dtype)
    gx, gy, gz = ln.grid
    assert (gx, gy, gz) == (cdiv(l, bm), cdiv(n, bn), 1)
    assert (gx - 1) * bm < l <= gx * bm and (gy - 1) * bn < n <= gy * bn
    assert gy <= 65535 and ln.smem <= SMEM_BUDGET_BYTES
    assert ln.args == (dtype_code(dtype), None, None, None, l, m, n, None)
    if dtype == torch.float64:
        assert ln.kernel == "sketch_matmul_dmma_kernel<true>"
        assert (bm, bn) == (DMMA_BM, DMMA_BN)
    else:
        assert ln.kernel == f"sketch_matmul_kernel<{type_name(dtype)}>"
        assert (bm, bn) == gemm_tile(dtype)
        assert ln.smem == 0 and ln.threads == GEMM_THREADS


@pytest.mark.parametrize("dtype", TORCH_DTYPES)
@pytest.mark.parametrize("b", [1, 7, 16, 32, 64])
@pytest.mark.parametrize("n", [0, 1, 300, 2 ** 14])
def test_panel_gram_launch_covers_c_and_z(dtype, b, n):
    """CTA 0 for the Gram (its operand C, b <= one CTA's columns), one CTA
    per slab of Z after it, so the grid covers the b + n columns of
    [C | Z]; a row group of warps per GRAM_WARP_ROWS panel columns, column
    groups of 32 tj columns tiling the slab, at most GRAM_WARPS warps; the
    ring within one block's shared memory, the widest case (c128, b = 64)
    included."""
    ln = panel_gram_launch(dtype, 800, b, n)
    nc = gram_cols(dtype)
    item = torch.empty((), dtype=dtype).element_size()
    bp = round_up(b, GRAM_WARP_ROWS)
    assert b <= nc and ln.grid == (1 + cdiv(n, nc), 1, 1)
    assert (ln.grid[0] - 1) * nc >= n > (ln.grid[0] - 2) * nc or n == 0
    gp, gc, tj = gram_warps(dtype, b)
    assert gp * GRAM_WARP_ROWS == bp and gc * 32 * tj == nc
    assert ln.threads == (32 * gp * gc, 1, 1)
    assert 32 <= ln.threads_per_block <= 32 * GRAM_WARPS
    assert ln.smem == item * GRAM_STAGES * GRAM_ROWS * (bp + nc)
    assert ln.smem <= SMEM_BUDGET_BYTES
    assert ln.kernel == f"panel_gram_kernel<{type_name(dtype)},true,{tj}>"
    assert ln.args == (dtype_code(dtype), None, None, None, None, 800, b, n,
                       None)
    if dtype == torch.complex128 and b == 64:
        assert ln.smem == 196608
    if dtype == torch.float64 and b == 32 and n == 2 ** 14:
        assert ln.grid == (129, 1, 1) and (gp, gc, tj) == (4, 2, 2)


@pytest.mark.parametrize("dtype", TORCH_DTYPES)
@pytest.mark.parametrize("b", [1, 17, 32, 64])
@pytest.mark.parametrize("n", [1, 1037, 4096, 2 ** 14, 2 ** 14 + 3])
def test_panel_apply_launch_slabs_by_shape(dtype, b, n):
    """One 16-byte vector of Z a thread a row: the widest of 64 and 32
    vectors that still gives APPLY_MIN_CTAS CTAs and fits (256 threads in
    4 or 8 row groups), else 16 (128 threads, 8 row groups); W's slab, the
    ring of APPLY_STAGES chunks of APPLY_ROWS rows of Q_p and Z, and the
    APPLY_NORM_GROUPS norm partials within one block's shared memory;
    16-byte copies when b and n fill whole vectors."""
    ln = apply_launch(dtype, 800, b, n)
    item = torch.empty((), dtype=dtype).element_size()
    ritem = torch.empty((), dtype=dtype).real.element_size()
    vec = 16 // item
    cols = apply_geometry(dtype, b, n)
    bq = round_up(b, vec)

    def smem_of(nc):
        return (item * (bq * nc + APPLY_STAGES * APPLY_ROWS * (bq + nc))
                + ritem * APPLY_NORM_GROUPS * nc)

    fits = [v for v in (64, 32) if cdiv(n, v * vec) >= APPLY_MIN_CTAS
            and smem_of(v * vec) <= SMEM_BUDGET_BYTES]
    vecs = fits[0] if fits else 16
    assert cols == vecs * vec
    smem = smem_of(cols)
    assert ln.grid == (cdiv(n, cols), 1, 1)
    assert ln.threads == ({64: 256, 32: 256, 16: 128}[vecs], 1, 1)
    assert ln.smem == smem <= SMEM_BUDGET_BYTES
    aligned = str(b * item % 16 == 0 and n * item % 16 == 0).lower()
    assert ln.kernel == (f"panel_apply_kernel<{type_name(dtype)},{cols},"
                         f"{aligned}>")
    assert ln.args == (dtype_code(dtype),) + (None,) * 5 + (800, b, n, None)


def test_panel_apply_launch_at_the_distributed_shapes():
    """f64 at the main row (l=800, b=32): 128-column slabs, 128 CTAs of
    256 threads at n = 2^14; 32-column slabs, 128 CTAs of 128 threads at a
    4-rank shard (n = 4096); c128 at b = 64 falls back to the 32-vector
    slab, whose ring fits."""
    f64 = torch.float64
    main = apply_launch(f64, 800, 32, 2 ** 14)
    assert (main.grid, main.threads, main.smem) == ((128, 1, 1), (256, 1, 1),
                                                    163840)
    shard = apply_launch(f64, 800, 32, 4096)
    assert (shard.grid, shard.threads) == ((128, 1, 1), (128, 1, 1))
    assert apply_geometry(torch.complex128, 32, 2 ** 14) == 64
    assert apply_geometry(torch.complex128, 64, 2 ** 14) == 32


@pytest.mark.parametrize("dtype", TORCH_DTYPES)
@pytest.mark.parametrize("k", [1, 31, 33, 150, 352, 353, 400, 401, 416, 417,
                               1000])
def test_tsolve_launch_keeps_the_slab_where_it_fits(dtype, k):
    """One CTA of THREADS per SLAB_BYTES of a row of T; the solved rows
    stay in shared memory (k rounded up to DEPTH rows of the slab, the
    diagonal triangle and a ring of STAGES R1 tiles) while that fits one
    block, else the ring also carries T's rows (re-reading)."""
    item = torch.empty((), dtype=dtype).element_size()
    cols = SLAB_BYTES // item
    n = 2 ** 14 + 5
    ln = tsolve_launch(dtype, k, n)
    cols_g, resident, smem = tsolve_geometry(dtype, k)
    kept = (round_up(k, DEPTH) * cols + BLOCK_ROWS * (BLOCK_ROWS + 1)
            + STAGES * BLOCK_ROWS * DEPTH) * item
    reread = (BLOCK_ROWS * cols + BLOCK_ROWS * (BLOCK_ROWS + 1)
              + STAGES * (BLOCK_ROWS * DEPTH + DEPTH * cols)) * item
    assert cols_g == cols and resident == (kept <= SMEM_BUDGET_BYTES)
    assert smem == (kept if resident else reread) <= SMEM_BUDGET_BYTES
    assert ln.grid == (cdiv(n, cols), 1, 1) and ln.threads == (THREADS, 1, 1)
    assert ln.smem == smem
    assert ln.kernel == (f"tsolve_kernel<{type_name(dtype)},"
                         f"{str(resident).lower()}>")
    # the paper's row keeps its slab in f32, f64 and c64
    if k == 400:
        assert resident == (dtype != torch.complex128)
    if dtype == torch.float64 and k == 400:
        assert (ln.grid[0], ln.smem) == (257, 229632)


def test_panel_apply_and_tsolve_constants_pinned_to_the_c_side():
    """The Python geometry constants equal the CUDA sources' (the kernel
    contracts hold the same pairs; this reads the sources directly)."""
    from pathlib import Path

    from repro_torch.analysis.kernels import c_constant
    csrc = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
    for value, fname, name in (
            (APPLY_NORM_GROUPS, "panel_apply.cu", "kApplyNormGroups"),
            (APPLY_ROWS, "panel_apply.cu", "kApplyRows"),
            (APPLY_STAGES, "panel_apply.cu", "kApplyStages"),
            (APPLY_MIN_CTAS, "panel_apply.cu", "kApplyMinCtas"),
            (THREADS, "tsolve.cu", "kSolveThreads"),
            (BLOCK_ROWS, "tsolve.cu", "kSolveRows"),
            (DEPTH, "tsolve.cu", "kSolveDepth"),
            (STAGES, "tsolve.cu", "kSolveStages"),
            (SLAB_BYTES, "tsolve.cu", "kSolveSlabBytes"),
            (SMEM_BUDGET_BYTES, "tsolve.cu", "kSolveSmemBudget"),
            (SMEM_BUDGET_BYTES, "panel_apply.cu", "kApplySmemBudget")):
        assert c_constant(csrc / fname, name) == value, (fname, name)


# -------------------------------------------------------------- panel_step

PS_TOL = {"float32": 1e-4, "complex64": 1e-4,
          "float64": 1e-11, "complex128": 1e-11}


@pytest.mark.parametrize("l,b,n", [(64, 32, 200), (48, 7, 129),
                                   (40, 16, 300)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_panel_step_matches_jax(l, b, n, dtype):
    """The port's plain panel step against JAX: real dtypes against the
    Pallas body in interpret mode, complex ones against
    ``panel_step_ref``.  ``emit_w`` both ways; b=7 and b=16 are remainder
    widths.  Tolerance relative to each output's largest entry (PS_TOL):
    both factor in the working precision with different summation
    orders."""
    from repro.kernels.panel_step import panel_step as jax_panel_step
    from repro.kernels.panel_step.ref import panel_step_ref
    rng = np.random.default_rng(3)
    c, z = _rand(rng, (l, b), dtype), _rand(rng, (l, n), dtype)
    if np.dtype(dtype).kind == "c":
        want = panel_step_ref(jnp.asarray(c), jnp.asarray(z))
    else:
        want = jax_panel_step(jnp.asarray(c), jnp.asarray(z))
    got = panel_step(_t(c), _t(z))
    for name, g, w in zip(("qp", "o", "w", "r2"), got, want):
        g, w = interop.to_numpy(g), np.asarray(w)
        assert g.shape == w.shape, name
        scale = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(g, w, atol=PS_TOL[dtype] * scale, rtol=0,
                                   err_msg=name)
    qp, o, w_none, r2 = panel_step(_t(c), _t(z), emit_w=False)
    assert w_none is None
    assert torch.equal(o, got[1]) and torch.equal(r2, got[3])
    assert r2.dtype == (qp.real.dtype if qp.is_complex() else qp.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_panel_step_duplicate_columns_detectable(dtype):
    """A duplicate-column panel: the port gives finite output whose factor
    fails the callers' orthogonality check; the JAX kernel also fails that
    check (there through a non-finite or non-orthonormal factor)."""
    from repro.kernels.panel_step import panel_step as jax_panel_step
    rng = np.random.default_rng(4)
    c4 = _rand(rng, (64, 4), dtype)
    c = np.concatenate([c4, c4], axis=1)
    z = _rand(rng, (64, 100), dtype)
    eps = np.finfo(np.dtype(dtype)).eps
    qp, o, w, r2 = panel_step(_t(c), _t(z))
    for t in (qp, o, w, r2):
        assert bool(torch.isfinite(t).all())
    orth = float((qp.mH @ qp - torch.eye(8, dtype=qp.dtype)).abs().max())
    assert orth > np.sqrt(eps)
    if np.dtype(dtype).kind != "c":
        jq = np.asarray(jax_panel_step(jnp.asarray(c), jnp.asarray(z))[0])
        bad = (not np.isfinite(jq).all()) or \
            np.abs(jq.conj().T @ jq - np.eye(8)).max() > np.sqrt(eps)
        assert bad


def test_panel_step_eager_validation():
    with pytest.raises(ValueError, match=r"c rows \(8\) must match z rows "
                                         r"\(9\)"):
        panel_step(torch.ones(8, 2), torch.ones(9, 4))


# ------------------------------------------------- dispatch off the card

def test_cpu_tensors_take_the_plain_version():
    """CPU tensors never reach a kernel: the launch counts stay put."""
    from repro_torch.kernels.panel_step.kernel import LAUNCHES as LP
    from repro_torch.kernels.sketch_accum.kernel import LAUNCHES as LA
    before = (LA.count, LP.count)
    sketch_accum(torch.ones(4, 130), torch.ones(130, 3))
    panel_step(torch.randn(16, 4, dtype=torch.float64),
               torch.randn(16, 10, dtype=torch.float64))
    assert (LA.count, LP.count) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The raw kernel wrappers take CUDA tensors only: a CPU tensor raises
    rather than running anything."""
    from repro_torch.kernels.panel_step.kernel import panel_step_kernel
    from repro_torch.kernels.sketch_accum.kernel import sketch_accum_kernel
    with pytest.raises(ValueError, match="CUDA"):
        sketch_accum_kernel(torch.ones(2, 3), torch.ones(3, 4),
                            torch.ones(2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        panel_step_kernel(torch.ones(8, 2), torch.ones(8, 4))
