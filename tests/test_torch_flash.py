"""The port's flash attention against the JAX reference, on the CPU.

The port's ``flash_attention`` runs its plain version (``ref.py``) on CPU
tensors; the reference's ``repro.kernels.flash.ops.flash_attention`` runs
its Pallas kernel in interpret mode, as tests/test_kernels.py runs it.
Inputs are made with a seeded numpy generator and cross as numpy arrays.
Tolerance: 2e-5 absolute, as tests/test_kernels.py holds the Pallas kernel
to its oracle (f32 sums in another order; outputs are O(1)).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash.ops import flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels.flash import flash_attention  # noqa: E402
from repro_torch.kernels.flash.kernel import (LAUNCHES,  # noqa: E402
                                              flash_attention_kernel)
from repro_torch.kernels.flash.ref import flash_ref  # noqa: E402

ATOL = 2e-5


def _inputs(S, T, H, hd, kv_dtype="float32", B=2, kv_heads=None, seed=11):
    """q (B, S, H, hd) f32; k, v (B, T, H, hd), repeated from ``kv_heads``
    heads when given (the model's GQA layout)."""
    rng = np.random.default_rng(seed)
    kvh = H if kv_heads is None else kv_heads
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, kvh, hd)).astype(np.float32)
    k, v = (np.repeat(t, H // kvh, axis=2) for t in (k, v))
    if kv_dtype == "bfloat16":        # round once, the same bits on both sides
        k = np.asarray(jnp.asarray(k, jnp.bfloat16))
        v = np.asarray(jnp.asarray(v, jnp.bfloat16))
    return q, k, v


def _torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("S,T,H,hd,causal,window,kv_dtype,kv_heads", [
    (100, 100, 3, 16, True, None, "float32", None),
    (65, 129, 2, 8, True, None, "float32", None),   # rectangular + padding
    (64, 64, 2, 16, True, 24, "float32", None),     # sliding window
    (48, 80, 1, 32, False, None, "float32", None),  # non-causal
    (96, 96, 2, 80, True, 40, "float32", None),     # danube's hd=80, window
    (70, 70, 4, 16, True, None, "float32", 2),      # GQA, KV repeated 2x
    (90, 90, 2, 64, True, None, "bfloat16", None),  # the model's k/v dtype
    (80, 80, 4, 80, True, 32, "bfloat16", 2),       # all three at once
])
def test_flash_matches_pallas_interpret(S, T, H, hd, causal, window,
                                        kv_dtype, kv_heads):
    q, k, v = _inputs(S, T, H, hd, kv_dtype, kv_heads=kv_heads)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, bq=32, bk=32,
                     interpret=True)
    before = LAUNCHES.count
    got = flash_attention(_torch(q), _torch(k), _torch(v), causal=causal,
                          window=window)
    assert LAUNCHES.count == before          # the CPU runs the plain version
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (q.shape[0], S, H * hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, None)])
def test_flash_ref_matches_jax_ref(causal, window):
    """The plain versions agree on head-major inputs with a true length
    ``T`` below the padded one."""
    from repro.kernels.flash.ref import flash_ref as jax_ref
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 40, 24)).astype(np.float32)
    k = rng.standard_normal((3, 48, 24)).astype(np.float32)
    v = rng.standard_normal((3, 48, 24)).astype(np.float32)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), T=45,
                   causal=causal, window=window)
    got = flash_ref(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), T=45, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_flash_bf16_q_keeps_its_dtype():
    """q in bf16 is scaled in bf16 and the output comes back in bf16, as
    the reference's ops.py does it."""
    q, k, v = _inputs(33, 33, 2, 80)
    qb = jnp.asarray(q, jnp.bfloat16)
    want = jax_flash(qb, jnp.asarray(k), jnp.asarray(v), causal=True,
                     bq=32, bk=32, interpret=True)
    got = flash_attention(_torch(np.asarray(qb)), _torch(k), _torch(v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2)   # one bf16 rounding of O(1) values


def test_flash_shape_errors():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="need q"):
        flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError, match="need q"):
        flash_attention(q, torch.zeros(1, 8, 2, 16), torch.zeros(1, 9, 2, 16))


def test_flash_kernel_refuses_cpu_tensors():
    """The wrapper of the kernel takes CUDA tensors only; nothing on the
    CPU reaches it through ``flash_attention``."""
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, q, q)


# ------------------------------------- the kernel's split-TF32 arithmetic

# The card's bar for the kernel against ``flash_ref`` (chip_smoke.py):
# relative to the largest output entry.
FLASH_TOL = 1e-5


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, to nearest
    with ties away from zero, by masking the bits (the sign bit is apart,
    so adding half an ulp to the pattern rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _products(a, b, a_exact: bool, b_exact: bool, one_pass: bool = False):
    """``a @ b`` as the kernel's tensor-core passes form it: exact products
    of TF32 operands summed (here in f64), the hi x hi sum and the small
    terms' sum each rounded to f32, then added in f32.  A bf16 operand is
    exact in TF32 and not split; ``one_pass`` is the single TF32 product
    the kernel does not use."""
    def mm(u, v):
        return (u.double() @ v.double()).float()
    ah, al = (a, None) if a_exact else _split(a)
    bh, bl = (b, None) if b_exact else _split(b)
    if one_pass:
        return mm(_tf32(a), _tf32(b))
    small = torch.zeros((), dtype=torch.float32)
    if al is not None:
        small = small + mm(al, bh)
    if bl is not None:
        small = small + mm(ah, bl)
    return mm(ah, bh) + small


def _flash_emulated(q, k, v, *, causal=True, window=None, one_pass=False,
                    bq=64, bk=64):
    """The kernel's arithmetic on the CPU: q blocks of ``bq`` rows, the live
    kv blocks of ``bk`` rows in order (the TPU kernel's skip), scores from
    the split products, the mask at -1e30, the online softmax in f32 (m, l,
    acc * alpha + p v with p split), ``acc / max(l, 1e-30)``."""
    BH, S, hd = q.shape
    T = k.shape[1]
    kv_exact = k.dtype == torch.bfloat16
    k, v = k.float(), v.float()
    out = torch.zeros((BH, S, hd), dtype=torch.float32)
    for q0 in range(0, S, bq):
        qb = q[:, q0:q0 + bq].float()
        rows = torch.arange(q0, q0 + qb.shape[1])[:, None]
        m = torch.full((BH, qb.shape[1], 1), -1e30)
        l = torch.zeros((BH, qb.shape[1], 1))
        acc = torch.zeros((BH, qb.shape[1], hd))
        for k0 in range(0, T, bk):
            if causal and k0 > q0 + bq - 1:
                continue
            if window is not None and k0 + bk - 1 <= q0 - window:
                continue
            kb, vb = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
            s = _products(qb, kb.transpose(1, 2), False, kv_exact, one_pass)
            keys = torch.arange(k0, k0 + kb.shape[1])[None, :]
            ok = keys < T
            if causal:
                ok = ok & (keys <= rows)
            if window is not None:
                ok = ok & (keys > rows - window)
            s = torch.where(ok[None], s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            pv = _products(p, vb, False, kv_exact, one_pass)
            acc = acc * alpha + pv
            m = m_new
        out[:, q0:q0 + bq] = acc / torch.clamp(l, min=1e-30)
    return out


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("window", [None, 48])
def test_split_tf32_arithmetic_holds_flash_tol(kv_dtype, hd, window):
    """The kernel's split products (hi + lo for every f32 operand, bf16
    exact) in its block order hold ``flash_ref`` to ``FLASH_TOL``, f32 q
    with bf16 k/v (the model's call) and all f32, causal and windowed; a
    one-pass TF32 product (q rounded to 10 bits) does not."""
    rng = np.random.default_rng(hd + (window or 0))
    BH, S = 2, 200
    q = torch.from_numpy(rng.standard_normal((BH, S, hd)).astype(np.float32)
                         * hd ** -0.5)
    k = torch.from_numpy(rng.standard_normal((BH, S, hd)).astype(
        np.float32)).to(kv_dtype)
    v = torch.from_numpy(rng.standard_normal((BH, S, hd)).astype(
        np.float32)).to(kv_dtype)
    want = flash_ref(q, k, v, causal=True, window=window)
    scale = float(want.abs().max())
    got = _flash_emulated(q, k, v, window=window)
    assert float((got - want).abs().max()) / scale <= FLASH_TOL
    one = _flash_emulated(q, k, v, window=window, one_pass=True)
    assert float((one - want).abs().max()) / scale > FLASH_TOL


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11),
                      3.0 * 2 ** -11 + 1.0], dtype=torch.float32)
    assert _tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -10),
                                 1.0 + 2 ** -9]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    hi, lo = _split(y)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    assert float(((hi + lo) - y).abs().max() / y.abs().max()) <= 2 ** -21


# ------------------------------------------------- the launch's geometry

@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_flash_launch_fits_one_block_at_every_head_dim(q_dtype, kv_dtype):
    """One CTA of 128 threads per (bh, 64-row q block); the q tile and two
    stages of k and v rows (64, or 32 past hd 128) in rows padded to a
    conflict-free pitch of 16-byte chunks: 2 mod 4 for f32 q and k, odd
    for the others; within one block's 232448 B at every hd 8..256."""
    from repro_torch.kernels.common import SMEM_BUDGET_BYTES, type_name
    from repro_torch.kernels.flash.kernel import (BK, BK_WIDE, BQ, STAGES,
                                                  THREADS, flash_launch)
    for hd in range(8, 257, 8):
        ln = flash_launch(q_dtype, kv_dtype, 6, 1000, 700, hd)
        cls = 64 if hd <= 64 else 128 if hd <= 128 else 256
        assert ln.kernel == (f"flash_fwd_kernel<{type_name(q_dtype)},"
                             f"{type_name(kv_dtype)},{cls}>")
        assert ln.grid == (16, 6, 1) and ln.threads == (THREADS, 1, 1)
        qc, kc = hd * q_dtype.itemsize // 16, hd * kv_dtype.itemsize // 16
        pitches = []
        for c, pairs in ((qc, q_dtype == torch.float32),
                         (kc, kv_dtype == torch.float32), (kc, False)):
            p = min(x for x in range(c, c + 4)
                    if (x % 4 == 2 if pairs else x % 2 == 1))
            pitches.append(p)
        bk = BK_WIDE if hd > 128 else BK
        assert ln.smem == 16 * (BQ * pitches[0]
                                + STAGES * bk * (pitches[1] + pitches[2]))
        assert ln.smem <= SMEM_BUDGET_BYTES
    big = flash_launch(torch.float32, torch.float32, 4, 512, 512, 256)
    assert big.smem == 201728


def test_ptxas_names_of_the_flash_kernels_are_the_declared_ones():
    """The build's ``-Xptxas -v`` report names each flash kernel as
    ``flash_launch`` declares it, bf16 q with bf16 k/v included (the
    repeated type is mangled as a substitution)."""
    from repro_torch.kernels._build import parse_ptxas
    from repro_torch.kernels.flash.kernel import flash_launch
    mangled = ("_ZN40_GLOBAL__N__eb53f0ce_8_flash_cu_c45a2b1816flash_fwd_"
               "kernelI{}Li{}EEEvPKT_PKT0_S7_PS2_lliil")
    codes = {torch.float32: "f", torch.bfloat16: "13__nv_bfloat16"}
    for (q, kv), hd in zip([(torch.float32, torch.float32),
                            (torch.float32, torch.bfloat16),
                            (torch.bfloat16, torch.float32),
                            (torch.bfloat16, torch.bfloat16)],
                           (64, 128, 256, 256)):
        args = codes[q] + ("S1_" if q == kv == torch.bfloat16 else codes[kv])
        log = (f"ptxas info    : Compiling entry function "
               f"'{mangled.format(args, hd)}' for 'sm_90a'\n"
               "ptxas info    : Used 162 registers, used 1 barriers\n")
        (rec,) = parse_ptxas(log)
        assert rec["kernel"] == flash_launch(q, kv, 1, 64, 64, hd).kernel
        assert rec["registers"] == 162
