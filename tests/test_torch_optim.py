"""The port's optimizer stack (``repro_torch.optim``) against the JAX
reference's, on the CPU, and the reference's own properties mirrored.

Same numpy inputs on both sides; for ``_block_compress`` the same Omega
(the port draws its own from Philox, so it is injected).  Tolerances,
relative to the largest entry of the reference's array: 1e-6 for the
elementwise AdamW, clipping and schedule arithmetic (f32 on both sides, a
rounding or two apart), 1e-5 for the CholeskyQR2 basis and the compressed
block (f32 GEMMs and a Cholesky in another order).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro_torch.optim import (CompressorConfig, adamw_init,  # noqa: E402
                               adamw_update, clip_by_global_norm,
                               compress_grads, constant, ef_init,
                               global_norm, warmup_cosine)
from repro_torch.optim import compress as tcompress  # noqa: E402
from torch_ranks import pin_threads  # noqa: E402

pin_threads()


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, f"max |got - want| = {err} > {tol} * {scale}"


def _tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"w": (16, 12), "b": (12,), "e": (5, 3, 4)}


def test_adamw_update_matches_the_reference():
    """Three steps at a traced lr, every leaf decayed; moments and count."""
    p0 = _tree(0, SHAPES)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jst, tst = jadamw.adamw_init(jp), adamw_init(tp)
    for step in range(3):
        g = _tree(10 + step, SHAPES)
        lr = 1e-2 * (step + 1)
        jp, jst = jadamw.adamw_update({k: jnp.asarray(v) for k, v in
                                       g.items()}, jst, jp,
                                      lr=jnp.float32(lr), weight_decay=0.1)
        tp, tst = adamw_update({k: torch.from_numpy(v) for k, v in
                                g.items()}, tst, tp,
                               lr=torch.tensor(lr), weight_decay=0.1)
    assert int(tst.count) == int(jst.count) == 3
    for k in SHAPES:
        _close(tp[k], jp[k], 1e-6)
        _close(tst.mu[k], jst.mu[k], 1e-6)
        _close(tst.nu[k], jst.nu[k], 1e-6)


def test_clip_by_global_norm_matches_the_reference():
    for scale in (0.1, 10.0):                  # under and over max_norm
        g = {k: v * scale for k, v in _tree(4, SHAPES).items()}
        jg, jn = jadamw.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
        tg, tn = clip_by_global_norm(
            {k: torch.from_numpy(v.copy()) for k, v in g.items()}, 1.0)
        _close(tn, jn, 1e-6)
        for k in SHAPES:
            _close(tg[k], jg[k], 1e-6)
        _close(global_norm(tg), jadamw.global_norm(jg), 1e-6)


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (3, 3)])
def test_schedules_match_the_reference(warmup, total):
    for s in range(total + 5):
        want = jschedule.warmup_cosine(jnp.asarray(s), peak_lr=2e-3,
                                       warmup_steps=warmup, total_steps=total)
        got = warmup_cosine(torch.tensor(s), peak_lr=2e-3,
                            warmup_steps=warmup, total_steps=total)
        assert got.dtype == torch.float32
        _close(got, want, 1e-6)
    assert float(constant(torch.tensor(7), peak_lr=0.5)) == float(
        jschedule.constant(jnp.asarray(7), peak_lr=0.5))


@pytest.mark.parametrize("m,r,zero", [(64, 8, False), (40, 3, False),
                                      (32, 4, True)])
def test_ridged_orth_matches_the_reference(m, r, zero):
    """The CholeskyQR2 basis, on a random sketch and on an all-zero one
    (finite, the ridge's case)."""
    W = np.zeros((m, r), np.float32) if zero else \
        np.random.default_rng(m).standard_normal((m, r)).astype(np.float32)
    got = tcompress._ridged_orth(torch.from_numpy(W))
    want = jcompress._ridged_orth(jnp.asarray(W))
    assert torch.isfinite(got).all()
    _close(got, want, 1e-5)
    if not zero:
        torch.testing.assert_close(got.T @ got, torch.eye(r), atol=1e-5,
                                   rtol=0)


def test_block_compress_matches_the_reference_on_one_omega():
    rng = np.random.default_rng(5)
    g = rng.standard_normal((2, 48, 40)).astype(np.float32)
    e = rng.standard_normal((2, 48, 40)).astype(np.float32) * 0.1
    omega = rng.standard_normal((6, 40)).astype(np.float32) * 40 ** -0.5
    jh, je = jcompress._block_compress(jnp.asarray(g), jnp.asarray(e),
                                       jnp.asarray(omega), 6)
    th, te = tcompress._block_compress(torch.from_numpy(g),
                                       torch.from_numpy(e),
                                       torch.from_numpy(omega), 6)
    _close(th, jh, 1e-5)
    _close(te, je, 1e-5)


# ------------------------------------------ the reference's properties

def test_compress_exact_on_low_rank():
    """A gradient of rank <= r comes back exactly and the EF buffer stays
    near 0."""
    ccfg = CompressorConfig(rank=8, min_dim=16, min_numel=64)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 8))
                         .astype(np.float32)) @ torch.from_numpy(
        np.random.default_rng(1).standard_normal((8, 48)).astype(np.float32))
    ef = ef_init({"w": g}, ccfg, npods=2)
    out, ef2, stats = compress_grads(0, {"w": torch.stack([g, g])}, ef, ccfg)
    torch.testing.assert_close(out["w"], g, atol=1e-4, rtol=0)
    assert float(ef2["w"].abs().max()) < 1e-4
    assert stats["ratio"] < 0.5


def test_compress_error_feedback_accumulates():
    """EF holds exactly the residual g_p - g_hat of each pod."""
    ccfg = CompressorConfig(rank=2, min_dim=8, min_numel=32)
    g = torch.randn((2, 32, 24), generator=torch.Generator().manual_seed(0))
    ef = ef_init({"w": g[0]}, ccfg, npods=2)
    out, ef2, _ = compress_grads(0, {"w": g}, ef, ccfg)
    torch.testing.assert_close(ef2["w"], g - out["w"][None], atol=1e-5,
                               rtol=0)


def test_compress_skips_small_leaves():
    ccfg = CompressorConfig(rank=4, min_dim=128, min_numel=1 << 16)
    grads = {"small": torch.ones((2, 8, 8)), "vec": torch.ones((2, 100))}
    ef = ef_init({"small": torch.ones((8, 8)), "vec": torch.ones(100)},
                 ccfg, npods=2)
    assert all(e.dim() == 0 for e in ef.values())
    out, _, stats = compress_grads(0, grads, ef, ccfg)
    assert torch.equal(out["small"], torch.ones((8, 8)))
    assert stats["dense_bytes"] == 0


def test_compressed_sgd_converges():
    """EF-compressed two-pod SGD solves least squares to the dense
    solution (the PowerSGD property, the paper's range finder as the
    factorizer)."""
    ccfg = CompressorConfig(rank=2, min_dim=4, min_numel=16)
    gen = torch.Generator().manual_seed(0)
    X = torch.randn((256, 16), generator=gen)
    W_true = torch.randn((16, 12), generator=gen)
    Y = X @ W_true
    W = torch.zeros((16, 12))
    ef = ef_init({"w": W}, ccfg, npods=2)

    def grad_of(rows):
        Xb, Yb = X[rows], Y[rows]
        return Xb.T @ (Xb @ W - Yb) / Xb.shape[0]

    for step in range(300):
        g = torch.stack([grad_of(slice(0, 128)), grad_of(slice(128, 256))])
        out, ef, _ = compress_grads(step, {"w": g}, ef, ccfg)
        W = W - 0.05 * out["w"]
    assert float(torch.linalg.norm(W - W_true)
                 / torch.linalg.norm(W_true)) < 1e-2


def test_rank1_update_is_exact_and_layers_share_omega():
    """A rank-1 block comes back exactly at rank 1; two layers of one
    stacked name draw the same Omega (the reference stacks them into one
    leaf), so equal gradients give equal results."""
    ccfg = CompressorConfig(rank=1, min_dim=4, min_numel=16)
    gen = torch.Generator().manual_seed(2)
    g = torch.randn((32, 1), generator=gen) @ torch.randn((1, 24),
                                                           generator=gen)
    grads = {f"blocks.{i}.mixer.wq": torch.stack([g, g]) for i in range(2)}
    ef = ef_init({k: g for k in grads}, ccfg, 2)
    out, _, _ = compress_grads(3, grads, ef, ccfg)
    torch.testing.assert_close(out["blocks.0.mixer.wq"], g, atol=1e-5,
                               rtol=0)
    assert torch.equal(out["blocks.0.mixer.wq"], out["blocks.1.mixer.wq"])
