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
