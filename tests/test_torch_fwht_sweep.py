"""The sweeps of the ``fwht`` kernel and ``panel_step``'s launches, on
the CPU: the schedule that ``csrc/fwht.cu`` runs (its factors, rounds
and register slots, from ``kernels/srht/kernel.py``) applies every stage
once in increasing-h order and, run in Python, gives ``fwht_ref``'s bits;
``srht_sketch`` and ``core.fwht`` go through ``kernels.srht`` (the plain
version on the CPU) and still match the reference; the launch descriptions
follow the C side's constants through the kernel contracts."""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.analysis.kernels import c_constant  # noqa: E402
from repro_torch.core import fwht, srht_sketch  # noqa: E402
from repro_torch.kernels.common import SMEM_BUDGET_BYTES  # noqa: E402
from repro_torch.kernels.panel_step import kernel as pk  # noqa: E402
from repro_torch.kernels.srht import fwht_factors  # noqa: E402
from repro_torch.kernels.srht import kernel as sk  # noqa: E402
from repro_torch.kernels.srht.ref import fwht_ref, srht_ref  # noqa: E402
from torch_ranks import pin_threads  # noqa: E402

pin_threads()

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _plan(m: int):
    """(f_log2, stride, rounds) of every sweep of a length-m transform."""
    out, stride = [], 1
    for f in fwht_factors(m):
        out.append((f, stride, sk.sweep_rounds(f)))
        stride <<= f
    return out


@pytest.mark.parametrize("p", range(21))
def test_fwht_schedule_applies_every_stage_once_in_order(p):
    """m = 2^p: the stages h = stride 2^(P + slot bit) of every round of
    every sweep are 1, 2, 4, ..., m / 2 in that order; in each round the
    (thread, slot) -> tile row map is a bijection, and a slot pair of an
    active bit is a row pair 2^(P + bit) apart."""
    m = 1 << p
    hs = []
    for f, stride, rounds in _plan(m):
        assert f <= sk.MAX_SLAB_LOG2
        rl = min(sk.REG_LOG2, f)
        for P, lo, hi in rounds:
            rows = sk.slot_rows(f, P)
            assert sorted(rows.flatten().tolist()) == list(range(1 << f))
            for sb in range(lo, hi):
                s = torch.arange(1 << rl)
                low = s[(s >> sb) & 1 == 0]
                assert torch.equal(rows[:, low | (1 << sb)] - rows[:, low],
                                   torch.full_like(rows[:, low], 1 << (P + sb)))
                hs.append(stride << (P + sb))
    assert hs == [1 << i for i in range(p)]
    assert len(fwht_factors(m)) == (1 if p == 0 else math.ceil(
        p / sk.MAX_SLAB_LOG2))


def _fwht_model(x: torch.Tensor) -> torch.Tensor:
    """The kernel's schedule in Python: for every sweep, every round
    gathers each thread's slots (``slot_rows``), runs the round's
    butterflies on them and scatters them back; the scale at the end."""
    m = x.shape[0]
    y = x.clone()
    for f, stride, rounds in _plan(m):
        tiles = y.view(m // (stride << f), 1 << f, stride, -1)
        for P, lo, hi in rounds:
            idx = sk.slot_rows(f, P)
            v = tiles[:, idx]                       # (hi, threads, slots, ...)
            for sb in range(lo, hi):
                s = torch.arange(v.shape[2])
                a, b = s[(s >> sb) & 1 == 0], s[(s >> sb) & 1 == 0] | (1 << sb)
                u, w = v[:, :, a], v[:, :, b]
                v[:, :, a], v[:, :, b] = u + w, u - w
            tiles[:, idx] = v
    return y * (1.0 / math.sqrt(m))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64])
@pytest.mark.parametrize("p", [0, 1, 3, 4, 5, 8, 9, 10, 13])
def test_fwht_schedule_model_bit_equal_to_plain(dtype, p):
    gen = torch.Generator().manual_seed(p)
    x = torch.randn((1 << p, 3), generator=gen, dtype=torch.float64)
    if dtype.is_complex:
        x = torch.complex(x, torch.randn(x.shape, generator=gen,
                                         dtype=torch.float64))
    x = x.to(dtype)
    assert torch.equal(_fwht_model(x), fwht_ref(x))


def test_srht_sketch_and_fwht_take_the_ops_path_on_the_cpu():
    """On CPU tensors ``srht_sketch`` and ``core.fwht`` give the plain
    versions' bits, and match the reference's ``srht_sketch`` when given
    its signs and rows (the tolerance of ``test_srht_and_fwht_match_jax``)."""
    from repro.core.sketch import _sample_rows
    from repro.core.sketch import srht_sketch as jax_srht
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        rng = np.random.default_rng(31)
        m, n, l = 300, 40, 24
        a = rng.standard_normal((m, n))
        key = jax.random.PRNGKey(5)
        ksign, krows = jax.random.split(key)
        signs = np.asarray(jax.random.rademacher(ksign, (m,),
                                                 dtype=jnp.float64))
        rows = np.asarray(_sample_rows(krows, 512, l)).astype(np.int64)
        want = np.asarray(jax_srht(key, jnp.asarray(a), l))
        ta, ts, tr = (interop.to_torch(v, device="cpu")
                      for v in (a, signs, rows))
        got = srht_sketch(0, ta, l, signs=ts, rows=tr)
        assert torch.equal(got, srht_ref(ts, ta, tr))
        np.testing.assert_allclose(interop.to_numpy(got), want, atol=1e-12,
                                   rtol=0)
        x = torch.from_numpy(rng.standard_normal((256, 7)))
        assert torch.equal(fwht(x), fwht_ref(x))
    finally:
        jax.config.update("jax_enable_x64", prev)


def test_fwht_launches_follow_the_c_constants():
    """The contract pins the sweep's constants to ``csrc/fwht.cu``; every
    launch of its example is one tile a CTA in that geometry."""
    from repro_torch.kernels.srht.contract import CONTRACT
    for attr, (fname, cname) in CONTRACT.c_constants.items():
        assert getattr(sk, attr) == c_constant(CSRC / fname, cname), attr
    ex = CONTRACT.example()
    factors = fwht_factors(1024)
    assert len(ex.launches) == len(factors)
    for ln, f in zip(ex.launches, factors):
        piece = min(sk.TILE_BYTES >> f, sk.ROW_BYTES)
        rl = min(sk.REG_LOG2, f)
        assert ln.kernel == f"fwht_kernel<float32,{rl},true>"
        assert ln.threads == ((1 << (f - rl)) * piece // 16, 1, 1)
        assert ln.threads_per_block <= sk.THREADS
        assert ln.smem == ((1 << f) * piece
                           if len(sk.sweep_rounds(f)) > 1 else 0)
        assert ln.grid[0] == -(-512 // (piece // 4))
    # the main shape: two sweeps of 2^8 rows x 256 bytes, 64 KB a tile
    main = [sk.fwht_pass_launch(torch.float64, 2 ** 16, 2 ** 14, f, 1, 1.0)
            for f in fwht_factors(2 ** 16)]
    assert [(ln.grid, ln.threads, ln.smem) for ln in main] == [
        ((512, 256, 1), (256, 1, 1), 65536)] * 2


def test_panel_step_launches_follow_the_c_constants():
    """The factor keeps the main panel resident; the sweep is one C entry
    that issues panel_gram's pass and panel_apply's kernel; the contract
    pins the constants to ``csrc/panel_step.cu``."""
    from repro_torch.kernels.panel_gram.kernel import panel_gram_launch
    from repro_torch.kernels.panel_step.contract import CONTRACT
    for attr, (fname, cname) in CONTRACT.c_constants.items():
        assert getattr(pk, attr) == c_constant(CSRC / fname, cname), attr
    f64, c128 = torch.float64, torch.complex128
    fac, gram, apply = pk.step_launches(f64, 800, 32, 2 ** 14)
    assert fac.kernel == "panel_factor_kernel<float64,true>"
    assert fac.smem == 8 * (800 * 34 + 32 * 33 + 32) + 8 * 32
    assert (gram.grid, gram.threads, gram.smem) == (
        panel_gram_launch(f64, 800, 32, 2 ** 14).grid,
        panel_gram_launch(f64, 800, 32, 2 ** 14).threads,
        panel_gram_launch(f64, 800, 32, 2 ** 14).smem)
    assert apply.kernel == pk.apply_launch(f64, 800, 32, 2 ** 14).kernel
    assert {ln.entry for ln in (gram, apply)} == {"repro_panel_sweep"}
    assert [(ln.part, ln.parts) for ln in (gram, apply)] == [(0, 2), (1, 2)]
    assert all(ln.smem <= SMEM_BUDGET_BYTES for ln in (fac, gram, apply))
    # c128 at l = 800 and f64 at b = 64: the factor re-reads its panel
    assert not pk.factor_resident(c128, 800, 32)
    assert not pk.factor_resident(f64, 800, 64)
    assert pk.factor_resident(torch.float32, 800, 64)
    assert pk.step_launches(f64, 800, 32, 0) == (fac,)
    assert CONTRACT.example().launches == pk.step_launches(
        torch.float32, 256, 32, 4096)
