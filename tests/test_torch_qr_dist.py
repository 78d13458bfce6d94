"""The port's distributed randomized ID (``repro_torch.core.qr_dist`` /
``distributed``) and its three kernel packages (``panel_coeff``,
``panel_apply``, ``panel_gram``), on the CPU.

* The plain versions of the kernels against the JAX ops (Pallas in
  interpret mode for real dtypes, the jnp oracles for complex ones).
* The panel-parallel QR against JAX's on an in-process one-device mesh.
* World sizes 1, 2 and 4 over gloo: the same pivots and ``Q``, bitwise
  identical on every rank of a world.
* ``rid_distributed`` against the port's single-device ``rid``, and
  eq. (3).
* The validation messages of ``tests/test_qr_dist.py``.

Ranks run as subprocesses (``RANK_PROGRAM``), each with its own timeout
and a ``file://`` store under a temporary directory; this process never
joins a process group.  Inputs are made with a seeded numpy generator and
cross as ``.npy`` files.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import (error_bound, panel_parallel_pivoted_qr,  # noqa: E402
                              rid, rid_distributed, shard_columns)
from repro_torch.kernels.panel_gram import panel_gram  # noqa: E402
from repro_torch.kernels.panel_step import (panel_apply,  # noqa: E402
                                            panel_coeff, panel_step)
from torch_ranks import failures, pin_threads, run_ranks  # noqa: E402

pin_threads()

DTYPES = ["float32", "float64", "complex64", "complex128"]
# Relative to each output's largest entry, as for panel_step in
# test_torch_kernels.py: both sides factor and sum in the working precision
# in different orders.
KTOL = {"float32": 1e-4, "complex64": 1e-4,
        "float64": 1e-11, "complex128": 1e-11}
# Q and R of the QR engines against JAX (as in test_torch_qr.py).
QR_TOL = 1e-9
# The same engine at another world size: a column of the residual is
# deflated by GEMMs of other widths, so factors agree to rounding.
WORLD_TOL = 1e-12
RANK_TIMEOUT = 120          # seconds per rank process


def _t(x):
    """numpy -> torch on the CPU, dtype kept."""
    return interop.to_torch(x, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _x64_scope():
    """f64 for this module only, restored afterwards."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _rand(rng, shape, dtype):
    dt = np.dtype(dtype)
    if dt.kind == "c":
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(dt)
    return rng.standard_normal(shape).astype(dt)


def _close(got, want, dtype, name=""):
    g, w = interop.to_numpy(got), np.asarray(want)
    assert g.shape == w.shape, name
    scale = max(np.abs(w).max(), 1.0)
    np.testing.assert_allclose(g, w, atol=KTOL[dtype] * scale, rtol=0,
                               err_msg=name)


def _norms2(z):
    return (np.abs(z) ** 2).sum(0).astype(np.finfo(z.dtype).dtype)


# ------------------------------------------------ plain versions vs JAX

@pytest.mark.parametrize("n", [400, 333])
@pytest.mark.parametrize("dtype", DTYPES)
def test_panel_coeff_matches_jax(dtype, n):
    """Factor, ``W`` and the downdated norms (picked columns at the -1
    sentinel clamp to 0), at l=48, b=7, a ragged n included."""
    from repro.kernels.panel_step import panel_coeff as jax_coeff
    rng = np.random.default_rng(30)
    c, z = _rand(rng, (48, 7), dtype), _rand(rng, (48, n), dtype)
    r2 = _norms2(z)
    r2[::9] = -1.0
    want = jax_coeff(jnp.asarray(c), jnp.asarray(z), jnp.asarray(r2))
    got = panel_coeff(_t(c), _t(z), _t(r2))
    for name, g, w in zip(("qp", "w", "r2"), got, want):
        _close(g, w, dtype, name)
    assert got[2].dtype == _t(r2).dtype and bool((got[2][::9] == 0).all())


@pytest.mark.parametrize("emit_norms", [False, True])
@pytest.mark.parametrize("n", [400, 333])
@pytest.mark.parametrize("dtype", DTYPES)
def test_panel_apply_matches_jax(dtype, n, emit_norms):
    from repro.kernels.panel_step import panel_apply as jax_apply
    rng = np.random.default_rng(31)
    qp, w, z = (_rand(rng, s, dtype) for s in ((48, 7), (7, n), (48, n)))
    want = jax_apply(jnp.asarray(qp), jnp.asarray(w), jnp.asarray(z),
                     emit_norms=emit_norms)
    got = panel_apply(_t(qp), _t(w), _t(z), emit_norms=emit_norms)
    if emit_norms:
        _close(got[0], want[0], dtype, "o")
        _close(got[1], want[1], dtype, "r2")
        assert not got[1].is_complex()
    else:
        _close(got, want, dtype, "o")


@pytest.mark.parametrize("n", [400, 333])
@pytest.mark.parametrize("dtype", DTYPES)
def test_panel_gram_matches_jax(dtype, n):
    from repro.kernels.panel_gram import panel_gram as jax_gram
    rng = np.random.default_rng(32)
    c, z = _rand(rng, (48, 7), dtype), _rand(rng, (48, n), dtype)
    want = jax_gram(jnp.asarray(c), jnp.asarray(z))
    got = panel_gram(_t(c), _t(z))
    _close(got[0], want[0], dtype, "G")
    _close(got[1], want[1], dtype, "V")


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_panel_composes_to_panel_step(dtype):
    """``panel_coeff`` then ``panel_apply(emit_norms=True)`` is
    ``panel_step``: the same factor, W, deflation and norms."""
    rng = np.random.default_rng(33)
    c, z = _t(_rand(rng, (40, 6), dtype)), _t(_rand(rng, (40, 90), dtype))
    qp, w, _ = panel_coeff(c, z, _t(_norms2(interop.to_numpy(z))))
    o, r2 = panel_apply(qp, w, z, emit_norms=True)
    for g, s in zip((qp, o, w, r2), panel_step(c, z)):
        assert torch.equal(g, s)


def test_split_ops_eager_validation():
    with pytest.raises(ValueError, match=r"c rows \(8\) must match z rows "
                                         r"\(9\)"):
        panel_coeff(torch.ones(8, 2), torch.ones(9, 4), torch.ones(4))
    with pytest.raises(ValueError, match=r"res2 shape \(3,\) must be \(4,\)"):
        panel_coeff(torch.ones(8, 2), torch.ones(8, 4), torch.ones(3))
    with pytest.raises(ValueError, match=r"w shape \(2, 5\) must be \(2, 4\)"):
        panel_apply(torch.ones(8, 2), torch.ones(2, 5), torch.ones(8, 4))
    with pytest.raises(ValueError, match=r"c rows \(8\) must match z rows "
                                         r"\(7\)"):
        panel_gram(torch.ones(8, 2), torch.ones(7, 4))


def test_split_ops_take_the_plain_version_on_the_cpu():
    """CPU tensors never reach a kernel, and the raw wrappers refuse
    them."""
    from repro_torch.kernels.panel_gram.kernel import LAUNCHES as LG
    from repro_torch.kernels.panel_gram.kernel import panel_gram_kernel
    from repro_torch.kernels.panel_step.kernel import (APPLY_LAUNCHES,
                                                       COEFF_LAUNCHES,
                                                       panel_apply_kernel,
                                                       panel_coeff_kernel)
    before = (COEFF_LAUNCHES.count, APPLY_LAUNCHES.count, LG.count)
    c, z = torch.randn(16, 4, dtype=torch.float64), torch.randn(16, 10, dtype=torch.float64)
    qp, w, _ = panel_coeff(c, z, torch.ones(10, dtype=torch.float64))
    panel_apply(qp, w, z, emit_norms=True)
    panel_gram(c, z)
    assert (COEFF_LAUNCHES.count, APPLY_LAUNCHES.count, LG.count) == before
    with pytest.raises(ValueError, match="CUDA"):
        panel_coeff_kernel(c, z, torch.ones(10, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        panel_apply_kernel(qp, w, z)
    with pytest.raises(ValueError, match="CUDA"):
        panel_gram_kernel(c, z)


def test_entry_points_need_a_process_group():
    """No group is created quietly: ``group`` must be a ProcessGroup."""
    Y = torch.zeros(8, 16, dtype=torch.float64)
    with pytest.raises(TypeError, match="ProcessGroup, got NoneType"):
        panel_parallel_pivoted_qr(Y, 4, group=None)
    with pytest.raises(TypeError, match="ProcessGroup, got str"):
        rid_distributed(0, Y, 4, group="world")
    with pytest.raises(TypeError, match="ProcessGroup"):
        shard_columns(Y, None)


# ------------------------------------------------------------ the ranks

RANK_PROGRAM = r"""
import datetime, json, sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist

rank, world, work = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=(work / "store").as_uri(),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.core import (panel_parallel_pivoted_qr,
                              panel_parallel_qr_local, rid_distributed,
                              shard_columns)
g = dist.group.WORLD
data = work.parent
spec = json.loads((data / "spec.json").read_text())
out = {}
for name, case in spec["qr"].items():
    Y = torch.from_numpy(np.load(data / case["Y"]))
    res = panel_parallel_pivoted_qr(
        shard_columns(Y, g), case["k"], group=g, panel=case["panel"],
        panel_impl=case["impl"], norm_recompute=case["norm_recompute"])
    out[name + "/Q"], out[name + "/piv"] = res.Q.numpy(), res.piv.numpy()
    out[name + "/R"] = res.R.numpy()
for name, case in spec["rid"].items():
    A = torch.from_numpy(np.load(data / case["A"]))
    dec = rid_distributed(case["seed"], shard_columns(A, g), case["k"],
                          group=g, qr_impl=case["qr_impl"],
                          qr_panel=case["qr_panel"])
    out[name + "/J"], out[name + "/P"] = dec.J.numpy(), dec.P.numpy()
    out[name + "/B"], out[name + "/Q"] = dec.B.numpy(), dec.Q.numpy()
np.savez(work / f"rank{rank}.npz", **out)

msgs = {}
def expect(name, fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        msgs[name] = f"{type(e).__name__}: {e}"
    else:
        msgs[name] = None
z = lambda *s: torch.zeros(*s, dtype=torch.float64)
if world == 1:
    expect("rid_l_ge_k", lambda: rid_distributed(0, z(32, 16), 8, l=4, group=g))
    expect("rid_k_le_min", lambda: rid_distributed(0, z(32, 6), 8, group=g))
    expect("rid_qr_impl", lambda: rid_distributed(0, z(32, 16), 4, group=g,
                                                  qr_impl="nope"))
    expect("rid_qr_panel", lambda: rid_distributed(
        0, z(32, 16), 4, group=g, qr_impl="panel_parallel", qr_panel=0))
    expect("rid_norm_recompute", lambda: rid_distributed(
        0, z(32, 16), 4, group=g, qr_impl="panel_parallel",
        qr_norm_recompute=-3))
    Y_loc = z(16, 8)
    for key, kw in [("k", dict(k=40)), ("panel", dict(k=4, panel=0)),
                    ("impl", dict(k=4, panel_impl="split")),
                    ("recompute_str", dict(k=4, norm_recompute="always")),
                    ("recompute_neg", dict(k=4, norm_recompute=-1))]:
        expect("local_" + key,
               lambda kw=kw: panel_parallel_qr_local(Y_loc, group=g, **kw))
    Y = z(16, 24)
    for key, kw in [("k", dict(k=0)), ("panel", dict(k=4, panel=-2)),
                    ("impl", dict(k=4, panel_impl="nope")),
                    ("recompute", dict(k=4, norm_recompute="n"))]:
        expect("ppqr_" + key,
               lambda kw=kw: panel_parallel_pivoted_qr(Y, group=g, **kw))
if world == 4:
    expect("shard_uneven", lambda: shard_columns(z(64, 102), g))
    expect("rid_uneven", lambda: rid_distributed(
        0, z(64, 25 + (rank == 3)), 4, group=g, qr_impl="panel_parallel"))
    expect("rid_unequal", lambda: rid_distributed(
        0, z(64, 24 + 2 * (rank % 2)), 4, group=g))
(work / f"msgs{rank}.json").write_text(json.dumps(msgs))
dist.destroy_process_group()
"""

WORLDS = (1, 2, 4)
QR_K, QR_PANEL = 21, 7                 # 3 panels of 7
QR_VARIANTS = {"fused": ("fused", "auto"), "gram": ("gram", "auto"),
               "fused_recompute": ("fused", 2)}   # panel 2 recomputes
QR_DTYPES = ["float64", "complex128"]
RID_M, RID_N, RID_K, RID_PANEL, RID_SEED = 128, 240, 12, 5, 3


def _sketch_like(rng, l, n, dtype):
    """A generic (l, n) matrix whose column norms are spread log-uniformly
    over two decades, so greedy pivot choices are separated by far more
    than rounding (as in test_torch_qr.py)."""
    return (_rand(rng, (l, n), dtype)
            * np.logspace(0, 2, n)[rng.permutation(n)]).astype(dtype)


def _rid_matrix():
    """Rank-24 A (m x n) with column scales spread over two decades."""
    rng = np.random.default_rng(41)
    B0 = rng.standard_normal((RID_M, 24))
    P0 = rng.standard_normal((24, RID_N)) * \
        np.logspace(0, 2, RID_N)[rng.permutation(RID_N)]
    return B0 @ P0


def _qr_input(dtype):
    return _sketch_like(np.random.default_rng(40), 48, 400, dtype)


def _qr_duplicate_input():
    """Every column twice: the top-b candidates come in equal pairs, so
    the first panel is degenerate and takes the Householder fallback."""
    X = _sketch_like(np.random.default_rng(42), 48, 100, "float64")
    return np.concatenate([X, X], axis=1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Runs worlds 1, 2 and 4 once and
    returns ``{world: [per-rank arrays]}`` and ``{world: [per-rank
    messages]}``."""
    data = tmp_path_factory.mktemp("qr_dist")
    spec = {"qr": {}, "rid": {}}
    for dtype in QR_DTYPES:
        np.save(data / f"Y_{dtype}.npy", _qr_input(dtype))
        for variant, (impl, recompute) in QR_VARIANTS.items():
            spec["qr"][f"{dtype}_{variant}"] = dict(
                Y=f"Y_{dtype}.npy", k=QR_K, panel=QR_PANEL, impl=impl,
                norm_recompute=recompute)
    np.save(data / "Y_dup.npy", _qr_duplicate_input())
    spec["qr"]["duplicate"] = dict(Y="Y_dup.npy", k=QR_K, panel=QR_PANEL,
                                   impl="fused", norm_recompute="auto")
    np.save(data / "A.npy", _rid_matrix())
    for qr_impl in ("panel_parallel", "blocked"):
        spec["rid"][qr_impl] = dict(A="A.npy", seed=RID_SEED, k=RID_K,
                                    qr_impl=qr_impl, qr_panel=RID_PANEL)
    (data / "spec.json").write_text(json.dumps(spec))
    for w in WORLDS:
        (data / f"world{w}").mkdir()
    errors = run_worlds(data)
    assert not errors, errors
    arrays = {w: [dict(np.load(data / f"world{w}" / f"rank{r}.npz"))
                  for r in range(w)] for w in WORLDS}
    msgs = {w: [json.loads((data / f"world{w}" / f"msgs{r}.json").read_text())
                for r in range(w)] for w in WORLDS}
    return arrays, msgs


def run_worlds(data: Path) -> str:
    """RANK_PROGRAM at every world size of WORLDS, one after another, on
    the inputs under ``data``; the failures, or ''."""
    return "\n".join(
        f"world {w}: {err}" for w in WORLDS
        if (err := failures(run_ranks(RANK_PROGRAM, w, str(data / f"world{w}"),
                                      timeout=RANK_TIMEOUT,
                                      OMP_NUM_THREADS="1"))))


def _same_on_every_rank(per_rank: list, key: str) -> np.ndarray:
    first = per_rank[0][key]
    for r, arrs in enumerate(per_rank[1:], 1):
        assert arrs[key].tobytes() == first.tobytes(), (key, r)
    return first


def _jax_mesh():
    from repro.compat import AxisType, make_mesh
    return make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))


@pytest.mark.parametrize("variant", list(QR_VARIANTS))
@pytest.mark.parametrize("dtype", QR_DTYPES)
def test_panel_parallel_qr_matches_jax(ranks, dtype, variant):
    """The port on one rank against JAX's ``panel_parallel_pivoted_qr`` on
    a one-device mesh: pivots equal in order, ``Q`` and ``R`` within
    QR_TOL (of the sketch's largest entry for ``R``)."""
    from repro.core import panel_parallel_pivoted_qr as jax_ppqr
    impl, recompute = QR_VARIANTS[variant]
    Y = _qr_input(dtype)
    want = jax_ppqr(jnp.asarray(Y), QR_K, mesh=_jax_mesh(), panel=QR_PANEL,
                    panel_impl=impl, norm_recompute=recompute)
    got = ranks[0][1][0]
    name = f"{dtype}_{variant}"
    np.testing.assert_array_equal(got[name + "/piv"], np.asarray(want.piv))
    np.testing.assert_allclose(got[name + "/Q"], np.asarray(want.Q),
                               atol=QR_TOL, rtol=0)
    np.testing.assert_allclose(got[name + "/R"], np.asarray(want.R),
                               atol=QR_TOL * np.abs(Y).max(), rtol=0)


@pytest.mark.parametrize("variant", list(QR_VARIANTS))
@pytest.mark.parametrize("dtype", QR_DTYPES)
def test_world_sizes_agree(ranks, dtype, variant):
    """Worlds 1, 2 and 4 pick the same pivots and the same ``Q``; within a
    world, ``Q`` and ``piv`` are bitwise identical on every rank, and the
    ranks' ``R`` blocks make up the one-rank ``R``."""
    arrays = ranks[0]
    name = f"{dtype}_{variant}"
    piv1 = _same_on_every_rank(arrays[1], name + "/piv")
    Q1 = _same_on_every_rank(arrays[1], name + "/Q")
    R1 = arrays[1][0][name + "/R"]
    for w in WORLDS[1:]:
        np.testing.assert_array_equal(
            _same_on_every_rank(arrays[w], name + "/piv"), piv1)
        np.testing.assert_allclose(
            _same_on_every_rank(arrays[w], name + "/Q"), Q1,
            atol=WORLD_TOL, rtol=0)
        R = np.concatenate([a[name + "/R"] for a in arrays[w]], axis=1)
        np.testing.assert_allclose(R, R1, atol=WORLD_TOL * np.abs(R1).max(),
                                   rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_degenerate_panel_falls_back_alike_on_every_rank(ranks, world):
    """Duplicate columns make degenerate panels: the Householder fallback
    gives each panel an orthonormal block (the factor of the kernel would
    have a zero column there), finite and bitwise identical on every rank,
    with distinct pivots.  As in the reference, the fallback's completion
    of the junk directions is orthonormal within its panel only, and ties
    between the copies may break otherwise than in JAX, so neither the
    whole ``Q`` nor the pivots are compared with JAX here."""
    arrays = ranks[0][world]
    Q = _same_on_every_rank(arrays, "duplicate/Q")
    piv = _same_on_every_rank(arrays, "duplicate/piv")
    assert len(set(piv.tolist())) == QR_K
    for p0 in range(0, QR_K, QR_PANEL):
        blk = Q[:, p0:p0 + QR_PANEL]
        assert np.abs(blk.T @ blk - np.eye(blk.shape[1])).max() < 1e-12
    assert np.isfinite(Q).all() and np.isfinite(arrays[0]["duplicate/R"]).all()


@pytest.mark.parametrize("qr_impl", ["panel_parallel", "blocked"])
@pytest.mark.parametrize("world", [2, 4])
def test_rid_distributed_matches_single_device_rid(ranks, world, qr_impl):
    """``rid_distributed`` against the port's single-device ``rid`` with
    the same seed: equal pivot sets, ``B = A[:, J]`` exactly,
    ``P[:, J] = I`` exactly, ``P`` within 1e-8 of its largest entry (the
    ranks sketch their own column blocks, so the sketches agree to
    rounding), and the paper's eq. (3) with the exact sigma_{k+1}."""
    A = _rid_matrix()
    arrays = ranks[0][world]
    J = _same_on_every_rank(arrays, qr_impl + "/J")
    B = _same_on_every_rank(arrays, qr_impl + "/B")
    _same_on_every_rank(arrays, qr_impl + "/Q")
    P = np.concatenate([a[qr_impl + "/P"] for a in arrays], axis=1)
    want = rid(RID_SEED, _t(A), RID_K, sketch_kind="gaussian",
               qr_impl="blocked", qr_panel=RID_PANEL)
    wJ, wP = interop.to_numpy(want.J), interop.to_numpy(want.P)
    assert set(J.tolist()) == set(wJ.tolist()) and len(set(J.tolist())) == RID_K
    np.testing.assert_array_equal(B, A[:, J])
    np.testing.assert_array_equal(P[:, J], np.eye(RID_K))
    go, wo = np.argsort(J), np.argsort(wJ)
    np.testing.assert_allclose(P[go], wP[wo], atol=1e-8 * np.abs(wP).max(),
                               rtol=0)
    sigma = np.linalg.svd(A, compute_uv=False)
    err = np.linalg.norm(A - B @ P, 2)
    assert err <= error_bound(RID_M, RID_N, RID_K) * sigma[RID_K]


# ----------------------------------------- validation (tests/test_qr_dist.py)

def _msg(ranks, world, name):
    per_rank = [m[name] for m in ranks[1][world]]
    assert all(m == per_rank[0] for m in per_rank), per_rank
    assert per_rank[0] is not None, f"{name}: nothing raised"
    return per_rank[0]


def test_rid_distributed_validates_l_ge_k(ranks):
    assert "need l >= k" in _msg(ranks, 1, "rid_l_ge_k")


def test_rid_distributed_validates_k_le_min_l_n(ranks):
    assert "need 0 < k <= min" in _msg(ranks, 1, "rid_k_le_min")


def test_rid_distributed_validates_qr_impl(ranks):
    assert "unknown qr impl" in _msg(ranks, 1, "rid_qr_impl")


def test_rid_distributed_validates_qr_panel(ranks):
    assert "need qr_panel >= 1" in _msg(ranks, 1, "rid_qr_panel")


def test_rid_distributed_validates_norm_recompute(ranks):
    import re
    assert re.search("norm_recompute.*got -3",
                     _msg(ranks, 1, "rid_norm_recompute"))


@pytest.mark.parametrize("name,pattern", [
    ("local_k", r"need 0 < k <= min\(l, n\); got k=40"),
    ("local_panel", "need panel >= 1, got panel=0"),
    ("local_impl", "unknown panel_impl 'split'; expected"),
    ("local_recompute_str", "unknown norm_recompute 'always'"),
    ("local_recompute_neg", r"need norm_recompute >= 0 \(or 'auto'\), "
                            r"got -1"),
])
def test_qr_local_validation_messages(ranks, name, pattern):
    """Every eager check of panel_parallel_qr_local names the argument and
    the value received."""
    import re
    assert re.search(pattern, _msg(ranks, 1, name))


@pytest.mark.parametrize("name,pattern", [
    ("ppqr_k", r"need 0 < k <= min\(l, n\); got k=0"),
    ("ppqr_panel", "need panel >= 1, got panel=-2"),
    ("ppqr_impl", "unknown panel_impl 'nope'"),
    ("ppqr_recompute", "unknown norm_recompute 'n'"),
])
def test_panel_parallel_pivoted_qr_validation_messages(ranks, name, pattern):
    import re
    assert re.search(pattern, _msg(ranks, 1, name))


def test_uneven_shard_raises(ranks):
    """n not divisible by the group raises before any factorization, on
    every rank alike; so do equal totals split unequally."""
    assert "n=102 must divide the 'ranks' axis (4 devices)" in \
        _msg(ranks, 4, "shard_uneven")
    assert "n=101 must divide" in _msg(ranks, 4, "rid_uneven")
    assert "column shards must be equal, got n_loc=[24, 26, 24, 26]" in \
        _msg(ranks, 4, "rid_unequal")
