"""The blocked engine's eq. (3) readings on exact-rank draws, held to the
JAX reference's engines on the same sketch, on the CPU.

``bench_error.eq3_witness`` runs ``WITNESS_CASES`` through the port's
CGS2 oracle and blocked engine (panels 8, 16, 32); here the same CPU-made
``A`` and sketch go through the reference's ``rid_from_sketch`` with the
same engines.  Both packages must pick the same pivots in the same order
and measure errors of the same size, and CGS2 must hold the bound on
both.  "The same size" is within a factor of 8: the errors are rounding
left over after the blocked engine's panels lose orthogonality, so two
arithmetics of the same pivots differ by up to 3.5x here.  Run with
``-s`` to print the ratios side by side.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.benchmarks import bench_error  # noqa: E402
from torch_ranks import pin_threads  # noqa: E402

pin_threads()


@pytest.fixture(autouse=True, scope="module")
def _x64_scope():
    """f64 and one torch thread (small matrices; a loaded host) for this
    module only, restored afterwards."""
    prev, threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_enable_x64", prev)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", bench_error.WITNESS_CASES,
                         ids=lambda c: "m{}-n{}-k{}-s{}".format(*c))
def test_blocked_engine_reading_follows_the_reference(case):
    from repro.core import rid_from_sketch
    m, n, k, seed = case
    rows = bench_error.eq3_witness([case], device="cpu")
    A, Y = bench_error.witness_inputs(m, n, k, seed)
    An = A.numpy()
    assert [(r["impl"], r["panel"]) for r in rows] == list(
        bench_error.ATTRIBUTION_ENGINES)
    for row in rows:
        dec = rid_from_sketch(jnp.asarray(An), jnp.asarray(Y.numpy()), k,
                              qr_impl=row["impl"],
                              qr_panel=row["panel"] or 32)
        J = np.asarray(dec.J)
        err = bench_error.two_norm(torch.from_numpy(
            An - An[:, J] @ np.asarray(dec.P)))
        ratio = err / row["eq3_bound"]
        print(f"{case} {row['impl']} {row['panel']}: port {row['ratio']:.4g}"
              f" reference {ratio:.4g}")
        assert bench_error.j_digest(J) == row["j_sha256"], row
        assert max(ratio, row["ratio"]) <= 8 * min(ratio, row["ratio"]), (
            ratio, row)
        if row["impl"] == "cgs2":
            assert max(ratio, row["ratio"]) <= 1, (ratio, row)
