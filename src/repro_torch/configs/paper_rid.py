"""The paper's own benchmark grid (Tables 1-5), the port's copy of
``repro.configs.paper_rid``: randomized interpolative
decomposition of complex Gaussian low-rank matrices on the Cray XMT.

Each entry is (k, m, n) with l = 2k everywhere ("For all runs, take
l = 2k").  Matrices are A = B P with B, P complex Gaussian — "almost no
exploitable structure, other than their rank".  The largest runs are
~2^14 x 2^18 complex128 = 64 GB, matching the abstract.
"""
from typing import NamedTuple


class RIDCase(NamedTuple):
    k: int
    m: int
    n: int

    @property
    def l(self) -> int:          # noqa: E743  (paper's own symbol)
        return 2 * self.k

    @property
    def bytes_c128(self) -> int:
        return self.m * self.n * 16

    def __str__(self) -> str:
        return f"k={self.k}, m=2^{self.m.bit_length()-1}, n=2^{self.n.bit_length()-1}"


# The eight rows of Tables 1-5, in table order.
PAPER_GRID = (
    RIDCase(k=100, m=2 ** 14, n=2 ** 14),
    RIDCase(k=100, m=2 ** 16, n=2 ** 14),
    RIDCase(k=400, m=2 ** 16, n=2 ** 14),
    RIDCase(k=400, m=2 ** 18, n=2 ** 14),
    RIDCase(k=100, m=2 ** 16, n=2 ** 16),
    RIDCase(k=1000, m=2 ** 16, n=2 ** 16),
    RIDCase(k=400, m=2 ** 14, n=2 ** 18),
    RIDCase(k=1000, m=2 ** 14, n=2 ** 18),
)

# Processor counts benchmarked in the paper (Figures 1-2, Tables 1-4).
PAPER_PROCS = (4, 8, 16, 32, 64, 128)

# Paper Table 5: measured ||A - BP||_2 per grid row (same order).
PAPER_TABLE5_ERRORS = (5e-11, 1e-10, 2e-10, 4e-10, 2e-10, 6e-10, 3e-10, 6e-10)

# CPU-feasible shrunken grid (same aspect ratios, ~1000x smaller area)
# used by the laptop-scale benchmarks; the full grid runs under --full.
SMALL_GRID = (
    RIDCase(k=16, m=2 ** 9, n=2 ** 9),
    RIDCase(k=16, m=2 ** 11, n=2 ** 9),
    RIDCase(k=48, m=2 ** 11, n=2 ** 9),
    RIDCase(k=48, m=2 ** 13, n=2 ** 9),
    RIDCase(k=16, m=2 ** 11, n=2 ** 11),
    RIDCase(k=96, m=2 ** 11, n=2 ** 11),
    RIDCase(k=48, m=2 ** 9, n=2 ** 13),
    RIDCase(k=96, m=2 ** 9, n=2 ** 13),
)
