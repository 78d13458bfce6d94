"""Eager argument validation shared by the decomposition entry points
(counterpart of ``repro.core.validate``): every check raises
``ValueError`` naming the argument and the value received."""
from __future__ import annotations

__all__ = ["check_rank_bounds", "check_l_ge_k", "check_panel",
           "check_divides"]


def check_rank_bounds(k: int, l: int, n: int, *, ctx: str = "") -> None:
    """Require ``0 < k <= min(l, n)`` (the rank fits the sketch)."""
    if not (0 < k <= min(l, n)):
        raise ValueError(f"{ctx}need 0 < k <= min(l, n); "
                         f"got k={k}, l={l}, n={n}")


def check_l_ge_k(l: int, k: int, *, ctx: str = "") -> None:
    """Require the sketch height to cover the rank: ``l >= k``."""
    if l < k:
        raise ValueError(f"{ctx}need l >= k, got l={l} < k={k}")


def check_panel(panel: int, *, name: str = "panel", ctx: str = "") -> None:
    """Require a positive panel width (``name`` spells the caller's kwarg)."""
    if panel < 1:
        raise ValueError(f"{ctx}need {name} >= 1, got {name}={panel}")


def check_divides(n: int, ndev: int, axis: str, *, ctx: str = "") -> None:
    """Require the column count to shard evenly over ``ndev`` ranks
    (``axis`` names the process group in the message)."""
    if n % ndev:
        raise ValueError(f"{ctx}n={n} must divide the '{axis}' axis "
                         f"({ndev} devices)")
