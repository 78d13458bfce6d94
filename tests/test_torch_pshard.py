"""The port's sharding hints (``repro_torch.models.pshard``) against the
reference's rules (``tests/test_pshard.py``), and its spec-to-placement
map against JAX's block layout.

Without a mesh ``hint`` returns its input itself.  The reference's own
cases run on a (2, 2, 2) ("pod", "data", "model") mesh of torch's fake
backend (eight ranks, no peers), in a rank subprocess
(``torch_ranks.run_ranks``): no test process joins a group.  The block
layout: for every spec of the reference's tables that splits a dim over
two or three axes, each rank's block under the port's placements (what
``distribute`` keeps) equals the block JAX's
``NamedSharding`` gives that device, worked out from the spec alone (a
dim split over a tuple of axes is cut major to minor in the tuple's
order).  A ``"cuda"`` mesh without a card raises.
"""
import itertools
import math

import pytest
import torch

from repro_torch.models import pshard
from torch_ranks import failures, pin_threads, run_ranks

pin_threads()


def test_hint_noop_without_mesh():
    x = torch.ones((8, 4))
    assert pshard.hint(x, "data", "model") is x
    assert pshard.current_mesh() is None
    with pshard.use_mesh(None):
        assert pshard.hint(x, "dp", None) is x


def test_dp_axes_context_restores():
    assert pshard._DP_AXES.get() == ("pod", "data")
    with pshard.dp_axes(("data",)):
        assert pshard._DP_AXES.get() == ("data",)
        with pshard.dp_axes(("data", "model")):
            assert pshard._DP_AXES.get() == ("data", "model")
        assert pshard._DP_AXES.get() == ("data",)
    assert pshard._DP_AXES.get() == ("pod", "data")


def spec_of(placements, ndim: int, names) -> tuple:
    """The spec of DTensor ``placements`` on a mesh of axis ``names``
    (``pshard.placements``' inverse; Replicate is None)."""
    dims: list = [[] for _ in range(ndim)]
    for name, p in zip(names, placements):
        if p.is_shard():
            dims[p.dim % ndim].append(name)
    return tuple(None if not g else (g[0] if len(g) == 1 else tuple(g))
                 for g in dims)


def _jax_block(spec, sizes: dict, coord: dict, shape) -> tuple:
    """The (start, stop) of each dim of the block JAX's NamedSharding
    gives the device at ``coord``: a dim split over axes (a1, a2, ...) is
    cut into prod(sizes) blocks, the device's index mixed-radix over its
    coordinates on a1 (major), a2, ..."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        group = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        n = math.prod(sizes[a] for a in group)
        idx = 0
        for a in group:
            idx = idx * sizes[a] + coord[a]
        out.append((idx * dim // n, (idx + 1) * dim // n))
    return tuple(out)


_MESH = ((2, 2, 2), ("pod", "data", "model"))
_SPECS = [(("pod", "data"), "model"), (("pod", "data", "model"), None),
          (None, ("data", "model")), ("pod", ("data", "model")),
          (("pod", "model"), "data"), ("model", ("pod", "data"))]


@pytest.mark.parametrize("spec", _SPECS)
def test_placements_cut_blocks_as_jax_does(spec):
    from torch.distributed.tensor import Shard
    shape, names = _MESH
    sizes = dict(zip(names, shape))
    pl = pshard.placements(spec, _Standin(shape, names))
    for i, name in enumerate(names):
        dims = [d for d, ax in enumerate(spec) if ax is not None and name in
                (ax if isinstance(ax, tuple) else (ax,))]
        assert pl[i] == (Shard(dims[0]) if dims else pl[i])
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    for coords in itertools.product(*(range(n) for n in shape)):
        mesh = _Standin(shape, names, coords)
        got = pshard._local_block(x, mesh, pl)
        want = _jax_block(spec, sizes, dict(zip(names, coords)), x.shape)
        assert torch.equal(got, x[want[0][0]:want[0][1],
                                  want[1][0]:want[1][1]]), (spec, coords)
    assert spec_of(pl, 2, names) == spec


def test_placements_refuse_axes_out_of_mesh_order():
    with pytest.raises(ValueError, match="not in the mesh's order"):
        pshard.placements((("data", "pod"), None), _Standin(*_MESH))
    with pytest.raises(ValueError, match="used twice"):
        pshard.placements(("data", "data"), _Standin(*_MESH))


class _Standin:
    """A mesh's shape, names and this rank's coordinate (no group)."""

    def __init__(self, shape, names, coord=None):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)
        self._coord = coord

    def size(self, i):
        return self.shape[i]

    def get_coordinate(self):
        return list(self._coord)


_PROGRAM = r"""
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models.pshard import dp_axes, hint, placements, use_mesh

mesh = make_elastic_mesh((2, 2, 2), ("pod", "data", "model"),
                         device_type="cpu")


def spec(y):
    dims = [[] for _ in range(y.dim())]
    for name, p in zip(mesh.mesh_dim_names, y.placements):
        if p.is_shard():
            dims[p.dim].append(name)
    return tuple(None if not g else (g[0] if len(g) == 1 else tuple(g))
                 for g in dims)


with use_mesh(mesh):
    # dp resolves to (pod, data); divisible dims get sharded
    y = hint(torch.ones((8, 3, 4)) * 1.0, "dp", None, "model")
    assert isinstance(y, DTensor)
    assert spec(y) == (("pod", "data"), None, "model"), spec(y)
    assert y.to_local().shape == (2, 3, 2)
    # non-divisible dims are dropped, not errored (7 % 4 != 0)
    y2 = hint(torch.ones((7, 4)) * 1.0, "dp", "model")
    assert spec(y2)[0] is None and spec(y2)[1] == "model", spec(y2)
    # an axis used by an earlier slot cannot repeat (fsdp batch mode)
    with dp_axes(("pod", "data", "model")):
        y3 = hint(torch.ones((8, 3, 4)) * 1.0, "dp", None, "model")
        assert spec(y3) == (("pod", "data", "model"), None, None), spec(y3)
    # unknown axis names are ignored (the hint becomes a no-op)
    x4 = torch.ones((4, 2))
    assert hint(x4, "nonexistent", None) is x4
    # a DTensor is redistributed; the same layout again is the same object
    y5 = hint(y, "dp", None, None)
    assert spec(y5) == (("pod", "data"), None, None)
    assert hint(y5, "dp", None, None) is y5
    # DTensor's own offset of rank 0's block under a (pod, data) split
    _, off = compute_local_shape_and_global_offset(
        (8, 16), mesh, placements((("pod", "data"), "model"), mesh))
    assert tuple(off) == (0, 0)
# a "cuda" mesh without a card raises; nothing falls back to the CPU
from repro_torch.launch.mesh import make_host_mesh
try:
    make_host_mesh(device_type="cuda")
    raise SystemExit("a cuda mesh was made without a card")
except RuntimeError as e:
    assert "cuda" in str(e), e
print("OK")
"""


def test_reference_cases_on_a_fake_mesh():
    res = run_ranks(_PROGRAM, 1, timeout=120, OMP_NUM_THREADS="1")
    assert not failures(res), failures(res)
    assert "OK" in res[0][1]
