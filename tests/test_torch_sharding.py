"""The port's layout tables against the JAX reference's, on the CPU, with
no process group and no jax devices.

``repro.launch.sharding``'s spec functions read only a mesh's ``shape``
and ``axis_names``, and so do the port's (``launch.mesh.axis_sizes``), so
both run on the same stand-in meshes: (16, 16), (2, 16, 16), (2, 2, 2),
(4, 2) and (1, 1), for every name in ``ARCHS`` at full width, in modes
``tp`` and ``fsdp``.  The port's trees are per layer where the
reference's are stacked over a leading layer dim: its layer ``i`` is the
reference's pattern position ``i % p`` (``pattern_period``), and each of
its specs must equal the reference's with that leading entry removed (the
cache specs' dims sit one lower).  The shapes and dtypes of
``params_shape``, ``caches_shape`` and ``input_specs`` are held to the
reference's in the same way.  Exact equality throughout.

One finding: under EP the reference's expert rule puts its expert axis on
the layer stack of qwen2-moe's shared expert (a SwiGLU under ``moe``),
which a per-layer tree cannot hold; the port replicates those leaves over
`model` (ROADMAP Queue C), and a test pins exactly which leaves those are.
"""
import functools
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.launch import sharding as tsharding  # noqa: E402
from repro_torch.launch.mesh import axis_sizes, dp_axes, model_axis_size  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from torch_ranks import pin_threads  # noqa: E402

pin_threads()

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
MODES = ("tp", "fsdp")


def _mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference cfg, its params_shape, port cfg, port params_shape,
    pattern period)."""
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    return (jc, jtransformer.params_shape(jc), tc,
            ttransformer.params_shape(tc), jtransformer.pattern_period(jc))


def _flat(tree, prefix=""):
    """{dotted name: leaf} of a reference tree (tuple positions by
    index); a PartitionSpec is a leaf."""
    if isinstance(tree, PartitionSpec) or not isinstance(
            tree, (dict, tuple, list)):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _ref_name(name: str, p: int) -> tuple[str, bool]:
    """The reference's leaf name of the port's parameter, and whether it
    is stacked."""
    head, *rest = name.split(".")
    if head == "blocks":
        i, *tail = rest
        return ".".join(["blocks", str(int(i) % p)] + tail), True
    if head == "enc_blocks":
        return ".".join(["enc_blocks"] + rest[1:]), True
    return name, False


def _full(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _defects(arch, mesh, mode) -> set:
    """The port's leaves whose reference spec splits the layer stack."""
    jc, jshape, tc, tshape, p = _pair(arch)
    ref = _flat(jsharding.param_specs(jc, jshape, _mesh(mesh), mode))
    out = set()
    for name, t in tshape.named_parameters():
        key, stacked = _ref_name(name, p)
        if stacked and _full(ref[key], t.dim() + 1)[0] is not None:
            out.add(name.split(".", 2)[2])
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_param_specs_equal_the_reference(arch, mesh, mode):
    jc, jshape, tc, tshape, p = _pair(arch)
    ref = _flat(jsharding.param_specs(jc, jshape, _mesh(mesh), mode))
    got = tsharding.param_specs(tc, tshape, _mesh(mesh), mode)
    assert len(got) == sum(1 for _ in tshape.parameters())
    for name, t in tshape.named_parameters():
        key, stacked = _ref_name(name, p)
        want = _full(ref[key], t.dim() + stacked)
        assert got[name] == (want[1:] if stacked else want), (
            name, got[name], want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_the_layer_stack_is_split_only_for_qwen2_moes_shared_expert(
        mesh, mode):
    shared = {f"moe.shared.{w}" for w in ("w_gate", "w_up", "w_down")}
    for arch in tcfgs.ARCHS:
        tc = tcfgs.get_config(arch)
        ep = tc.moe and tc.n_experts % dict(zip(
            MESHES[mesh][1], MESHES[mesh][0]))["model"] == 0
        want = (shared if arch == "qwen2_moe_a2_7b" and ep and mode == "tp"
                else set())
        assert _defects(arch, mesh, mode) == want, (arch, mesh, mode)


@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_params_shape_equals_the_reference(arch):
    jc, jshape, tc, tshape, p = _pair(arch)
    ref = _flat(jshape)
    names = dict(tshape.named_parameters())
    assert all(t.device.type == "meta" for t in names.values())
    seen = set()
    for name, t in names.items():
        key, stacked = _ref_name(name, p)
        seen.add(key)
        want = ref[key]
        shape = tuple(want.shape)
        if stacked:
            assert shape[0] == (jc.n_encoder_layers if name.startswith("enc")
                                else jc.n_layers // p)
            shape = shape[1:]
        assert tuple(t.shape) == shape, name
        assert str(t.dtype).replace("torch.", "") == str(want.dtype), name
    assert seen == set(ref)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_equal_the_reference(mesh):
    m = _mesh(mesh)
    for mode in MODES:
        for B in (1, 2, 8, 32, 128, 256, 512):
            assert tsharding.batch_spec(m, B, mode) == tuple(
                jsharding.batch_spec(m, B, mode)), (B, mode)
        for arch in ("granite_3_2b", "whisper_tiny"):
            jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
            ref = jsharding.train_batch_specs(jc, m, 256, mode)
            got = tsharding.train_batch_specs(tc, m, 256, mode)
            assert got == {k: tuple(v) for k, v in ref.items()}
    assert tsharding.batch_spec(m, 256) == tuple(jsharding.batch_spec(m, 256))
    assert dp_axes(m) == jsharding.dp_axes(m)
    assert model_axis_size(m) == jsharding.model_axis_size(m)
    assert axis_sizes(m) == m.shape


def _cache_cases():
    for arch in tcfgs.ARCHS:
        yield arch, 128, 32_768
        if tcfgs.get_config(arch).subquadratic:
            yield arch, 1, 524_288


@pytest.mark.parametrize("arch,B,L", list(_cache_cases()))
def test_cache_specs_and_shapes_equal_the_reference(arch, B, L):
    jc, _, tc, _, p = _pair(arch)
    jcache = jtransformer.caches_shape(jc, B, L)
    tcache = ttransformer.caches_shape(tc, B, L)
    assert set(tcache) == set(jcache)
    for key in tcache:
        assert len(tcache[key]) == tc.n_layers
        for i, st in enumerate(tcache[key]):
            ref = jcache[key][i % p]
            assert type(st).__name__ == type(ref).__name__
            for t, r in zip(st, ref):
                assert t.device.type == "meta"
                assert tuple(r.shape) == (tc.n_layers // p,) + tuple(t.shape)
                assert str(t.dtype).replace("torch.", "") == str(r.dtype)
    for mesh in MESHES:
        m = _mesh(mesh)
        ref = jsharding.cache_specs(jc, jcache, m, B)
        got = tsharding.cache_specs(tc, tcache, m, B)
        for key in got:
            for i, st in enumerate(got[key]):
                for g, r, t in zip(st, ref[key][i % p], tcache[key][i]):
                    want = _full(r, t.dim() + 1)
                    assert want[0] is None
                    assert g == want[1:], (mesh, key, i, g, want)
        shd = tsharding.cache_shardings(tc, tcache, m, B)
        assert shd["self"][0][0].spec == got["self"][0][0]


@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_input_specs_and_cells_equal_the_reference(arch, shape):
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    assert tshapes.SHAPES[shape] == tuple(jshapes.SHAPES[shape])
    assert tshapes.cell_applicable(tc, shape) == jshapes.cell_applicable(
        jc, shape)
    if shape == "long_500k" and not tc.subquadratic:
        return
    ref = jshapes.input_specs(jc, shape)
    got = tshapes.input_specs(tc, shape)
    assert set(got) == set(ref)
    p = jtransformer.pattern_period(jc)
    for key, want in ref.items():
        if key == "caches":
            for k in want:
                for i, st in enumerate(got[key][k]):
                    for t, r in zip(st, want[k][i % p]):
                        assert tuple(r.shape)[1:] == tuple(t.shape)
            continue
        assert got[key].device.type == "meta"
        assert tuple(got[key].shape) == tuple(want.shape), key
        assert (str(got[key].dtype).replace("torch.", "")
                == str(np.dtype(want.dtype))), key
