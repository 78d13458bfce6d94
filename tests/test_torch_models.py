"""The port's LM serving path against the JAX reference, on the CPU.

Both packages run the same weights: the reference's ``init_params`` tree,
moved into the port's ``Transformer`` by ``params_from_jax``.  Inputs are
made with a seeded numpy generator and cross as numpy arrays.  Configs are
the SMOKE granite-3-2b and h2o-danube-1.8b in f32 (danube's window is 16
tokens there).  A 2100-token prompt sends both sides down the blockwise
path (the reference's jnp online-softmax scan, the port's flash op); a
short one down the dense path.

Tolerance: 1e-4 of the largest entry of the reference's output (f32 sums
in another order through two layers; the measured gaps are near 1e-6).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import norms as jnorms  # noqa: E402
from repro.models import rope as jrope  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.kernels.flash.kernel import LAUNCHES  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import norms as tnorms  # noqa: E402
from repro_torch.models import rope as trope  # noqa: E402

RTOL = 1e-4
ARCHS = ["granite_3_2b", "h2o_danube_1_8b"]
LONG = 2100            # > BLOCKWISE_THRESHOLD: the flash path on both sides
MAX_LEN = 2200


def _close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"max |got - want| = {err} > {rtol} * {scale}"


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference cfg, reference params, port cfg, port model)."""
    arch = request.param
    jc = jcfgs.get_smoke_config(arch).replace(dtype="float32")
    tc = tcfgs.get_smoke_config(arch).replace(dtype="float32")
    jp = jmodels.init_params(jax.random.key(0), jc)
    model = tmodels.params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                    device="cpu")
    return arch, jc, jp, tc, model


def _tokens(n, vocab, seed=0, batch=1):
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, n)).astype(np.int32)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for getter in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(jcfgs, getter)(arch))
        got = dataclasses.asdict(getattr(tcfgs, getter)(arch))
        assert got == want


def test_config_aliases_and_unported_arch():
    assert tcfgs.get_config("granite-3-2b").n_layers == 40
    assert tcfgs.get_config("h2o-danube-1.8b").hd == 80
    with pytest.raises(NotImplementedError, match="jamba.*ported.*granite"):
        tcfgs.get_config("jamba-v0.1-52b")
    with pytest.raises(ValueError, match="unknown arch 'nope'"):
        tcfgs.get_smoke_config("nope")


def test_config_dtypes_are_torch():
    cfg = tcfgs.get_config("granite_3_2b")
    assert cfg.compute_dtype is torch.bfloat16
    assert cfg.params_dtype is torch.float32
    assert cfg.param_count() == jcfgs.get_config("granite_3_2b").param_count()


def test_unported_families_raise():
    """MoE on every other layer (jamba's period) and a hybrid mixer still
    raise; MoE on every layer is ported (tests/test_torch_moe.py)."""
    cfg = tcfgs.get_smoke_config("granite_3_2b").replace(
        moe=True, moe_layer_period=2, n_experts=4, n_experts_active=2,
        moe_d_ff=32)
    with pytest.raises(NotImplementedError, match="MoE"):
        tmodels.init_params(0, cfg, device="cpu")
    hybrid = tcfgs.get_smoke_config("granite_3_2b").replace(
        family="hybrid", attn_layer_period=2)
    with pytest.raises(NotImplementedError, match="Mamba"):
        tmodels.init_params(0, hybrid, device="cpu")


# ------------------------------------------------------------ components

def test_rmsnorm_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = jnorms.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    p = tnorms.RMSNorm(64, torch.float32)
    p.scale.data = torch.from_numpy(scale)
    _close(tnorms.rmsnorm(p, torch.from_numpy(x), 1e-6), want)


def test_rope_matches():
    pos = np.arange(7, dtype=np.int32)[None].repeat(2, 0) + 2095
    np.testing.assert_allclose(trope.rope_freqs(80, 10_000.0).numpy(),
                               np.asarray(jrope.rope_freqs(80, 10_000.0)),
                               rtol=1e-6)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 80, 10_000.0)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), 80, 10_000.0)
    _close(tc, jc, 1e-5)
    _close(ts, js, 1e-5)
    x = np.random.default_rng(2).standard_normal((2, 7, 3, 80)).astype(
        np.float32)
    _close(trope.apply_rope(torch.from_numpy(x), tc, ts),
           jrope.apply_rope(jnp.asarray(x), jc, js), 1e-5)
    np.testing.assert_array_equal(
        trope.text_positions(2, 5, 3).numpy(),
        np.asarray(jrope.text_positions(2, 5, 3)))


def test_mlp_matches(pair):
    _, jc, jp, tc, model = pair
    x = np.random.default_rng(3).standard_normal((2, 9, 64)).astype(
        np.float32)
    jblock = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    _close(tmlp.mlp(model.blocks[0].mlp, tc, torch.from_numpy(x)),
           jmlp.mlp(jblock["mlp"], jc, jnp.asarray(x)))


def test_gelu_mlp_matches():
    """The GELU MLP (whisper's; tanh approximation as jax.nn.gelu)."""
    rng = np.random.default_rng(5)
    leaves = {"w_in": (64, 128), "b_in": (128,), "w_out": (128, 64),
              "b_out": (64,)}
    p = {k: rng.standard_normal(v).astype(np.float32) for k, v in
         leaves.items()}
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    mod = tmlp.GeluMLP(64, 128, torch.float32)
    for k, v in p.items():
        getattr(mod, k).data = torch.from_numpy(v)
    want = jmlp.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), jnp.float32)
    cfg = tcfgs.get_smoke_config("granite_3_2b").replace(dtype="float32")
    _close(tmlp.mlp(mod, cfg, torch.from_numpy(x)), want)


@pytest.mark.parametrize("S", [12, LONG])
def test_attention_matches(pair, S):
    """The dense path (S=12) and the blockwise path (S=2100, one flash
    call) of one attention layer."""
    _, jc, jp, tc, model = pair
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, S, 64)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    jcos, jsin = jrope.rope_cos_sin(jnp.asarray(pos), jc.hd, jc.rope_theta)
    tcos, tsin = trope.rope_cos_sin(torch.from_numpy(pos), tc.hd,
                                    tc.rope_theta)
    jblock = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    want = jattn.attention(jblock["mixer"], jc, jnp.asarray(x), jcos, jsin)
    got = tattn.attention(model.blocks[0].mixer, tc, torch.from_numpy(x),
                          tcos, tsin)
    _close(got, want)


# ---------------------------------------------------------- whole model

def test_forward_matches(pair):
    _, jc, jp, tc, model = pair
    toks = _tokens(20, jc.vocab_size, batch=2)
    want, _ = jmodels.forward(jp, jc, jnp.asarray(toks))
    got, aux = tmodels.forward(model, tc, torch.from_numpy(toks))
    assert tuple(got.shape) == (2, 20, jc.padded_vocab)
    assert float(aux.load_balance_loss) == 0.0
    _close(got, want)


def _jax_serve(jc, jp, toks, steps):
    """Reference prefill + greedy decode: the list of per-step logits."""
    lg, caches = jmodels.prefill(jp, jc, jnp.asarray(toks), max_len=MAX_LEN)
    out = [np.asarray(lg)]
    nxt = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for i in range(steps):
        pos = jnp.full((toks.shape[0],), toks.shape[1] + i, jnp.int32)
        lg, caches = jmodels.decode_step(jp, jc, nxt, pos, caches)
        out.append(np.asarray(lg))
        nxt = jnp.argmax(lg[:, 0], axis=-1)[:, None].astype(jnp.int32)
    return out


def _torch_serve(tc, model, toks, steps):
    lg, caches = tmodels.prefill(model, tc, torch.from_numpy(toks),
                                 max_len=MAX_LEN)
    out = [lg]
    nxt = torch.argmax(lg[:, -1], dim=-1)[:, None]
    for i in range(steps):
        pos = torch.full((toks.shape[0],), toks.shape[1] + i)
        lg, caches = tmodels.decode_step(model, tc, nxt, pos, caches)
        out.append(lg)
        nxt = torch.argmax(lg[:, 0], dim=-1)[:, None]
    return out


@pytest.mark.parametrize("S,steps", [(5, 20), (LONG, 3)])
def test_prefill_and_decode_match(pair, S, steps):
    """Prefill logits and each decode step's logits; at S=5 danube decodes
    20 steps past its 16-token window (the ring buffer wraps), at S=2100
    its prefill fills the ring buffer from the prompt's tail."""
    arch, jc, jp, tc, model = pair
    toks = _tokens(S, jc.vocab_size, seed=S)
    before = LAUNCHES.count
    got = _torch_serve(tc, model, toks, steps)
    assert LAUNCHES.count == before       # CPU: the plain version
    want = _jax_serve(jc, jp, toks, steps)
    assert len(got) == len(want) == steps + 1
    for g, w in zip(got, want):
        _close(g, w)


def test_prefill_chunk_matches(pair):
    """Chunked prefill of a 37-token prompt in chunks of 8 against the
    reference's own chunks, and against the one-shot prefill."""
    arch, jc, jp, tc, model = pair
    if not tmodels.supports_chunked_prefill(tc):
        assert not jmodels.supports_chunked_prefill(jc)
        with pytest.raises(ValueError, match="chunked prefill unsupported"):
            tmodels.prefill_chunk(model, tc, torch.zeros((1, 4), dtype=torch.long),
                                  0, tmodels.init_caches(tc, 1, 64, "cpu"))
        return
    toks = _tokens(37, jc.vocab_size, seed=5)
    jcache = jmodels.init_caches(jc, 1, 64)
    tcache = tmodels.init_caches(tc, 1, 64, "cpu")
    for p0 in range(0, 37, 8):
        jl, jcache = jmodels.prefill_chunk(jp, jc, jnp.asarray(toks[:, p0:p0 + 8]),
                                           p0, jcache)
        tl, tcache = tmodels.prefill_chunk(model, tc,
                                           torch.from_numpy(toks[:, p0:p0 + 8]),
                                           p0, tcache)
        _close(tl, jl)
    one, _ = tmodels.prefill(model, tc, torch.from_numpy(toks), max_len=64)
    _close(tl, one.numpy())
    _close(tcache["self"][1].k, jcache["self"][0].k[1])


def test_params_round_trip(pair):
    _, jc, jp, tc, model = pair
    back = tmodels.params_to_numpy(model)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_params_from_jax_rejects_a_foreign_tree(pair):
    _, jc, jp, tc, model = pair
    tree = jax.tree.map(np.asarray, jp)
    tree["blocks"][0]["mixer"]["extra"] = tree["blocks"][0]["mixer"]["wq"]
    with pytest.raises(ValueError, match="extra"):
        tmodels.params_from_jax(tree, tc, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_init_matches_reference_shapes(arch):
    """The same leaves, shapes and scales as the reference's
    ``attention_init`` (the draws differ: torch's generator)."""
    tc = tcfgs.get_smoke_config(arch).replace(qkv_bias=True, qk_norm=True)
    jc = jcfgs.get_smoke_config(arch).replace(qkv_bias=True, qk_norm=True)
    gen = torch.Generator().manual_seed(0)
    got = dict(tattn.attention_init(gen, tc).named_parameters())
    want = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jattn.attention_init(jax.random.key(0), jc))[0]}
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.std() > 0:
            assert 0.8 < g.std() / w.std() < 1.25, name
        else:
            np.testing.assert_array_equal(g, w)


def test_init_params_shapes_and_scales():
    """The port's own init: the reference's shapes, dtypes and scales
    (different draws: torch's generator, not threefry)."""
    tc = tcfgs.get_smoke_config("granite_3_2b")
    jc = jcfgs.get_smoke_config("granite_3_2b")
    model = tmodels.init_params(0, tc, device="cpu")
    again = tmodels.init_params(0, tc, device="cpu")
    want = jax.tree.map(np.asarray, jmodels.init_params(jax.random.key(0), jc))
    got = tmodels.params_to_numpy(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
        if b.std() > 0:                       # the normal draws
            assert 0.8 < a.std() / b.std() < 1.25
        else:                                 # ones and zeros
            np.testing.assert_array_equal(a, b)
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                 again.parameters()))
