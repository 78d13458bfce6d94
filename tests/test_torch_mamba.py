"""The port's Mamba mixer and the hybrid jamba stack against the JAX
reference, on the CPU.

Both packages run the same weights: the reference's ``init_params`` tree
(or one Mamba layer's ``mixer`` leaves), moved into the port by
``params_from_jax``.  Inputs are made with a seeded numpy generator and
cross as numpy arrays.  The config is the SMOKE jamba-v0.1-52b (8 layers:
attention at layer 4, Mamba elsewhere, MoE on the odd layers; d_inner
128, d_state 16) in f32 compute: MoE routing is discontinuous, so only f32
keeps both packages on the same side of every choice.  The reference's
functions run under ``jax.jit``.

Tolerances, of the reference's largest entry: one Mamba layer 2e-5 (f32
sums in another order, and the chunk scan's tree is another: doubling
here, ``lax.associative_scan``'s odd/even split there); the whole stack
1e-4 (as the dense and MoE stacks' tests).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.kernels.flash.kernel import LAUNCHES  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.serving import GenerationRequest, ServeEngine  # noqa: E402
from torch_ranks import pin_threads  # noqa: E402

pin_threads()

LAYER_TOL = 2e-5
TOL = 1e-4
ARCH = "jamba_v01_52b"


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max |got - want| = {err} > {tol} * {scale}"


def _cfgs(**edit):
    jc = jcfgs.get_smoke_config(ARCH).replace(dtype="float32", **edit)
    tc = tcfgs.get_smoke_config(ARCH).replace(dtype="float32", **edit)
    return jc, tc


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port cfg, port model)."""
    jc, tc = _cfgs()
    jp = jax.jit(lambda k: jmodels.init_params(k, jc))(jax.random.key(0))
    model = tmodels.params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                    device="cpu")
    return jc, jp, tc, model


@pytest.fixture(scope="module")
def layer(pair):
    """Layer 0's Mamba leaves: (reference dict, port module)."""
    jc, jp, tc, model = pair
    leaves = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                          jp["blocks"][0]["mixer"])
    return leaves, model.blocks[0].mixer


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(n, vocab, seed=0, batch=1):
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, n)).astype(np.int32)


# ------------------------------------------------------------ the mixer

@pytest.mark.parametrize("chunk", [8, 32])
def test_mamba_forward_matches(pair, layer, chunk):
    """A batch of 2 x 32 tokens in chunks of 8 (four chunks, the state
    carried) and of 32 (chunk = S: one chunk)."""
    jc, _, tc, _ = pair
    jl, tl = layer
    x = _x((2, 32, tc.d_model), seed=chunk)
    want = jax.jit(lambda p, x: jmamba.mamba_forward(p, jc, x, chunk=chunk))(
        jl, jnp.asarray(x))
    got = tmamba.mamba_forward(tl, tc, torch.from_numpy(x), chunk=chunk)
    _close(got, want, LAYER_TOL)


def test_mamba_prefill_and_decode_match(pair, layer):
    """Prefill of 16 tokens (chunks of 8), then 4 one-token decode steps:
    the outputs and both state leaves (the conv window and the f32 SSM
    state) at every step."""
    jc, _, tc, _ = pair
    jl, tl = layer
    x = _x((2, 20, tc.d_model), seed=3)
    jy, jst = jax.jit(lambda p, x: jmamba.mamba_prefill(p, jc, x, chunk=8))(
        jl, jnp.asarray(x[:, :16]))
    ty, tst = tmamba.mamba_prefill(tl, tc, torch.from_numpy(x[:, :16]),
                                   chunk=8)
    _close(ty, jy, LAYER_TOL)
    jdecode = jax.jit(lambda p, x, s: jmamba.mamba_decode(p, jc, x, s))
    for t in range(16, 20):
        _close(tst.conv, jst.conv, LAYER_TOL)
        _close(tst.ssm, jst.ssm, LAYER_TOL)
        assert tst.ssm.dtype == torch.float32
        jy, jst = jdecode(jl, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = tmamba.mamba_decode(tl, tc, torch.from_numpy(x[:, t:t + 1]),
                                      tst)
        _close(ty, jy, LAYER_TOL)
    _close(tst.conv, jst.conv, LAYER_TOL)
    _close(tst.ssm, jst.ssm, LAYER_TOL)


def test_chunked_scan_matches_the_recurrence(layer):
    """The port's chunked scan against its own token-by-token recurrence
    (the counterpart of the reference's
    ``test_mamba_chunked_matches_sequential``), at chunk 8 over 32
    tokens, and a prefill's final state against the recurrence's."""
    _, tl = layer
    tc = tcfgs.get_smoke_config(ARCH).replace(dtype="float32")
    x = torch.from_numpy(_x((2, 32, tc.d_model), seed=7))
    y_chunk, st_chunk = tmamba.mamba_prefill(tl, tc, x, chunk=8)
    st = tmamba.mamba_init_state(tc, 2)
    ys = [tmamba.mamba_decode(tl, tc, x[:, t:t + 1], st)[0]
          for t in range(32)]
    _close(y_chunk, torch.cat(ys, 1), LAYER_TOL)
    _close(st_chunk.ssm, st.ssm, LAYER_TOL)
    _close(st_chunk.conv, st.conv, LAYER_TOL)


def test_mamba_init_matches_reference_shapes_and_scales():
    """The reference's leaf names, shapes and dtypes under bf16 params
    (``dt_bias``, ``A_log`` and ``D`` stay f32), and its deterministic
    leaves exactly: ``A_log``, ``D``, ``conv_b``; ``dt_bias`` is the
    inverse softplus of a dt in [1e-3, 0.1]."""
    jc = jcfgs.get_smoke_config(ARCH).replace(param_dtype="bfloat16")
    tc = tcfgs.get_smoke_config(ARCH).replace(param_dtype="bfloat16")
    want = jax.jit(lambda k: jmamba.mamba_init(k, jc))(jax.random.key(1))
    gen = torch.Generator().manual_seed(1)
    got = tmamba.mamba_init(gen, tc)
    names = dict(got.named_parameters())
    assert set(names) == set(want)
    for name, t in names.items():
        w = want[name]
        assert tuple(t.shape) == w.shape, name
        assert str(t.dtype).split(".")[1] == str(w.dtype), name
    for name in ("A_log", "D", "conv_b"):
        np.testing.assert_array_equal(_np(names[name]), _np(want[name]))
    dt = torch.nn.functional.softplus(got.dt_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)


def test_a_long_prompt_off_the_chunk_raises(layer):
    """Over 128 tokens a sequence must be a multiple of the chunk, as the
    reference asserts; the port says so in a ValueError."""
    _, tl = layer
    tc = tcfgs.get_smoke_config(ARCH).replace(dtype="float32")
    x = torch.zeros((1, 130, tc.d_model))
    with pytest.raises(ValueError, match=r"multiple of it .*S=130"):
        tmamba.mamba_forward(tl, tc, x)
    assert tmamba.mamba_forward(tl, tc, x[:, :100]).shape == (1, 100,
                                                              tc.d_model)


# ------------------------------------------------------------- the stack

def test_jamba_builds_and_keeps_the_reference_pattern():
    """The full-width jamba at 8 layers builds (on the meta device) with
    the reference's leaf shapes (its ``params_shape``, stacked by pattern
    position) and their total, 1.326e10; the pattern, its period and the
    superblock count are the reference's at 8 and 32 layers."""
    from repro.models import transformer as jtr
    jc = jcfgs.get_config(ARCH).replace(n_layers=8)
    tc = tcfgs.get_config(ARCH).replace(n_layers=8)
    model = tmodels.Transformer(tc, device="meta")
    kinds = [type(b.mixer).__name__ + ("+moe" if hasattr(b, "moe") else "")
             for b in model.blocks]
    assert kinds == ["Mamba", "Mamba+moe", "Mamba", "Mamba+moe",
                     "Attention", "Mamba+moe", "Mamba", "Mamba+moe"]
    want = jtr.params_shape(jc)
    got = ttransformer._block_leaves
    for i, bp in enumerate(model.blocks):
        shapes = jax.tree.map(lambda t: tuple(t.shape), got(bp))
        assert shapes == jax.tree.map(lambda s: s.shape[1:],
                                      want["blocks"][i]), i
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(want))
    assert 1.32e10 < n < 1.33e10
    for cfg_j, cfg_t in ((jc, tc), (jc.replace(n_layers=32),
                                    tc.replace(n_layers=32))):
        assert ttransformer.pattern(cfg_t) == jtr.pattern(cfg_j)
        assert ttransformer.pattern_period(cfg_t) == 8
        assert ttransformer.n_superblocks(cfg_t) == jtr.n_superblocks(cfg_j)
    assert not tmodels.supports_chunked_prefill(tc)


def test_forward_matches(pair):
    jc, jp, tc, model = pair
    toks = _tokens(24, jc.vocab_size, batch=2)
    want, jaux = jax.jit(lambda p, t: jmodels.forward(p, jc, t))(
        jp, jnp.asarray(toks))
    got, aux = tmodels.forward(model, tc, torch.from_numpy(toks))
    _close(got, want)
    for g, w in zip(aux, jaux):
        assert abs(float(g) - float(w)) <= 1e-6, (float(g), float(w))


def test_prefill_and_decode_match(pair):
    """Prefill of a 16-token batch of 2 and 3 greedy decode steps, each
    step's logits; the Mamba states and the attention layer's cache after
    the last step."""
    jc, jp, tc, model = pair
    toks = _tokens(16, jc.vocab_size, seed=1, batch=2)
    jdecode = jax.jit(lambda p, t, pos, c: jmodels.decode_step(p, jc, t, pos,
                                                                c))
    jl, jcache = jax.jit(lambda p, t: jmodels.prefill(p, jc, t, max_len=24))(
        jp, jnp.asarray(toks))
    before = LAUNCHES.count
    tl, tcache = tmodels.prefill(model, tc, torch.from_numpy(toks),
                                 max_len=24)
    _close(tl, jl)
    for i in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)
        pos = np.full((2,), 16 + i, np.int32)
        jl, jcache = jdecode(jp, jnp.asarray(nxt), jnp.asarray(pos), jcache)
        tl, tcache = tmodels.decode_step(model, tc, torch.from_numpy(nxt),
                                         torch.from_numpy(pos), tcache)
        _close(tl, jl)
    assert LAUNCHES.count == before       # CPU: the plain version
    # Layer i is the reference's pattern position i (one superblock).
    for i in (0, 3, 7):
        _close(tcache["self"][i].ssm, jcache["self"][i].ssm[0])
        _close(tcache["self"][i].conv, jcache["self"][i].conv[0])
    _close(tcache["self"][4].k, jcache["self"][4].k[0])


def test_serving_equals_forward_at_dropless_capacity():
    """At a dropless capacity the MoE groups no longer matter: prefill
    and three teacher-forced decode steps equal ``forward``'s logits."""
    _, tc = _cfgs(moe_capacity_factor=8.0)
    model = tmodels.init_params(0, tc, device="cpu")
    toks = torch.from_numpy(_tokens(19, tc.vocab_size, seed=2, batch=2))
    full, aux = tmodels.forward(model, tc, toks)
    assert float(aux.dropped_fraction) == 0.0
    lg, caches = tmodels.prefill(model, tc, toks[:, :16], max_len=20)
    _close(lg[:, 0], full[:, 15])
    for i in range(3):
        lg, caches = tmodels.decode_step(model, tc, toks[:, 16 + i:17 + i],
                                         16 + i, caches)
        _close(lg[:, 0], full[:, 16 + i])


def test_params_round_trip(pair):
    """``params_from_jax`` -> ``params_to_numpy`` gives the reference's
    tree of 8 pattern positions bit for bit."""
    jc, jp, tc, model = pair
    back = tmodels.params_to_numpy(model)
    want = jax.tree.map(np.asarray, jp)
    assert len(back["blocks"]) == len(want["blocks"]) == 8
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    one = dict(want, blocks=want["blocks"][:1])
    with pytest.raises(ValueError, match="pattern period of 8"):
        tmodels.params_from_jax(one, tc, device="cpu")


# ------------------------------------------------------------- serving

def test_engine_greedy_equals_reference(pair):
    """5 requests through 3 slots (queueing, continuous batching, a freed
    slot's Mamba state replaced at install); prompts of one length, so the
    reference compiles one prefill."""
    jc, jp, tc, model = pair
    outs = []
    for eng, req, params in ((jserving.ServeEngine,
                              jserving.GenerationRequest, jp),
                             (ServeEngine, GenerationRequest, model)):
        e = eng(jc if params is jp else tc, params, max_batch=3, max_len=32)
        rng = np.random.default_rng(0)
        reqs = [req(request_id=i, prompt=rng.integers(
                    0, jc.vocab_size, 6).astype(np.int32),
                    max_new_tokens=5) for i in range(5)]
        for r in reqs:
            e.submit(r)
        e.run()
        outs.append([(r.status, list(r.output)) for r in reqs])
    assert outs[0] == outs[1]
    assert all(s == "done" and len(o) == 5 for s, o in outs[1])


def test_engine_refuses_chunked_prefill_as_reference():
    """A hybrid stack has no chunked prefill: both engines refuse
    ``prefill_chunk_tokens=8`` with the same message."""
    msgs = []
    for eng, cfgs, kw in ((jserving.ServeEngine, jcfgs, {}),
                          (ServeEngine, tcfgs, {"device": "cpu"})):
        with pytest.raises(ValueError, match=r"chunked prefill unsupported "
                                             r"for arch .*got "
                                             r"prefill_chunk_tokens=8") as e:
            eng(cfgs.get_smoke_config(ARCH), None, prefill_chunk_tokens=8,
                **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_launch_serve_cli_serves_jamba():
    """The serve CLI runs the SMOKE jamba, its depth set by ``--layers``
    (16: two pattern periods)."""
    from repro_torch.launch import serve as tserve
    done = tserve.main(["--arch", "jamba-v0.1-52b", "--smoke", "--device",
                        "cpu", "--layers", "16", "--requests", "3",
                        "--new-tokens", "3"])
    assert [r.status for r in done] == ["done"] * 3
    assert all(len(r.output) == 3 for r in done)
