"""The port's xLSTM mixers (mLSTM and sLSTM) and the xlstm-125m stack
against the JAX reference, on the CPU.

Both packages run the same weights: the reference's ``init_params`` tree
(or one layer's ``mixer`` leaves), moved into the port by
``params_from_jax``.  Inputs are made with a seeded numpy generator and
cross as numpy arrays.  The config is the SMOKE xlstm-125m (6 layers,
sLSTM at layer 1, mLSTM elsewhere; d_model 64, 2 heads, mLSTM d_inner
128 and head dim 64) in f32 compute.  The reference's functions run under
``jax.jit``.

Tolerances, of the reference's largest entry: one layer 2e-5 (f32 sums in
another order); the whole stack 1e-4 (as the other stacks' tests); the
chunked mLSTM against the port's own step-by-step decode 2e-5 (the two
evaluate the same stabilized recurrence in another order).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402
from repro_torch.serving import GenerationRequest, ServeEngine  # noqa: E402
from torch_ranks import pin_threads  # noqa: E402

pin_threads()

LAYER_TOL = 2e-5
TOL = 1e-4
ARCH = "xlstm_125m"
SLSTM_LAYER = 1


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max |got - want| = {err} > {tol} * {scale}"


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port cfg, port model).  The port
    draws the weights and hands the reference its tree
    (``params_to_numpy``): the reference's own init would compile."""
    jc = jcfgs.get_smoke_config(ARCH).replace(dtype="float32")
    tc = tcfgs.get_smoke_config(ARCH).replace(dtype="float32")
    jp = tmodels.params_to_numpy(tmodels.init_params(0, tc, device="cpu"))
    model = tmodels.params_from_jax(jp, tc, device="cpu")
    return jc, jax.tree.map(jnp.asarray, jp), tc, model


@pytest.fixture(scope="module")
def jengine(pair):
    """The reference's engine at 3 slots: its jitted prefill (one
    6-token row) and decode step (3 rows) serve the engine test and the
    prefill and decode test alike, so each compiles once."""
    jc, jp, _, _ = pair
    return jserving.ServeEngine(jc, jp, max_batch=3, max_len=32)


def _layer(pair, i):
    """Layer ``i``'s mixer leaves (one superblock: pattern position i)."""
    jc, jp, tc, model = pair
    leaves = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                          jp["blocks"][i]["mixer"])
    return leaves, model.blocks[i].mixer


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(n, vocab, seed=0, batch=1):
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, n)).astype(np.int32)


# ------------------------------------------------------------ the mixers

@pytest.mark.parametrize("chunk", [16, 48])
def test_mlstm_forward_matches(pair, chunk):
    """A batch of 2 x 48 tokens in chunks of 16 (three chunks, the state
    carried) and of 48 (chunk = S: one chunk)."""
    jc, _, tc, _ = pair
    jl, tl = _layer(pair, 0)
    x = _x((2, 48, tc.d_model), seed=chunk)
    want = jax.jit(lambda p, x: jxlstm.mlstm_forward(p, jc, x, chunk=chunk))(
        jl, jnp.asarray(x))
    got = txlstm.mlstm_forward(tl, tc, torch.from_numpy(x), chunk=chunk)
    _close(got, want, LAYER_TOL)


def test_mlstm_chunked_matches_its_own_recurrence(pair):
    """The port's chunked mLSTM against its own token-by-token decode
    (the counterpart of the reference's
    ``test_mlstm_chunked_matches_sequential``), at chunk 16 over 48
    tokens, and the prefill's final state against the recurrence's."""
    _, _, tc, _ = pair
    _, tl = _layer(pair, 0)
    x = torch.from_numpy(_x((2, 48, tc.d_model), seed=5))
    y_chunk, st_chunk = txlstm.mlstm_prefill(tl, tc, x, chunk=16)
    st = txlstm.mlstm_init_state(tc, 2)
    ys = [txlstm.mlstm_decode(tl, tc, x[:, t:t + 1], st)[0]
          for t in range(48)]
    _close(y_chunk, torch.cat(ys, 1), LAYER_TOL)
    for a, b in zip(st_chunk, st):
        _close(a, b, LAYER_TOL)


def test_slstm_forward_matches(pair):
    jc, _, tc, _ = pair
    jl, tl = _layer(pair, SLSTM_LAYER)
    x = _x((2, 24, tc.d_model), seed=2)
    want = jax.jit(lambda p, x: jxlstm.slstm_forward(p, jc, x))(
        jl, jnp.asarray(x))
    got = txlstm.slstm_forward(tl, tc, torch.from_numpy(x))
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("layer", [0, SLSTM_LAYER])
def test_mixer_prefill_and_decode_match(pair, layer):
    """Prefill of 16 tokens (one chunk), then 4 one-token decode steps:
    the outputs and every state leaf at every step (the mLSTM's C, n, m
    and conv window; the sLSTM's c, n, h, m)."""
    jc, _, tc, _ = pair
    jl, tl = _layer(pair, layer)
    kind = "mlstm" if layer != SLSTM_LAYER else "slstm"
    jpre = jax.jit(lambda p, x: getattr(jxlstm, f"{kind}_prefill")(p, jc, x))
    jdec = jax.jit(lambda p, x, s: getattr(jxlstm, f"{kind}_decode")(
        p, jc, x, s))
    tpre = getattr(txlstm, f"{kind}_prefill")
    tdec = getattr(txlstm, f"{kind}_decode")
    x = _x((2, 20, tc.d_model), seed=3 + layer)
    jy, jst = jpre(jl, jnp.asarray(x[:, :16]))
    ty, tst = tpre(tl, tc, torch.from_numpy(x[:, :16]))
    _close(ty, jy, LAYER_TOL)
    for t in range(16, 20):
        assert tst._fields == jst._fields
        for a, b in zip(tst, jst):
            _close(a, b, LAYER_TOL)
        jy, jst = jdec(jl, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = tdec(tl, tc, torch.from_numpy(x[:, t:t + 1]), tst)
        _close(ty, jy, LAYER_TOL)
    for a, b in zip(tst, jst):
        _close(a, b, LAYER_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_matches_reference_shapes_and_dtypes(pair, kind):
    """The reference's leaf names, shapes and dtypes under bf16 params
    (the mLSTM's gate weights and biases and the sLSTM's ``b_in`` stay
    f32; the reference's shapes by ``jax.eval_shape``), and its
    deterministic leaves exactly; the mLSTM's head dim is d_inner //
    n_heads."""
    jc = jcfgs.get_smoke_config(ARCH).replace(param_dtype="bfloat16")
    tc = tcfgs.get_smoke_config(ARCH).replace(param_dtype="bfloat16")
    want = jax.eval_shape(lambda k: getattr(jxlstm, f"{kind}_init")(k, jc),
                          jax.random.key(1))
    got = getattr(txlstm, f"{kind}_init")(torch.Generator().manual_seed(1),
                                          tc)
    names = dict(got.named_parameters())
    assert set(names) == set(want)
    for name, t in names.items():
        w = want[name]
        assert tuple(t.shape) == w.shape, name
        assert str(t.dtype).split(".")[1] == str(w.dtype), name
    # The reference's values of the leaves its init fixes (its f32 tree).
    jref = jax.jit(lambda k: getattr(jxlstm, f"{kind}_init")(
        k, jc.replace(param_dtype="float32")))(jax.random.key(1))
    fixed = {"mlstm": ("conv_b", "b_igate", "b_fgate", "gn_scale"),
             "slstm": ("b_in", "gn_scale")}[kind]
    for name in fixed:
        np.testing.assert_array_equal(_np(names[name]), _np(jref[name]))
    if kind == "mlstm":
        for name in ("w_igate", "b_igate", "w_fgate", "b_fgate"):
            assert names[name].dtype == torch.float32, name
        assert txlstm._mlstm_dims(tc)[2] == 64 != tc.hd


def test_a_long_prompt_off_the_chunk_raises(pair):
    """Over 64 tokens an mLSTM sequence must be a multiple of the chunk, as
    the reference asserts; the port says so in a ValueError, from the
    mixer and from ``prefill``."""
    _, _, tc, model = pair
    _, tl = _layer(pair, 0)
    x = torch.zeros((1, 100, tc.d_model))
    with pytest.raises(ValueError, match=r"multiple of it .*S=100"):
        txlstm.mlstm_forward(tl, tc, x)
    with pytest.raises(ValueError, match=r"mlstm scan.*S=100"):
        tmodels.prefill(model, tc, torch.zeros((1, 100), dtype=torch.long),
                        max_len=128)
    assert txlstm.mlstm_forward(tl, tc, x[:, :40]).shape == (1, 40,
                                                             tc.d_model)
    assert txlstm.mlstm_forward(tl, tc, torch.zeros((1, 128, tc.d_model))
                                ).shape == (1, 128, tc.d_model)


# ------------------------------------------------------------- the stack

def test_xlstm_builds_at_full_width_with_the_reference_shapes():
    """xlstm-125m at full width and depth builds on the meta device with
    the reference's leaf shapes (its ``params_shape``, 2 superblocks of
    the period-6 pattern) and their total, 1.968e8 (the reference's
    ``param_count()``, 1.353e8, counts the mLSTM's cq, ck and cv as
    block-diagonal over the heads; its leaves are whole d_inner x d_inner
    matrices); xLSTM blocks have no FFN sublayer."""
    from repro.models import transformer as jtr
    jc, tc = jcfgs.get_config(ARCH), tcfgs.get_config(ARCH)
    model = tmodels.Transformer(tc, device="meta")
    assert [type(b.mixer).__name__ for b in model.blocks[:6]] == [
        "MLSTM", "SLSTM", "MLSTM", "MLSTM", "MLSTM", "MLSTM"]
    assert all(b.ffn is None and not hasattr(b, "ln2")
               for b in model.blocks)
    want = jtr.params_shape(jc)
    p = ttransformer.pattern_period(tc)
    assert p == jtr.pattern_period(jc) == 6
    for i, bp in enumerate(model.blocks):
        shapes = jax.tree.map(lambda t: tuple(t.shape),
                              ttransformer._block_leaves(bp))
        assert shapes == jax.tree.map(lambda s: s.shape[1:],
                                      want["blocks"][i % p]), i
    n = sum(t.numel() for t in model.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(want))
    assert 1.96e8 < n < 1.97e8
    assert tc.param_count() == jc.param_count() == 135_272_448
    assert not tmodels.supports_chunked_prefill(tc)


def test_forward_matches(pair):
    jc, jp, tc, model = pair
    toks = _tokens(24, jc.vocab_size, batch=2)
    want, _ = jax.jit(lambda p, t: jmodels.forward(p, jc, t))(
        jp, jnp.asarray(toks))
    got, aux = tmodels.forward(model, tc, torch.from_numpy(toks))
    _close(got, want)
    assert float(aux.load_balance_loss) == 0.0


def test_prefill_and_decode_match(pair, jengine):
    """Prefill of three 6-token prompts (the port's in one batch of 3, the
    reference's one row at a time) and 3 greedy decode steps of the batch,
    each step's logits; every state leaf of every layer after the last."""
    jc, jp, tc, model = pair
    toks = _tokens(6, jc.vocab_size, seed=1, batch=3)
    rows = [jengine._prefill_one(jp, jnp.asarray(toks[r:r + 1]))
            for r in range(3)]
    jl = jnp.concatenate([lg for lg, _ in rows], axis=0)
    # The reference stacks its caches (superblock, batch, ...): rows on 1.
    jcache = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=1),
                          *[c for _, c in rows])
    tl, tcache = tmodels.prefill(model, tc, torch.from_numpy(toks),
                                 max_len=32)
    _close(tl, jl)
    for i in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)
        pos = np.full((3,), 6 + i, np.int32)
        jl, jcache = jengine._decode(jp, jnp.asarray(nxt), jnp.asarray(pos),
                                     jcache)
        tl, tcache = tmodels.decode_step(model, tc, torch.from_numpy(nxt),
                                         torch.from_numpy(pos), tcache)
        _close(tl, jl)
    # Layer i is the reference's pattern position i (one superblock).
    for i, st in enumerate(tcache["self"]):
        assert st._fields == jcache["self"][i]._fields
        for a, b in zip(st, jcache["self"][i]):
            _close(a, np.asarray(b)[0])


def test_serving_equals_forward(pair):
    """A prefill of 64 tokens (one whole chunk) ends on ``forward``'s
    last logits; a prefill of 44 and four teacher-forced decode steps
    equal ``forward``'s logits over the 48 (a sequence up to the chunk is
    one chunk of its own length)."""
    _, _, tc, model = pair
    toks = torch.from_numpy(_tokens(64, tc.vocab_size, seed=2, batch=2))
    full, _ = tmodels.forward(model, tc, toks[:, :64])
    lg, caches = tmodels.prefill(model, tc, toks[:, :64], max_len=72)
    _close(lg[:, 0], full[:, 63])
    full, _ = tmodels.forward(model, tc, toks[:, :48])
    lg, caches = tmodels.prefill(model, tc, toks[:, :44], max_len=72)
    for i in range(4):
        lg, caches = tmodels.decode_step(model, tc, toks[:, 44 + i:45 + i],
                                         44 + i, caches)
        _close(lg[:, 0], full[:, 44 + i])


def test_params_round_trip(pair):
    """``params_from_jax`` -> ``params_to_numpy`` gives the tree it was
    given bit for bit, in the reference's structure and leaf shapes (its
    ``params_shape``): 6 pattern positions."""
    from repro.models import transformer as jtr
    jc, jp, tc, model = pair
    back = tmodels.params_to_numpy(model)
    want = jax.tree.map(np.asarray, jp)
    assert len(back["blocks"]) == len(want["blocks"]) == 6
    assert jax.tree.structure(back) == jax.tree.structure(want)
    assert jax.tree.map(np.shape, back) == jax.tree.map(
        lambda s: s.shape, jtr.params_shape(jc))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- serving

def test_engine_greedy_equals_reference(pair, jengine):
    """5 requests through 3 slots (queueing, continuous batching, a freed
    slot's mLSTM and sLSTM states replaced at install); prompts of one
    length, so the reference compiles one prefill."""
    jc, jp, tc, model = pair
    outs = []
    for e, req in ((jengine, jserving.GenerationRequest),
                   (ServeEngine(tc, model, max_batch=3, max_len=32),
                    GenerationRequest)):
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


def test_install_writes_a_slot_and_no_other(pair):
    """``_install`` copies every field of each layer's state (the mLSTM's
    C, n, m, conv; the sLSTM's c, n, h, m) into its slot of the shared
    cache, and leaves the other slots as they were (zero, the sLSTM's m
    at -10)."""
    _, _, tc, model = pair
    eng = ServeEngine(tc, model, max_batch=3, max_len=32)
    zero = tmodels.init_caches(tc, 3, 32, "cpu")
    toks = torch.from_numpy(_tokens(8, tc.vocab_size, seed=4))
    _, one = tmodels.prefill(model, tc, toks, max_len=32)
    req = GenerationRequest(request_id=0, prompt=toks[0].numpy(),
                            max_new_tokens=4)
    with torch.inference_mode():
        assert eng._install(1, req, one, 7)
    kinds = set()
    for full, z, src in zip(eng._caches["self"], zero["self"], one["self"]):
        kinds.add(type(full).__name__)
        for name, dst, z0, s in zip(full._fields, full, z, src):
            assert torch.equal(dst[1:2], s.to(dst.dtype)), name
            assert torch.equal(dst[0::2], z0[0::2]), name
            assert s.abs().sum() > 0 or name == "m", name
    assert kinds == {"MLSTMState", "SLSTMState"}
    assert float(eng._caches["self"][SLSTM_LAYER].m[0].max()) == -10.0
