"""The port's whisper encoder-decoder (LayerNorm, the audio frontend,
cross-attention) and qwen2-vl (the vision frontend, M-RoPE) against the
JAX reference, on the CPU.

Both packages run the same weights: drawn by the port, carried across as
the reference's tree by ``params_to_numpy`` / ``params_from_jax``.  Inputs (tokens, encoder
frames, patch embeddings, (t, h, w) position ids) are made with a seeded
numpy generator and cross as numpy arrays.  The configs are the SMOKE
whisper-tiny (2 encoder and 2 decoder layers, d_model 48, 24 frames) and
qwen2-vl-2b (2 layers, d_model 96, GQA 4/2, M-RoPE sections (4, 4, 4)) in
f32 compute.  The reference's functions run under ``jax.jit``.

Tolerances, of the reference's largest entry: a single op 2e-5 (f32 sums
in another order); a whole model 1e-4 (as the other stacks' tests).  The
rope tables are held at 1e-6 (one f32 product and a cos or sin each);
the text M-RoPE tables equal plain RoPE's exactly.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import norms as jnorms  # noqa: E402
from repro.models import rope as jrope  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import norms as tnorms  # noqa: E402
from repro_torch.models import rope as trope  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.serving import GenerationRequest, ServeEngine  # noqa: E402
from torch_ranks import pin_threads  # noqa: E402

pin_threads()

OP_TOL = 2e-5
TOL = 1e-4
WHISPER, VLM = "whisper_tiny", "qwen2_vl_2b"


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max |got - want| = {err} > {tol} * {scale}"


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(n, vocab, seed=0, batch=1):
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, n)).astype(np.int32)


_PAIRS: dict = {}


def _pair(arch):
    """(reference cfg, reference params, port cfg, port model), built once
    a module.  The port draws the weights and hands the reference its tree
    (``params_to_numpy``): the reference's own init would compile."""
    if arch not in _PAIRS:
        jc = jcfgs.get_smoke_config(arch).replace(dtype="float32")
        tc = tcfgs.get_smoke_config(arch).replace(dtype="float32")
        jp = tmodels.params_to_numpy(tmodels.init_params(0, tc, device="cpu"))
        model = tmodels.params_from_jax(jp, tc, device="cpu")
        _PAIRS[arch] = (jc, jax.tree.map(jnp.asarray, jp), tc, model)
    return _PAIRS[arch]


def _frames(cfg, batch=2, seed=7):
    return _x((batch, cfg.n_frontend_tokens, cfg.d_model), seed)


def _vlm_inputs(cfg, batch=2, seed=8):
    """An image of 2 x 4 patches (t = 0, h in 0..1, w in 0..3) before 12
    text tokens whose three ids all run on from 4: distinct (t, h, w) ids,
    patch embeddings on the image tokens and zeros on the text."""
    n_img, n_txt = 8, 12
    hh, ww = np.divmod(np.arange(n_img), 4)
    txt = 4 + np.arange(n_txt)
    pos = np.stack([np.concatenate([np.zeros(n_img, int), txt]),
                    np.concatenate([hh, txt]),
                    np.concatenate([ww, txt])]).astype(np.int32)
    pos = np.broadcast_to(pos[:, None], (3, batch, n_img + n_txt)).copy()
    patches = np.zeros((batch, n_img + n_txt, cfg.d_model), np.float32)
    patches[:, :n_img] = _x((batch, n_img, cfg.d_model), seed)
    return _tokens(n_img + n_txt, cfg.vocab_size, seed, batch), pos, patches


# -------------------------------------------------------------- the pieces

def test_layernorm_matches():
    """Population variance (ddof 0) as ``jnp.var``, eps 1e-5, scale and
    bias."""
    rng = np.random.default_rng(1)
    x = (3 + 2 * rng.standard_normal((2, 5, 48))).astype(np.float32)
    scale, bias = (rng.standard_normal(48).astype(np.float32)
                   for _ in range(2))
    want = jnorms.layernorm({"scale": jnp.asarray(scale),
                             "bias": jnp.asarray(bias)}, jnp.asarray(x), 1e-5)
    p = tnorms.LayerNorm(48, torch.float32)
    p.scale.data, p.bias.data = torch.from_numpy(scale), torch.from_numpy(bias)
    _close(tnorms.layernorm(p, torch.from_numpy(x), 1e-5), want, OP_TOL)
    fresh = tnorms.LayerNorm(48, torch.bfloat16)
    assert fresh.scale.dtype == fresh.bias.dtype == torch.bfloat16
    assert float(fresh.scale.sum()) == 48 and float(fresh.bias.abs().sum()) == 0


def test_mrope_tables_match_and_text_equals_rope():
    """M-RoPE tables on distinct (t, h, w) ids, qwen2-vl's full sections
    (16, 24, 24) over hd 128; on text ids (t == h == w) they equal plain
    RoPE's bit for bit; sections that miss hd // 2 raise."""
    _, pos, _ = _vlm_inputs(tcfgs.get_smoke_config(VLM))
    jc, js = jrope.mrope_cos_sin(jnp.asarray(pos), 128, 1e6, (16, 24, 24))
    tc, ts = trope.mrope_cos_sin(torch.from_numpy(pos), 128, 1e6,
                                 (16, 24, 24))
    _close(tc, jc, 1e-6)
    _close(ts, js, 1e-6)
    p3 = trope.text_mrope_positions(2, 9, 5)
    assert p3.shape == (3, 2, 9)
    np.testing.assert_array_equal(
        p3.numpy(), np.asarray(jrope.text_mrope_positions(2, 9, 5)))
    c3, s3 = trope.mrope_cos_sin(p3, 128, 1e6, (16, 24, 24))
    c1, s1 = trope.rope_cos_sin(trope.text_positions(2, 9, 5), 128, 1e6)
    assert torch.equal(c3, c1) and torch.equal(s3, s1)
    with pytest.raises(ValueError, match="sum to head_dim // 2 = 64"):
        trope.mrope_cos_sin(p3, 128, 1e6, (16, 24, 16))


def test_cross_attention_matches():
    """A decoder layer's cross-attention against encoder states:
    ``attention(..., xattn_kv=)`` over 5 queries, ``encoder_kv`` and
    ``cross_attention_decode`` for one; the decode equals the full
    cross-attention's row."""
    jc, jp, tc, model = _pair(WHISPER)
    jl = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                      jp["blocks"][0]["cross"])
    tl = model.blocks[0].cross
    assert not hasattr(tl, "bq")
    enc = _x((2, tc.n_frontend_tokens, tc.d_model), 3)
    x = _x((2, 5, tc.d_model), 4)
    want = jax.jit(lambda p, x, e: jattn.attention(
        p, jc, x, None, None, xattn_kv=e))(jl, jnp.asarray(x),
                                            jnp.asarray(enc))
    full = tattn.attention(tl, tc, torch.from_numpy(x), None, None,
                           xattn_kv=torch.from_numpy(enc))
    _close(full, want, OP_TOL)
    jkv = jax.jit(lambda p, e: jattn.encoder_kv(p, jc, e))(jl,
                                                          jnp.asarray(enc))
    tkv = tattn.encoder_kv(tl, tc, torch.from_numpy(enc))
    for a, b in zip(tkv, jkv):
        _close(a, b, OP_TOL)
    want = jax.jit(lambda p, x, kv: jattn.cross_attention_decode(
        p, jc, x, kv))(jl, jnp.asarray(x[:, -1:]), jkv)
    got = tattn.cross_attention_decode(tl, tc, torch.from_numpy(x[:, -1:]),
                                       tkv)
    _close(got, want, OP_TOL)
    _close(got, full[:, -1:], OP_TOL)


# ----------------------------------------------------------------- whisper

def test_whisper_forward_matches():
    jc, jp, tc, model = _pair(WHISPER)
    toks = _tokens(10, jc.vocab_size, batch=2)
    frames = _frames(tc)
    want, _ = jax.jit(lambda p, t, f: jmodels.forward(p, jc, t, frames=f))(
        jp, jnp.asarray(toks), jnp.asarray(frames))
    got, _ = tmodels.forward(model, tc, torch.from_numpy(toks),
                             frames=torch.from_numpy(frames))
    _close(got, want)
    with pytest.raises(ValueError, match="encoder-decoder: pass frames="):
        tmodels.forward(model, tc, torch.from_numpy(toks))


def test_whisper_prefill_and_decode_match():
    """Prefill of 8 tokens (batch 2) with the encoder frames, then 3 greedy
    decode steps against the cached cross K/V: each step's logits, the
    cross caches and the self-attention caches after the last."""
    jc, jp, tc, model = _pair(WHISPER)
    toks = _tokens(8, jc.vocab_size, seed=1, batch=2)
    frames = _frames(tc, seed=2)
    jl, jcache = jax.jit(lambda p, t, f: jmodels.prefill(
        p, jc, t, max_len=16, frames=f))(jp, jnp.asarray(toks),
                                         jnp.asarray(frames))
    jdecode = jax.jit(lambda p, t, pos, c: jmodels.decode_step(p, jc, t, pos,
                                                                c))
    tl, tcache = tmodels.prefill(model, tc, torch.from_numpy(toks),
                                 max_len=16, frames=torch.from_numpy(frames))
    _close(tl, jl)
    for i in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)
        pos = np.full((2,), 8 + i, np.int32)
        jl, jcache = jdecode(jp, jnp.asarray(nxt), jnp.asarray(pos), jcache)
        tl, tcache = tmodels.decode_step(model, tc, torch.from_numpy(nxt),
                                         torch.from_numpy(pos), tcache)
        _close(tl, jl)
    # One pattern position: the reference stacks the layers on its axis 0.
    for i in range(tc.n_layers):
        for a, b in zip(tcache["cross"][i], jcache["cross"][0]):
            _close(a, np.asarray(b)[i])
        _close(tcache["self"][i].k, np.asarray(jcache["self"][0].k)[i])
    zero = tmodels.init_caches(tc, 2, 16, "cpu")
    assert [tuple(t.shape) for t in zero["cross"][0]] == [
        (2, tc.n_frontend_tokens, tc.n_kv_heads, tc.hd)] * 2


# ---------------------------------------------------------------- qwen2-vl

def test_vlm_forward_matches():
    """Patch embeddings on an image grid before the text, with distinct
    (t, h, w) ids (text ids alone run in the engine test below)."""
    jc, jp, tc, model = _pair(VLM)
    toks, pos, patches = _vlm_inputs(tc)
    fwd = jax.jit(lambda p, t, pos, pt: jmodels.forward(
        p, jc, t, positions=pos, patches=pt))
    want, _ = fwd(jp, jnp.asarray(toks), jnp.asarray(pos),
                  jnp.asarray(patches))
    got, _ = tmodels.forward(model, tc, torch.from_numpy(toks),
                             positions=torch.from_numpy(pos),
                             patches=torch.from_numpy(patches))
    _close(got, want)


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_loss_fn_with_frames_or_patches(arch):
    """``loss_fn`` passes frames (whisper), and patches and positions
    (qwen2-vl), through to ``forward``: the total and every metric."""
    jc, jp, tc, model = _pair(arch)
    if arch == WHISPER:
        toks = _tokens(10, tc.vocab_size, seed=5, batch=2)
        extra = {"frames": _frames(tc, seed=5)}
    else:
        toks, pos, patches = _vlm_inputs(tc, seed=5)
        extra = {"positions": pos, "patches": patches}
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels, **extra}
    want_total, want = jax.jit(lambda p, b: jmodels.loss_fn(p, jc, b))(
        jp, jax.tree.map(jnp.asarray, batch))
    total, got = tmodels.loss_fn(model, tc, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    assert abs(float(total) - float(want_total)) <= 1e-5 * abs(
        float(want_total))
    for key in want:
        assert abs(float(got[key]) - float(want[key])) <= 1e-5 * max(
            1.0, abs(float(want[key]))), key


# ------------------------------------------------------------ both models

@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_params_round_trip(arch):
    """``params_from_jax`` -> ``params_to_numpy`` gives the tree it was
    given bit for bit, in the reference's structure and leaf shapes (its
    ``params_shape``): the frontend, the encoder stack and its norm, the
    LayerNorm biases, ``ln_x`` and ``cross``."""
    from repro.models import transformer as jtr
    jc, jp, tc, model = _pair(arch)
    back = tmodels.params_to_numpy(model)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    assert jax.tree.map(np.shape, back) == jax.tree.map(
        lambda s: s.shape, jtr.params_shape(jc))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    if arch == WHISPER:
        assert back["enc_blocks"]["mlp"]["w_in"].shape[0] == \
            tc.n_encoder_layers
        assert set(back["blocks"][0]) == {"ln1", "mixer", "ln_x", "cross",
                                          "ln2", "mlp"}


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_builds_at_full_width_with_the_reference_shapes(arch):
    """whisper-tiny and qwen2-vl-2b at full width and depth build on the
    meta device with the reference's leaf shapes (its ``params_shape``)
    and their total."""
    from repro.models import transformer as jtr
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    model = tmodels.Transformer(tc, device="meta")
    want = jtr.params_shape(jc)
    got = ttransformer._top_leaves(model)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == jax.tree.map(
        lambda s: s.shape, {k: v for k, v in want.items()
                            if k not in ("blocks", "enc_blocks")})
    for i, bp in enumerate(model.blocks):
        shapes = jax.tree.map(lambda t: tuple(t.shape),
                              ttransformer._block_leaves(bp))
        assert shapes == jax.tree.map(lambda s: s.shape[1:],
                                      want["blocks"][0]), i
    for bp in getattr(model, "enc_blocks", ()):
        shapes = jax.tree.map(lambda t: tuple(t.shape),
                              ttransformer._block_leaves(bp))
        assert shapes == jax.tree.map(lambda s: s.shape[1:],
                                      want["enc_blocks"])
    n = sum(t.numel() for t in model.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(want))
    assert tc.param_count() == jc.param_count()


def test_engine_greedy_equals_reference_on_qwen2_vl():
    """qwen2-vl's text ids through both engines: 4 requests, 2 slots, the
    same greedy tokens."""
    jc, jp, tc, model = _pair(VLM)
    outs = []
    for eng, req, params, cfg in ((jserving.ServeEngine,
                                   jserving.GenerationRequest, jp, jc),
                                  (ServeEngine, GenerationRequest, model,
                                   tc)):
        e = eng(cfg, params, max_batch=2, max_len=24)
        rng = np.random.default_rng(1)
        reqs = [req(request_id=i, prompt=rng.integers(
                    0, jc.vocab_size, 6).astype(np.int32),
                    max_new_tokens=4) for i in range(4)]
        for r in reqs:
            e.submit(r)
        e.run()
        outs.append([(r.status, list(r.output)) for r in reqs])
    assert outs[0] == outs[1]
    assert all(s == "done" and len(o) == 4 for s, o in outs[1])


def test_engine_refuses_an_encoder_decoder():
    """A request carries no frames: the port's engine refuses whisper when
    it is built (the reference's fails at its first prefill)."""
    with pytest.raises(ValueError, match="whisper-tiny.*encoder-decoder.*"
                                         "no encoder frames"):
        ServeEngine(tcfgs.get_smoke_config(WHISPER), None, device="cpu")


@pytest.mark.parametrize("arch", ["xlstm-125m", "qwen2-vl-2b",
                                  "whisper-tiny"])
def test_launch_serve_cli(arch):
    """The serve CLI serves the SMOKE xlstm-125m and qwen2-vl-2b, and exits
    with the engine's refusal for whisper-tiny."""
    from repro_torch.launch import serve as tserve
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
            "--new-tokens", "3"]
    if arch == "whisper-tiny":
        with pytest.raises(SystemExit, match="encoder-decoder"):
            tserve.main(argv)
        return
    done = tserve.main(argv)
    assert [r.status for r in done] == ["done"] * 3
    assert all(len(r.output) == 3 for r in done)
