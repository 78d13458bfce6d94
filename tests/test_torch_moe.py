"""The port's MoE FFN and the MoE models against the JAX reference, on the
CPU.

Both packages run the same weights: the reference's ``init_params`` tree
(or one layer's ``moe`` leaves), moved into the port by
``params_from_jax``.  Inputs are made with a seeded numpy generator and
cross as numpy arrays.  Configs are the SMOKE qwen2-moe-a2.7b (8 experts
top-4, 2 shared, gated) and phi3.5-moe (4 experts top-2) in f32 compute:
routing is discontinuous (a one-ulp change in a router logit can flip an
expert), so the routing is held equal, not close, and only f32 compute
keeps the two packages on the same side of every choice.

The reference's functions run under ``jax.jit``: compiled once, they take
a fraction of their eager time here.

Tolerances: outputs within 1e-4 of the reference's largest entry (f32
sums in another order through two layers; the gaps measured here are near
1e-6); the aux values, which are means of probabilities and counts, to
1e-6.  On the CPU the port's attention runs ``flash_ref``: the flash
kernel's launch count does not move.
"""
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving import compress as jcompress  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.kernels.flash.kernel import LAUNCHES  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.serving import (GenerationRequest, ServeEngine,  # noqa: E402
                                 compress_params, compression_report)
from repro_torch.serving.compress import LowRankWeight  # noqa: E402
from torch_ranks import pin_threads  # noqa: E402

pin_threads()

TOL = 1e-4
AUX_TOL = 1e-6
ARCHS = ["qwen2_moe_a2_7b", "phi35_moe"]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max |got - want| = {err} > {tol} * {scale}"


def _aux_close(got, want):
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= AUX_TOL, (float(g), float(w))


def _cfgs(arch, **edit):
    jc = jcfgs.get_smoke_config(arch).replace(dtype="float32", **edit)
    tc = tcfgs.get_smoke_config(arch).replace(dtype="float32", **edit)
    return jc, tc


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference cfg, reference params, port cfg, port model)."""
    arch = request.param
    jc, tc = _cfgs(arch)
    jp = jmodels.init_params(jax.random.key(0), jc)
    model = tmodels.params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                    device="cpu")
    return arch, jc, jp, tc, model


def _tokens(n, vocab, seed=0, batch=1):
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, n)).astype(np.int32)


def _leaf(tree, name):
    """The reference leaf that the port's parameter ``name`` is a slice of
    (blocks stacked along a leading layer axis)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        node = tree["blocks"][0]
        for key in parts[2:]:
            node = node[key]
        return np.asarray(node)[int(parts[1])]
    node = tree
    for key in parts:
        node = node[key]
    return np.asarray(node)


# ----------------------------------------------------------------- moe_ffn

def _moe_pair(jc, tc, jp, router_edit=None):
    """Layer 0's ``moe`` leaves as numpy (the router optionally edited), as
    the reference's dict and as the port's ``MoE`` module."""
    leaves = jax.tree.map(lambda a: np.array(a[0]), jp["blocks"][0]["moe"])
    if router_edit is not None:
        leaves["router"] = router_edit(leaves["router"])
    mod = tmoe.MoE(tc)
    for name, t in mod.named_parameters():
        node = leaves
        for key in name.split("."):
            node = node[key]
        t.copy_(torch.from_numpy(node))
    return jax.tree.map(jnp.asarray, leaves), mod


def _reference_routing(jc, p, x, gs):
    """The reference's top-k and keep mask for ``x`` in groups of ``gs``."""
    B, S, d = x.shape
    G = B * S // gs
    probs = jax.nn.softmax(jnp.asarray(x).reshape(G, gs, d) @ p["router"],
                           axis=-1)
    _, top_i = jax.lax.top_k(probs, jc.n_experts_active)
    C = jmoe.moe_capacity(jc, gs)
    _, keep = jax.vmap(lambda e: jmoe._dispatch_indices(
        e, jc.n_experts, C))(top_i.reshape(G, -1).astype(jnp.int32))
    return np.asarray(top_i), np.asarray(keep)


def _overflow(router):
    """Every input entry has mean 1 (below), so a router column of 0.5s
    gives expert 0 a logit near d/2: every token's first choice."""
    router = router.copy()
    router[:, 0] = 0.5
    return router


@pytest.mark.parametrize("case", ["default", "overflow", "group_size=B"])
def test_moe_ffn_matches_the_reference(pair, case):
    """y, the routing (top-k indices and keep mask, equal) and the aux
    values, at the default capacity (24-token groups), with expert 0
    overflowing (the same pairs dropped), and one decode-shaped group of
    the whole batch."""
    _, jc, jp, tc, _ = pair
    p, mod = _moe_pair(jc, tc, jp,
                       _overflow if case == "overflow" else None)
    rng = np.random.default_rng(7)
    shape, gs = ((6, 1, 64), 6) if case == "group_size=B" else ((2, 24, 64),
                                                                None)
    x = rng.standard_normal(shape).astype(np.float32)
    if case == "overflow":
        x += 1.0
    want, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(p, jc, x, group_size=gs))(
        p, jnp.asarray(x))
    got, aux = tmoe.moe_ffn(mod, tc, torch.from_numpy(x), group_size=gs)
    assert got.dtype == torch.float32
    _close(got, want)
    _aux_close(aux, jaux)
    gs = gs or shape[1]
    xt = torch.from_numpy(x).reshape(-1, gs, 64)
    _, _, top_i = tmoe.route(mod, tc, xt)
    _, keep = tmoe.dispatch_indices(top_i.reshape(xt.shape[0], -1),
                                    tc.n_experts, tmoe.moe_capacity(tc, gs))
    want_i, want_keep = _reference_routing(jc, p, x, gs)
    np.testing.assert_array_equal(top_i.numpy(), want_i)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if case == "overflow":
        assert float(aux.dropped_fraction) > 0.05
        assert (top_i[..., 0] == 0).all()


def test_top_k_ties_break_toward_the_lower_index():
    """Two equal router columns give every token two equal
    probabilities: the port's k order equals ``jax.lax.top_k``'s on the
    same probabilities (the larger first, then the lower index), and both
    tied experts are among the chosen for some tokens."""
    jc, tc = _cfgs("qwen2_moe_a2_7b")
    jp = {"blocks": ({"moe": jax.tree.map(
        lambda a: np.asarray(a)[None], jmoe.moe_init(jax.random.key(2), jc))},
    )}

    def tie(router):
        router = router.copy()
        router[:, 5] = router[:, 2]
        return router
    _, mod = _moe_pair(jc, tc, jp, tie)
    x = np.random.default_rng(3).standard_normal((3, 16, 64)).astype(
        np.float32)
    probs, top_p, top_i = tmoe.route(mod, tc, torch.from_numpy(x))
    assert torch.equal(probs[..., 2], probs[..., 5])
    _, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), tc.n_experts_active)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(want_i))
    both = ((top_i == 2).any(-1) & (top_i == 5).any(-1))
    assert int(both.sum()) > 0
    # A hand-made tie of every kind: equal top values, equal k-th values.
    planted = torch.tensor([[[0.1, 0.3, 0.1, 0.3, 0.1, 0.0, 0.1, 0.0]]])
    _, want_i = jax.lax.top_k(jnp.asarray(planted.numpy()), 4)
    vals, idx = torch.sort(planted, dim=-1, descending=True, stable=True)
    np.testing.assert_array_equal(idx[..., :4].numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(idx[..., :4].numpy(), [[[1, 3, 0, 2]]])


def test_moe_ffn_rejects_a_group_that_does_not_divide():
    jc, tc = _cfgs("phi35_moe")
    mod = tmoe.MoE(tc).init_(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="group_size 5"):
        tmoe.moe_ffn(mod, tc, torch.zeros((2, 6, 64)), group_size=5)


def test_moe_init_matches_reference_shapes_and_scales():
    """The same leaves, shapes and dtypes as the reference's ``moe_init``
    (the router f32 under bf16 params), and in both packages each leaf's
    sample std at the reference's scale: d^-0.5, and the hidden width's
    ^-0.5 for the down projections (different draws: torch's generator).
    d_model 256, so that the smallest leaf (``shared_gate``, d x 1) has
    256 draws; the bound is 5 standard errors of a sample std,
    5 / sqrt(2 n)."""
    for arch in ARCHS:
        edit = dict(param_dtype="bfloat16", d_model=256)
        jc = jcfgs.get_smoke_config(arch).replace(**edit)
        tc = tcfgs.get_smoke_config(arch).replace(**edit)
        mod = tmoe.MoE(tc).init_(torch.Generator().manual_seed(0))
        want = {".".join(str(getattr(k, "key", k)) for k in path): v
                for path, v in jax.tree_util.tree_flatten_with_path(
                    jax.jit(lambda k: jmoe.moe_init(k, jc))(
                        jax.random.key(0)))[0]}
        got = dict(mod.named_parameters())
        assert set(got) == set(want)
        for name, w in want.items():
            g = got[name].float().numpy()
            assert g.shape == w.shape, name
            assert str(got[name].dtype).split(".")[-1] == str(w.dtype), name
            scale = (w.shape[-2] ** -0.5 if name.endswith("w_down")
                     else jc.d_model ** -0.5)
            bound = 5 / np.sqrt(2 * g.size)
            for sample in (g, np.asarray(w, dtype=np.float32)):
                assert abs(sample.std() / scale - 1) < bound, name
        assert mod.router.dtype == torch.float32


# ------------------------------------------------------------ whole model

def test_forward_matches(pair):
    """Logits and the aux values (summed over the MoE layers and divided
    by their number)."""
    _, jc, jp, tc, model = pair
    toks = _tokens(20, jc.vocab_size, batch=2)
    want, jaux = jax.jit(lambda p, t: jmodels.forward(p, jc, t))(
        jp, jnp.asarray(toks))
    got, aux = tmodels.forward(model, tc, torch.from_numpy(toks))
    _close(got, want)
    _aux_close(aux, jaux)
    assert float(aux.load_balance_loss) > 0


def test_prefill_and_decode_match(pair):
    """Prefill of a 12-token batch of 2 and 3 greedy decode steps (the
    whole batch one dispatch group), each step's logits."""
    _, jc, jp, tc, model = pair
    toks = _tokens(12, jc.vocab_size, seed=1, batch=2)
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
        pos = np.full((2,), 12 + i, np.int32)
        jl, jcache = jdecode(jp, jnp.asarray(nxt), jnp.asarray(pos), jcache)
        tl, tcache = tmodels.decode_step(model, tc, torch.from_numpy(nxt),
                                         torch.from_numpy(pos), tcache)
        _close(tl, jl)
    assert LAUNCHES.count == before       # CPU: the plain version


def test_prefill_chunk_matches(pair):
    """A 37-token prompt in chunks of 8 against the reference's own chunks
    (each chunk one dispatch group on both sides)."""
    _, jc, jp, tc, model = pair
    toks = _tokens(37, jc.vocab_size, seed=5)
    jchunk = jax.jit(lambda p, t, p0, c: jmodels.prefill_chunk(p, jc, t, p0,
                                                                c))
    jcache = jmodels.init_caches(jc, 1, 64)
    tcache = tmodels.init_caches(tc, 1, 64, "cpu")
    for p0 in range(0, 37, 8):
        jl, jcache = jchunk(jp, jnp.asarray(toks[:, p0:p0 + 8]),
                            jnp.int32(p0), jcache)
        tl, tcache = tmodels.prefill_chunk(
            model, tc, torch.from_numpy(toks[:, p0:p0 + 8]), p0, tcache)
        _close(tl, jl)
    _close(tcache["self"][1].k, jcache["self"][0].k[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_equals_forward_at_dropless_capacity(arch):
    """At a dropless capacity (factor 8, as the reference's own test) the
    groups no longer matter: prefill and two teacher-forced decode steps
    equal ``forward``'s logits, and chunked prefill equals the one-shot."""
    jc, tc = _cfgs(arch, moe_capacity_factor=8.0)
    model = tmodels.init_params(0, tc, device="cpu")
    toks = torch.from_numpy(_tokens(14, tc.vocab_size, seed=2, batch=2))
    full, aux = tmodels.forward(model, tc, toks)
    assert float(aux.dropped_fraction) == 0.0
    lg, caches = tmodels.prefill(model, tc, toks[:, :12], max_len=16)
    _close(lg[:, 0], full[:, 11])
    for i in range(2):
        lg, caches = tmodels.decode_step(model, tc, toks[:, 12 + i:13 + i],
                                         12 + i, caches)
        _close(lg[:, 0], full[:, 12 + i])
    chunked = tmodels.init_caches(tc, 2, 16, "cpu")
    for p0 in range(0, 12, 5):
        lc, chunked = tmodels.prefill_chunk(model, tc, toks[:, p0:min(p0 + 5,
                                                                      12)],
                                            p0, chunked)
    _close(lc, full[:, 11:12])


def test_params_round_trip(pair):
    """``params_from_jax`` -> ``params_to_numpy`` gives the reference's
    tree bit for bit (the (L, E, d, f) expert stacks unstacked a layer at
    a time and stacked back), and the router stays f32 under bf16
    params."""
    arch, jc, jp, tc, model = pair
    back = tmodels.params_to_numpy(model)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert tuple(model.blocks[1].moe.w_down.shape) == \
        want["blocks"][0]["moe"]["w_down"].shape[1:]
    bf = tmodels.params_from_jax(want, tc.replace(param_dtype="bfloat16"),
                                 device="cpu")
    assert bf.blocks[0].moe.router.dtype == torch.float32
    assert bf.blocks[0].moe.w_gate.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.blocks[0].moe.router.numpy(),
                                  want["blocks"][0]["moe"]["router"][0])


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


TRAIN = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)


@pytest.fixture(scope="module")
def reference_training(pair):
    """The reference's ``loss_fn`` value and gradients and one step of its
    ``make_train_step`` from the same weights and batch, in one
    ``jax.jit`` (one compile for both); and the batch."""
    _, jc, jp, _, _ = pair
    batch = _batch(jc, 2, 24)
    jt = jsteps.TrainConfig(**TRAIN)
    jstep = jsteps.make_train_step(jc, jt, make_host_mesh(), 2)
    jstate = jsteps.TrainState(
        params=jp, opt=jsteps.adamw_init(jp),
        ef=jax.tree.map(lambda _: jnp.zeros((), jnp.float32), jp),
        step=jnp.zeros((), jnp.int32))

    def both(state, b):
        grads = jax.value_and_grad(lambda p: jtransformer.loss_fn(p, jc, b),
                                   has_aux=True)(state.params)
        return grads, jstep(state, b)
    ((total, metrics), grads), (new, step_metrics) = jax.jit(both)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, total, metrics, grads, new, step_metrics


def test_loss_fn_metrics_and_grads_match(pair, reference_training):
    """``loss_fn``'s metrics (``moe_lb``, ``moe_drop`` among them) and every
    parameter's gradient, the router's and the experts' included."""
    _, jc, jp, tc, model = pair
    batch, jtotal, jmetrics, jgrads, _, _ = reference_training
    model.requires_grad_(True)
    try:
        total, metrics = tmodels.loss_fn(
            model, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(total, params)
    finally:
        model.requires_grad_(False)
    assert set(metrics) == set(jmetrics)
    for key in metrics:
        _close(metrics[key], jmetrics[key])
    assert float(metrics["moe_lb"].detach()) > 0
    _close(total, jtotal)
    for name, g in zip(names, grads):
        _close(g, _leaf(jgrads, name))


def test_train_step_matches_the_reference_step(pair, reference_training):
    """One step of each package's ``make_train_step`` from the same
    weights and batch: new parameters, ``grad_norm``, ``lr``, the loss and
    the MoE metrics."""
    _, jc, jp, tc, _ = pair
    batch, _, _, _, jnew, jm = reference_training
    model = tmodels.params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                    device="cpu").requires_grad_(True)
    params = dict(model.named_parameters())
    state = tsteps.TrainState(model, adamw_init(params),
                              {k: torch.zeros(()) for k in params},
                              torch.zeros((), dtype=torch.int32))
    new, m = tsteps.make_train_step(tc, tsteps.TrainConfig(**TRAIN))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(new.step) == int(jnew.step) == 1
    for key in ("loss", "grad_norm", "lr", "moe_lb", "moe_drop"):
        _close(m[key], jm[key])
    for name, p in new.params.named_parameters():
        _close(p, _leaf(jnew.params, name), TOL * 10)


# ------------------------------------------------------- engine, compress

def test_engine_greedy_equals_reference():
    """SMOKE qwen2-moe: 5 requests through 3 slots (queueing, continuous
    batching; decode routes the whole batch as one group); prompts of one
    length, so the reference compiles one prefill."""
    jc, tc = _cfgs("qwen2_moe_a2_7b")
    jp = jmodels.init_params(jax.random.key(0), jc)
    model = tmodels.params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                    device="cpu")
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


def test_compress_factors_expert_stacks_per_slice_like_reference():
    """SMOKE qwen2-moe at d_model 128 with 4 experts of width 128 and one
    shared expert, so that every eligible slice is 128 x 128 (the
    reference compiles its probing RSVD once, and a Gaussian slice's top-4
    energy, about 0.11, is far under 0.95 whatever the draw), and planted
    exactly rank-4 expert slices: ``w_gate``
    rank 4 in every layer and expert is factored per slice, B (E, m, 4)
    and P (E, 4, n); ``w_up`` rank 4 but for one expert of one layer (a
    flat-spectrum Gaussian, top-4 energy far under 0.95) stays dense in
    every layer, as the reference keeps a stack only if every slice
    passes.  The decisions and the report's totals equal the
    reference's."""
    jc, tc = _cfgs("qwen2_moe_a2_7b", d_model=128, n_experts=4,
                   n_experts_active=2, moe_d_ff=128, n_shared_experts=1)
    rng = np.random.default_rng(4)
    # The reference's tree with the port's draws (its own init would
    # compile for this config).
    jp = tmodels.params_to_numpy(tmodels.init_params(3, tc, device="cpu"))
    moe = jp["blocks"][0]["moe"]
    L, E, d, f = moe["w_gate"].shape

    def rank4(m, n):
        return (rng.standard_normal((m, 4)) @ rng.standard_normal((4, n))
                ).astype(np.float32)
    moe["w_gate"] = np.stack([np.stack([rank4(d, f) for _ in range(E)])
                              for _ in range(L)])
    moe["w_up"] = np.stack([np.stack([rank4(d, f) for _ in range(E)])
                            for _ in range(L)])
    moe["w_up"][1, 3] = rng.standard_normal((d, f)).astype(np.float32)
    model = tmodels.params_from_jax(jp, tc, device="cpu")
    out, report = compress_params(0, model, rank=4)
    jout, jrep = jcompress.compress_params(
        jax.random.key(0), jax.tree.map(jnp.asarray, jp), rank=4)

    def ref_name(key):     # "['blocks'][0]['moe']['w_up']" -> the port's
        parts = re.findall(r"\['?([^\]']+)'?\]", key)
        return ".".join(["blocks", "*"] + parts[2:])
    assert {ref_name(k): r["compressed"] for k, r in jrep.items()} == \
        {k: r["compressed"] for k, r in report.items()}
    assert report["blocks.*.moe.w_gate"]["compressed"]
    assert not report["blocks.*.moe.w_up"]["compressed"]
    assert len(report) == 10            # 4 attention, 3 routed, 3 shared
    assert compression_report(report) == compression_report(jrep)
    for i in range(L):
        lw = out.blocks[i].moe.w_gate
        assert isinstance(lw, LowRankWeight)
        assert tuple(lw.B.shape) == (E, d, 4) and tuple(lw.P.shape) == (
            E, 4, f)
        assert lw.shape == (E, d, f)
        _close(lw.materialize(), moe["w_gate"][i], 1e-4)
        assert isinstance(out.blocks[i].moe.w_up, torch.nn.Parameter)
    assert isinstance(model.blocks[0].moe.w_gate, torch.nn.Parameter)
