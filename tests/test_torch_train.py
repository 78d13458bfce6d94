"""The port's training path against the JAX reference, on the CPU.

Both packages run the same weights (the reference's ``init_params`` tree,
moved by ``params_from_jax``) on the same numpy inputs, SMOKE granite-3-2b
in f32.  Held to the reference: the flash op's values and gradients (the
port's ``FlashAttention`` on ``flash_ref`` against the reference's custom
VJP), ``loss_fn``'s metrics and per-leaf gradients on the dense and on the
blockwise path, and one ``make_train_step`` step.  The port's own
properties: the token generator, a loss that falls, bit-equal replay and
resume of ``train_loop``, RandLR compression within 5 % of the dense loss,
and the CLI.

Tolerances, each relative to the largest entry of the reference's array:
5e-5 for the attention (the reference test's own bar), 1e-4 for the loss
and gradients through two layers and for new parameters (f32 sums in
another order; the gaps measured here are near 1e-6).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.data import SyntheticConfig, batch_for_step  # noqa: E402
from repro_torch.kernels.flash import ops as tflash  # noqa: E402
from repro_torch.kernels.flash.ref import flash_ref  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.optim import CompressorConfig, adamw_init  # noqa: E402
from repro_torch.runtime import HostFailure  # noqa: E402
from torch_ranks import pin_threads  # noqa: E402

pin_threads()

ATTN_TOL = 5e-5
TOL = 1e-4
ARCH = "granite_3_2b"


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max |got - want| = {err} > {tol} * {scale}"


def _pair(cfg_edit=None):
    """(reference cfg, reference params, port cfg, port model with grads)."""
    jc = jcfgs.get_smoke_config(ARCH).replace(dtype="float32")
    tc = tcfgs.get_smoke_config(ARCH).replace(dtype="float32")
    if cfg_edit:
        jc, tc = jc.replace(**cfg_edit), tc.replace(**cfg_edit)
    jp = jmodels.init_params(jax.random.key(0), jc)
    model = tmodels.params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                    device="cpu")
    return jc, jp, tc, model.requires_grad_(True)


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                       # ignore-index entries
    return {"tokens": toks[:, :-1], "labels": labels}


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


# ------------------------------------------------- the flash op's gradient

@pytest.mark.parametrize("window", [None, 48])
def test_attention_blockwise_values_and_grads_match_the_reference(
        window, monkeypatch):
    """B=2, S=200, H=4, hd=16, kv blocks of 64 (four, the last ragged) on
    both sides (the port's ``BLOCK_KV`` patched): the forward and the
    three gradients."""
    monkeypatch.setattr(tflash, "BLOCK_KV", 64)
    B, S, H, hd = 2, 200, 4, 16
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.standard_normal((B, S, H * hd)).astype(np.float32)

    def jloss(q, k, v):
        out = jattn._attention_blockwise(q, k, v, causal=True, window=window,
                                         block=64)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tattn._attention_blockwise(tq, tk, tv, causal=True, window=window)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out, jout, ATTN_TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, want, ATTN_TOL)


@pytest.mark.parametrize("causal,window,dtype", [(True, None, torch.float32),
                                                 (True, 7, torch.bfloat16),
                                                 (False, None, torch.float32)])
def test_flash_function_equals_autograd_through_flash_ref(causal, window,
                                                          dtype):
    """The Function's backward (blocks of 16 keys, ragged T) against
    autograd through the dense ``flash_ref``; its ``lse`` against a dense
    logsumexp.  Tolerance 1e-5 of the largest entry (f32 sums in another
    order)."""
    g = torch.Generator().manual_seed(3)
    qf = torch.randn((3, 37, 8), generator=g) * 8 ** -0.5
    kf = torch.randn((3, 45, 8), generator=g).to(dtype)
    vf = torch.randn((3, 45, 8), generator=g).to(dtype)
    dout = torch.randn((3, 37, 8), generator=g)
    grads = []
    for fn in (lambda a, b, c: tflash.FlashAttention.apply(
                   a, b, c, causal, window, 16),
               lambda a, b, c: flash_ref(a, b, c, causal=causal,
                                         window=window)):
        a, b, c = (t.clone().requires_grad_(True) for t in (qf, kf, vf))
        out = fn(a, b, c)
        out.backward(dout)
        grads.append((out, a.grad, b.grad, c.grad))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        _close(got, want, 1e-5)
    _, lse = flash_ref(qf, kf, vf, causal=causal, window=window,
                       return_lse=True)
    s = torch.einsum("bqd,bkd->bqk", qf, kf.float())
    qpos, kpos = torch.arange(37)[:, None], torch.arange(45)[None]
    ok = (kpos <= qpos) if causal else torch.ones(37, 45, dtype=torch.bool)
    if window is not None:
        ok &= kpos > qpos - window
    _close(lse, torch.logsumexp(s.masked_fill(~ok, -torch.inf), -1), 1e-6)


def test_flash_function_asks_for_lse_only_for_a_gradient(monkeypatch):
    """Serving (no gradient wanted) runs the op without the logsumexp; a
    graph asks for it."""
    asked = []

    def spy(*a, **kw):
        asked.append(kw["return_lse"])
        return flash_ref(*a, **kw)

    monkeypatch.setattr(tflash, "flash_ref", spy)
    x = torch.randn((2, 10, 8))
    with torch.inference_mode():
        out = tflash.FlashAttention.apply(x, x, x, True, None, 4)
    torch.testing.assert_close(out, flash_ref(x, x, x), rtol=0, atol=0)
    tflash.FlashAttention.apply(x.requires_grad_(True), x, x, True, None, 4)
    assert asked == [False, True]


# --------------------------------------------------------------- loss_fn

@pytest.mark.parametrize("threshold", [None, 8])
def test_loss_fn_metrics_and_grads_match_the_reference(threshold,
                                                       monkeypatch):
    """The dense path, and the blockwise one (``BLOCKWISE_THRESHOLD``
    patched to 8 in both packages: the port's ``FlashAttention`` on its
    CPU path against the reference's custom VJP)."""
    if threshold is not None:
        monkeypatch.setattr(jattn, "BLOCKWISE_THRESHOLD", threshold)
        monkeypatch.setattr(tattn, "BLOCKWISE_THRESHOLD", threshold)
    jc, jp, tc, model = _pair()
    batch = _batch(jc, 2, 24)
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.loss_fn(p, jc, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    total, metrics = tmodels.loss_fn(
        model, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, params)
    assert set(metrics) == set(jmetrics)
    for key in metrics:
        _close(metrics[key], jmetrics[key])
    _close(total, jtotal)
    for name, g in zip(names, grads):
        _close(g, _leaf(jgrads, name))


# --------------------------------------------------------- the train step

def test_train_step_matches_the_reference_step():
    """One step of each package's ``make_train_step`` from the same
    weights and batch: new parameters, ``grad_norm``, ``lr`` and the loss.
    No warmup, so the step moves every parameter by about ``peak_lr``."""
    jc, jp, tc, model = _pair()
    jt = jsteps.TrainConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    tt = tsteps.TrainConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    batch = _batch(jc, 2, 24, seed=2)
    jstate = jsteps.init_train_state(jax.random.key(0), jc, jt)
    jstate = jstate._replace(params=jp, opt=jsteps.adamw_init(jp))
    jstep = jax.jit(jsteps.make_train_step(jc, jt, make_host_mesh(), 2))
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    params = dict(model.named_parameters())
    state = tsteps.TrainState(model, adamw_init(params),
                              {k: torch.zeros(()) for k in params},
                              torch.zeros((), dtype=torch.int32))
    new, m = tsteps.make_train_step(tc, tt)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(new.step) == int(jnew.step) == 1
    assert int(new.opt.count) == 1
    for key in ("loss", "grad_norm", "lr"):
        _close(m[key], jm[key])
    # An update is about lr * sign(g); the two differ where |g| is near
    # eps, so the parameters are held to a share of lr.
    for name, p in new.params.named_parameters():
        _close(p, _leaf(jnew.params, name), TOL * 10)
        moved = p.detach() - torch.from_numpy(_leaf(jp, name).copy())
        assert float(moved.abs().max()) <= 1.2e-3


def test_remat_keeps_the_step():
    """Per-block remat (each block recomputed in the backward) gives the
    plain step's bits."""
    outs = []
    for remat in (False, True):
        _, _, tc, model = _pair({"remat": remat})
        params = dict(model.named_parameters())
        state = tsteps.TrainState(model, adamw_init(params),
                                  {k: torch.zeros(()) for k in params},
                                  torch.zeros((), dtype=torch.int32))
        step = tsteps.make_train_step(tc, tsteps.TrainConfig(warmup_steps=0))
        batch = {k: torch.from_numpy(v)
                 for k, v in _batch(tc, 2, 16).items()}
        state, m = step(state, batch)
        outs.append((float(m["loss"]), [p.detach().clone()
                                        for p in model.parameters()]))
    assert outs[0][0] == outs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_step_on_a_card_needs_the_cublas_setting(monkeypatch):
    """Without ``CUBLAS_WORKSPACE_CONFIG`` a step on a CUDA device refuses
    to start (the setting only takes effect from the process's start);
    CPU steps do not need it."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        with tsteps._deterministic(torch.device("cuda")):
            pass
    with tsteps._deterministic(torch.device("cpu")):
        assert torch.are_deterministic_algorithms_enabled()


def test_compressed_train_step_matches_the_reference_step(monkeypatch):
    """Two RandLR steps (rank 8, two pod groups) of each package's
    ``make_train_step`` from the same weights and batch, the port's Omega
    of each stacked leaf replaced by the reference's (``fold_in`` of the
    step's key and the leaf's index): the per-pod split, the metrics'
    mean, one Omega per stacked name in the reference's leaf order, the EF
    buffers per layer, and the update.  The reference runs on a stand-in
    mesh with a pod axis of 2 (no device is sharded: no mesh is entered).
    Tolerances as ``test_train_step_matches_the_reference_step``'s, the EF
    buffers to ``TOL`` of their largest entry."""
    import types
    from repro.optim import CompressorConfig as JCompressorConfig
    from repro_torch.core.rng import block_seed
    from repro_torch.optim import compress as tcompress
    from repro_torch.optim import ef_init
    jc, jp, tc, model = _pair()
    kw = dict(peak_lr=3e-3, warmup_steps=0, total_steps=10)
    jt = jsteps.TrainConfig(compress=JCompressorConfig(
        rank=8, min_dim=16, min_numel=64), **kw)
    tt = tsteps.TrainConfig(compress=CompressorConfig(
        rank=8, min_dim=16, min_numel=64), **kw)
    batch = _batch(jc, 4, 16, seed=5)
    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 1},
                                 axis_names=("pod", "data"))
    jstate = jsteps.init_train_state(jax.random.key(0), jc, jt, npods=2)
    jstate = jstate._replace(params=jp, opt=jsteps.adamw_init(jp))
    jstep = jax.jit(jsteps.make_train_step(jc, jt, mesh, 4))
    steps_of = {block_seed(0, s): s for s in range(2)}

    def ref_omega(seed, index, r, n, device):
        key = jax.random.fold_in(jax.random.key(0), steps_of[seed])
        om = jax.random.normal(jax.random.fold_in(key, index), (r, n),
                               jnp.float32) * (n ** -0.5)
        return torch.from_numpy(np.array(om)).to(device)

    monkeypatch.setattr(tcompress, "_omega", ref_omega)
    params = dict(model.named_parameters())
    state = tsteps.TrainState(model, adamw_init(params),
                              ef_init(params, tt.compress, 2),
                              torch.zeros((), dtype=torch.int32))
    step = tsteps.make_train_step(tc, tt, npods=2)
    for _ in range(2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        for key in ("loss", "total_loss", "grad_norm", "lr",
                    "compress_ratio"):
            _close(m[key], jm[key])
    for name, p in state.params.named_parameters():
        _close(p, _leaf(jstate.params, name), TOL * 10)
    compressed = 0
    for name, e in state.ef.items():
        parts = name.split(".")
        node = jstate.ef["blocks"][0] if parts[0] == "blocks" else jstate.ef
        for key in parts[2:] if parts[0] == "blocks" else parts:
            node = node[key]
        je = np.asarray(node)          # (npods, layers, m, n) when stacked
        assert (e.dim() == 0) == (je.ndim == 0), name
        if e.dim():
            compressed += 1
            _close(e, je[:, int(parts[1])] if parts[0] == "blocks" else je)
    assert compressed > 0


# ------------------------------------------------------------------ data

def test_batch_for_step_replays_shifts_and_shards():
    cfg = SyntheticConfig(vocab_size=256, seq_len=32, global_batch=8, seed=3)
    b1 = batch_for_step(cfg, 17, device="cpu")
    b2 = batch_for_step(cfg, 17, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].dtype == torch.int32
    assert not torch.equal(b1["tokens"],
                           batch_for_step(cfg, 18, device="cpu")["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    shards = [batch_for_step(cfg, 5, host=h, n_hosts=4, device="cpu")
              for h in range(4)]
    assert all(s["tokens"].shape == (2, 32) for s in shards)
    assert len({s["tokens"].numpy().tobytes() for s in shards}) == 4
    with pytest.raises(ValueError, match="hosts"):
        batch_for_step(cfg, 0, n_hosts=3, device="cpu")


def test_batch_pattern_is_the_references():
    """Without noise each row is the reference's ramp ``(phase * 31 + 7 t)
    mod (period * 13) mod vocab`` for some phase below ``period``."""
    cfg = SyntheticConfig(vocab_size=256, seq_len=64, global_batch=64,
                          seed=1, noise=0.0)
    toks = batch_for_step(cfg, 0, device="cpu")["tokens"].numpy()
    t = np.arange(64)
    ramps = {ph: (ph * 31 + 7 * t) % (cfg.period * 13) % cfg.vocab_size
             for ph in range(cfg.period)}
    assert all(any(np.array_equal(row, r) for r in ramps.values())
               for row in toks)
    assert len(np.unique(toks, axis=0)) <= cfg.period
    noisy = batch_for_step(cfg._replace(noise=0.5), 0, device="cpu")
    share = float((noisy["tokens"].numpy() != toks).mean())
    assert 0.3 < share < 0.6


# ------------------------------------------------------- the train loop

def _tcfg(**kw):
    return tsteps.TrainConfig(peak_lr=3e-3, warmup_steps=3,
                              total_steps=30, **kw)


def test_smoke_steps_cut_the_loss():
    cfg = tcfgs.get_smoke_config(ARCH)
    out = ttrain.train_loop(cfg, _tcfg(), global_batch=4, seq_len=32,
                            steps=30, log=lambda *a: None, device="cpu")
    losses = out["losses"]
    assert np.all(np.isfinite(losses))
    assert min(losses[-5:]) < losses[0] - 0.3, losses[:3] + losses[-3:]
    assert [h["step"] for h in out["history"]] == list(range(1, 31))
    assert all(h["grad_norm"] > 0 for h in out["history"])


def test_train_loop_replays_and_resumes_bit_for_bit(tmp_path):
    """Two runs from one seed give the same bits; a run failed at step 3
    raises ``HostFailure``, and its resume from the step-2 checkpoint
    gives the uninterrupted run's losses and parameters bit for bit."""
    cfg = tcfgs.get_smoke_config(ARCH)
    kw = dict(global_batch=2, seq_len=16, steps=6, log=lambda *a: None,
              device="cpu")
    a = ttrain.train_loop(cfg, _tcfg(), **kw)
    b = ttrain.train_loop(cfg, _tcfg(), **kw)
    assert a["losses"] == b["losses"]
    with pytest.raises(HostFailure):
        ttrain.train_loop(cfg, _tcfg(), ckpt_dir=str(tmp_path),
                          ckpt_every=2, fail_at=3, **kw)
    logs = []
    c = ttrain.train_loop(cfg, _tcfg(), ckpt_dir=str(tmp_path),
                          ckpt_every=2, **dict(kw, log=logs.append))
    assert logs[0] == "restored checkpoint at step 2"
    assert c["losses"] == a["losses"][2:]
    assert int(c["state"].step) == 6 and int(c["state"].opt.count) == 6
    for p, q in zip(a["state"].params.parameters(),
                    c["state"].params.parameters()):
        assert torch.equal(p, q)


def test_compressed_step_stays_near_the_dense_one():
    """RandLR at rank 8 over two pod groups ends within 5 % of the dense
    loss after 4 steps (the reference's sharded-compression property)."""
    cfg = tcfgs.get_smoke_config(ARCH)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 8, 32, 7).items()}
    batch["labels"] = batch["labels"].clamp_min(0)
    losses = {}
    for name, tcfg in (("dense", tsteps.TrainConfig()),
                       ("rcomp", tsteps.TrainConfig(compress=CompressorConfig(
                           rank=8, min_dim=16, min_numel=64)))):
        state = tsteps.init_train_state(7, cfg, tcfg, npods=2, device="cpu")
        step = tsteps.make_train_step(cfg, tcfg, npods=2)
        for _ in range(4):
            state, m = step(state, batch)
        assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0
        losses[name] = float(m["loss"])
    assert 0 < m["compress_ratio"] < 1
    assert state.ef["blocks.0.mlp.w_up"].shape == (2, 64, 128)
    assert abs(losses["dense"] - losses["rcomp"]) / losses["dense"] < 0.05


def test_compressed_steps_keep_most_of_the_dense_drop():
    """At a learning rate that moves the loss (peak 3e-4, warmup 1, so 3
    updates in 4 steps), RandLR rank 8 over two pod groups cuts the loss
    by at least half as much as the dense step does: a compressed step
    that applied no gradient would cut nothing.  (The reference keeps the
    same share: on the same Omega the port's compressed step is the
    reference's, as the parity test above shows.)"""
    cfg = tcfgs.get_smoke_config(ARCH)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 8, 32, 7).items()}
    drops = {}
    for name, comp in (("dense", None), ("rcomp", CompressorConfig(
            rank=8, min_dim=16, min_numel=64))):
        tcfg = tsteps.TrainConfig(peak_lr=3e-4, warmup_steps=1,
                                  total_steps=4, compress=comp)
        state = tsteps.init_train_state(7, cfg, tcfg, npods=2, device="cpu")
        step = tsteps.make_train_step(cfg, tcfg, npods=2)
        losses = []
        for _ in range(4):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        drops[name] = losses[0] - losses[-1]
    assert drops["dense"] > 0
    assert drops["rcomp"] >= 0.5 * drops["dense"], drops


def test_train_cli_runs_on_the_cpu(capsys):
    out = ttrain.main(["--arch", "granite-3-2b", "--smoke", "--device",
                       "cpu", "--steps", "3", "--batch", "2", "--seq", "16"])
    assert len(out["losses"]) == 3
    assert "final loss" in capsys.readouterr().out
