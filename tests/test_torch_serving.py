"""The port's serving engine and RID weight compression, on the CPU.

Greedy outputs are held equal to ``repro.serving.ServeEngine``'s on the
SMOKE granite-3-2b in f32, both packages running the same weights (moved
by ``params_from_jax``).  The engine's behaviours mirror
tests/test_serving.py: continuous batching, admit-time completion, EOS,
chunked prefill, quarantine, shedding, deadlines on a fake clock,
``max_steps`` eviction; and ``compress_params`` against the reference's.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.serving import compress as jcompress  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.kernels.flash.kernel import LAUNCHES  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.obs import FakeClock, tracing  # noqa: E402
from repro_torch.serving import (GenerationRequest, ServeEngine,  # noqa: E402
                                 compress_params, compression_report,
                                 low_rank_targets)
from repro_torch.serving.compress import (LowRankWeight,  # noqa: E402
                                          apply_low_rank)
from torch_ranks import pin_threads  # noqa: E402
from repro.core import rsvd as _jrsvd  # noqa: E402

pin_threads()

ARCH = "granite_3_2b"

# The reference's probing RSVD, jitted once (by shape) and shared: eager,
# its compress_params dispatches every op of every leaf's RSVD one by one.
_JIT_RSVD = jax.jit(_jrsvd, static_argnums=(2,),
                    static_argnames=("l", "sketch_kind", "qr_impl", "qr_panel",
                                     "qr_norm_recompute"))


@pytest.fixture
def jitted_reference_rsvd(monkeypatch):
    monkeypatch.setattr(jcompress, "rsvd", _JIT_RSVD)


@pytest.fixture(scope="module")
def models():
    """(reference cfg, reference params, port cfg, port model)."""
    jc = jcfgs.get_smoke_config(ARCH).replace(dtype="float32")
    tc = tcfgs.get_smoke_config(ARCH).replace(dtype="float32")
    jp = jmodels.init_params(jax.random.key(0), jc)
    model = tmodels.params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                    device="cpu")
    return jc, jp, tc, model


def _requests(cls, vocab, lengths, new_tokens, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(request_id=i,
                prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=new_tokens)
            for i, n in enumerate(lengths)]


def _serve(eng_cls, req_cls, cfg, params, lengths, new_tokens, **kw):
    eng = eng_cls(cfg, params, **kw)
    reqs = _requests(req_cls, cfg.vocab_size, lengths, new_tokens)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [(r.status, list(r.output)) for r in reqs]


# ------------------------------------------------- against the reference

def test_engine_greedy_equals_reference(models):
    """7 requests through 3 slots (queueing, continuous batching)."""
    jc, jp, tc, model = models
    lengths, kw = [4 + i for i in range(7)], dict(max_batch=3, max_len=64)
    want = _serve(jserving.ServeEngine, jserving.GenerationRequest, jc, jp,
                  lengths, 6, **kw)
    got = _serve(ServeEngine, GenerationRequest, tc, model, lengths, 6, **kw)
    assert got == want
    assert all(s == "done" and len(o) == 6 for s, o in got)


def test_engine_greedy_equals_reference_long_prompt(models):
    """A 2100-token prompt (the flash path) beside two short ones."""
    jc, jp, tc, model = models
    lengths, kw = [5, 2100, 7], dict(max_batch=2, max_len=2112)
    want = _serve(jserving.ServeEngine, jserving.GenerationRequest, jc, jp,
                  lengths, 4, **kw)
    before = LAUNCHES.count
    got = _serve(ServeEngine, GenerationRequest, tc, model, lengths, 4, **kw)
    assert LAUNCHES.count == before          # the CPU runs the plain version
    assert got == want


def test_engine_chunked_equals_reference(models):
    jc, jp, tc, model = models
    lengths = [37, 3, 20]
    kw = dict(max_batch=2, max_len=64, prefill_chunk_tokens=8)
    want = _serve(jserving.ServeEngine, jserving.GenerationRequest, jc, jp,
                  lengths, 5, **kw)
    got = _serve(ServeEngine, GenerationRequest, tc, model, lengths, 5, **kw)
    assert got == want


# ----------------------------------------------- behaviours (port only)

def test_engine_matches_its_own_greedy_loop(models):
    _, _, cfg, model = models
    eng = ServeEngine(cfg, model, max_batch=2, max_len=64)
    prompt = np.arange(5, dtype=np.int32)
    req = GenerationRequest(request_id=0, prompt=prompt, max_new_tokens=5)
    eng.submit(req)
    eng.run()
    lg, caches = tmodels.prefill(model, cfg, torch.from_numpy(prompt)[None],
                                 max_len=64)
    ref = [int(torch.argmax(lg[0, -1]))]
    for i in range(4):
        lg, caches = tmodels.decode_step(model, cfg, torch.tensor([[ref[-1]]]),
                                         torch.tensor([len(prompt) + i]),
                                         caches)
        ref.append(int(torch.argmax(lg[0, 0])))
    assert req.output == ref


def test_admit_time_completion_frees_slot(models):
    _, _, cfg, model = models
    eng = ServeEngine(cfg, model, max_batch=2, max_len=64)
    reqs = _requests(GenerationRequest, cfg.vocab_size, [3 + i for i in
                                                          range(5)], 1, 1)
    for r in reqs:
        eng.submit(r)
    eng._admit()                               # ONE admit pass, no decode
    assert all(r.done and len(r.output) == 1 for r in reqs)
    assert eng._active == {} and eng._queue == []
    assert eng._free_slots() == [0, 1]


def test_admit_time_eos_never_occupies_decode_slot(models):
    _, _, cfg, model = models
    prompt = np.arange(4, dtype=np.int32)
    probe = ServeEngine(cfg, model, max_batch=1, max_len=64)
    probe.submit(GenerationRequest(request_id=0, prompt=prompt,
                                   max_new_tokens=1))
    eos = probe.run()[0].output[0]
    eng = ServeEngine(cfg, model, max_batch=1, max_len=64)
    eos_req = GenerationRequest(request_id=0, prompt=prompt,
                                max_new_tokens=50, eos_token=eos)
    tail_req = GenerationRequest(request_id=1,
                                 prompt=np.arange(1, 6, dtype=np.int32),
                                 max_new_tokens=3)
    eng.submit(eos_req)
    eng.submit(tail_req)
    eng._admit()
    assert eos_req.done and len(eos_req.output) == 1
    assert [r.request_id for r in eng._active.values()] == [1]
    done = eng.run()
    assert {r.request_id for r in done} == {0, 1}
    assert len(tail_req.output) == 3


def test_engine_eos_stops(models):
    """EOS met while decoding: the request stops there."""
    _, _, cfg, model = models
    prompt = np.arange(4, dtype=np.int32)
    probe = ServeEngine(cfg, model, max_batch=1, max_len=64)
    probe.submit(GenerationRequest(request_id=0, prompt=prompt,
                                   max_new_tokens=8))
    out = probe.run()[0].output
    eos = out[3]
    eng = ServeEngine(cfg, model, max_batch=2, max_len=64)
    req = GenerationRequest(request_id=0, prompt=prompt, max_new_tokens=50,
                            eos_token=eos)
    eng.submit(req)
    done = eng.run()
    assert done[0].output == out[:out.index(eos) + 1]


def test_chunked_prefill_matches_one_shot(models):
    _, _, cfg, model = models
    prompt = np.arange(37, dtype=np.int32) % cfg.vocab_size
    out = {}
    for chunk in (None, 8):
        eng = ServeEngine(cfg, model, max_batch=2, max_len=64,
                          prefill_chunk_tokens=chunk)
        eng.submit(GenerationRequest(request_id=0, prompt=prompt,
                                     max_new_tokens=6))
        done = eng.run()
        assert len(done) == 1 and len(done[0].output) == 6
        out[chunk] = done[0].output
    assert out[8] == out[None]


def test_chunked_prefill_interleaves_with_decode(models):
    _, _, cfg, model = models
    eng = ServeEngine(cfg, model, max_batch=2, max_len=128,
                      prefill_chunk_tokens=4)
    short = GenerationRequest(request_id=0,
                              prompt=np.arange(3, dtype=np.int32),
                              max_new_tokens=20)
    long_ = GenerationRequest(request_id=1,
                              prompt=np.arange(40, dtype=np.int32) %
                              cfg.vocab_size, max_new_tokens=3)
    eng.submit(short)
    eng._admit()
    eng.submit(long_)
    progress = []
    for _ in range(6):
        eng._admit()
        eng._step_prefill()
        eng._step_decode()
        progress.append(len(short.output))
    assert eng._prefilling and not long_.output
    assert progress == list(range(2, 8))
    done = eng.run()
    assert {r.request_id for r in done} == {0, 1}
    assert len(long_.output) == 3


def test_chunked_prefill_admit_time_completion_frees_slot(models):
    _, _, cfg, model = models
    eng = ServeEngine(cfg, model, max_batch=1, max_len=64,
                      prefill_chunk_tokens=4)
    req = GenerationRequest(request_id=0, prompt=np.arange(10, dtype=np.int32),
                            max_new_tokens=1)
    eng.submit(req)
    done = eng.run()
    assert [r.request_id for r in done] == [0]
    assert req.done and len(req.output) == 1
    assert eng._active == {} and eng._prefilling == {}
    assert eng._free_slots() == [0]


def test_chunked_prefill_validation_messages():
    cfg = tcfgs.get_smoke_config(ARCH)
    with pytest.raises(ValueError, match=r"need prefill_chunk_tokens >= 1, "
                                         r"got prefill_chunk_tokens=0"):
        ServeEngine(cfg, None, prefill_chunk_tokens=0, device="cpu")
    swa = tcfgs.get_smoke_config("h2o_danube_1_8b")
    with pytest.raises(ValueError, match=r"chunked prefill unsupported for "
                                         r"arch .*got prefill_chunk_tokens=8"):
        ServeEngine(swa, None, prefill_chunk_tokens=8, device="cpu")


def test_submit_sheds_when_queue_full():
    cfg = tcfgs.get_smoke_config(ARCH)
    eng = ServeEngine(cfg, None, max_batch=1, max_len=64, max_queue=2,
                      device="cpu")
    reqs = [GenerationRequest(request_id=i,
                              prompt=np.arange(3, dtype=np.int32))
            for i in range(3)]
    assert eng.submit(reqs[0]) is True
    assert eng.submit(reqs[1]) is True
    assert eng.submit(reqs[2]) is False
    assert reqs[2].status == "evicted" and "max_queue=2" in reqs[2].error
    assert len(eng._queue) == 2 and reqs[2] in eng._all
    with pytest.raises(ValueError, match="max_queue=0"):
        ServeEngine(cfg, None, max_queue=0, device="cpu")


def test_poisoned_requests_quarantined_without_model():
    cfg = tcfgs.get_smoke_config(ARCH)
    eng = ServeEngine(cfg, None, max_batch=2, max_len=16, device="cpu")
    bad = [GenerationRequest(request_id=0,
                             prompt=np.ones((2, 3), dtype=np.int32)),
           GenerationRequest(request_id=1,
                             prompt=np.array([0.5, 1.5], dtype=np.float32)),
           GenerationRequest(request_id=2,
                             prompt=np.array([0, cfg.vocab_size],
                                             dtype=np.int32)),
           GenerationRequest(request_id=3,
                             prompt=np.arange(40, dtype=np.int32) %
                             cfg.vocab_size)]
    for r in bad:
        eng.submit(r)
    eng._admit()
    assert [r.status for r in bad] == ["failed"] * 4
    for r, frag in zip(bad, ("1-D", "dtype", "vocab_size", "max_len=16")):
        assert frag in r.error, (r.request_id, r.error)
    assert eng._active == {} and eng._queue == []


def test_quarantine_spares_healthy_requests(models):
    _, _, cfg, model = models
    eng = ServeEngine(cfg, model, max_batch=2, max_len=64)
    healthy = [GenerationRequest(request_id=i,
                                 prompt=np.arange(4 + i, dtype=np.int32),
                                 max_new_tokens=4)
               for i in range(2)]
    poison = GenerationRequest(request_id=9,
                               prompt=np.array([-3, 1], dtype=np.int32))
    eng.submit(healthy[0])
    eng.submit(poison)
    eng.submit(healthy[1])
    with tracing() as tr:
        done = eng.run()
    assert {r.request_id for r in done} == {0, 1, 9}
    assert all(r.done and len(r.output) == 4 for r in healthy)
    assert poison.status == "failed" and "-3" in poison.error
    assert tr.metrics.counter("serve.quarantined").value == 1


def test_deadline_timeout_and_cancel_in_queue():
    cfg = tcfgs.get_smoke_config(ARCH)
    clk = FakeClock()
    eng = ServeEngine(cfg, None, max_batch=1, max_len=64, clock=clk,
                      device="cpu")
    late = GenerationRequest(request_id=0, prompt=np.arange(3, dtype=np.int32),
                             deadline_s=5.0)
    keep = GenerationRequest(request_id=1, prompt=np.arange(3, dtype=np.int32))
    gone = GenerationRequest(request_id=2, prompt=np.arange(3, dtype=np.int32))
    for r in (late, keep, gone):
        eng.submit(r)
    clk.advance(10.0)
    eng._expire()
    assert late.status == "timeout" and "deadline_s=5.0" in late.error
    assert eng.cancel(2) is True and gone.status == "evicted"
    assert eng.cancel(99) is False
    assert [r.request_id for r in eng._queue] == [1]
    assert keep.status == "queued"


def test_deadline_expires_mid_decode(models):
    _, _, cfg, model = models
    clk = FakeClock(tick=1.0)
    eng = ServeEngine(cfg, model, max_batch=2, max_len=64, clock=clk)
    doomed = GenerationRequest(request_id=0, prompt=np.arange(4, dtype=np.int32),
                               max_new_tokens=500, deadline_s=3.0)
    fine = GenerationRequest(request_id=1, prompt=np.arange(5, dtype=np.int32),
                             max_new_tokens=4)
    eng.submit(doomed)
    eng.submit(fine)
    done = eng.run()
    assert {r.request_id for r in done} == {0, 1}
    assert doomed.status == "timeout" and len(doomed.output) < 500
    assert "exceeded after" in doomed.error
    assert fine.done and len(fine.output) == 4


def test_cancel_while_decoding_frees_the_slot(models):
    _, _, cfg, model = models
    eng = ServeEngine(cfg, model, max_batch=1, max_len=64)
    req = GenerationRequest(request_id=4, prompt=np.arange(4, dtype=np.int32),
                            max_new_tokens=30)
    eng.submit(req)
    eng._admit()
    eng._step_decode()
    assert eng.cancel(4) is True
    assert req.status == "evicted" and eng._free_slots() == [0]


def test_run_at_max_steps_evicts_instead_of_dropping():
    cfg = tcfgs.get_smoke_config(ARCH)
    eng = ServeEngine(cfg, None, max_batch=1, max_len=64, device="cpu")
    reqs = [GenerationRequest(request_id=i, prompt=np.arange(3, dtype=np.int32))
            for i in range(2)]
    for r in reqs:
        eng.submit(r)
    out = eng.run(max_steps=0)
    assert {r.request_id for r in out} == {0, 1}
    assert all(r.status == "evicted" and "max_steps=0" in r.error
               for r in reqs)
    assert eng._queue == [] and eng._active == {}


def test_engine_spans_and_gauges(models):
    """The reference's span, counter and gauge names, nested under
    ``serve.run``."""
    _, _, cfg, model = models
    eng = ServeEngine(cfg, model, max_batch=1, max_len=64,
                      prefill_chunk_tokens=4, max_queue=1)
    eng.submit(GenerationRequest(request_id=0,
                                 prompt=np.arange(9, dtype=np.int32),
                                 max_new_tokens=2))
    eng.submit(GenerationRequest(request_id=1,
                                 prompt=np.arange(3, dtype=np.int32)))
    with tracing() as tr:
        eng.run()
    names = {s.name for s in tr.spans}
    assert {"serve.run", "serve.admit", "serve.prefill_chunk",
            "serve.decode"} <= names
    root = [s for s in tr.spans if s.name == "serve.run"][0]
    assert root.depth == 0 and all(s.depth >= 1 for s in tr.spans
                                   if s.name != "serve.run")
    assert tr.metrics.gauge("serve.queue_depth").value == 0
    assert tr.metrics.gauge("serve.slot_occupancy").value == 0


def test_launch_serve_cli_on_cpu(capsys):
    done = tserve.main(["--arch", "granite-3-2b", "--smoke", "--device",
                        "cpu", "--requests", "3", "--new-tokens", "4"])
    assert len(done) == 3 and all(len(r.output) == 4 for r in done)
    assert "served 3/3 requests" in capsys.readouterr().out


# ---------------------------------------------------------- RID weights

def _planted_tree(rng):
    W_lr = (rng.standard_normal((64, 8)) @ rng.standard_normal((8, 96))
            ).astype(np.float32)
    wo = rng.standard_normal((96, 64)).astype(np.float32)
    return W_lr, wo


def test_compress_params_factor_low_rank(jitted_reference_rsvd):
    """A planted exactly low-rank weight is factored (by both packages)
    and exact; a full-rank one stays dense."""
    W_lr, wo = _planted_tree(np.random.default_rng(0))
    tree = {"mixer": {"wq": torch.from_numpy(W_lr), "wo": torch.from_numpy(wo)}}
    out, report = compress_params(0, tree, rank=8, energy_keep=0.9)
    assert isinstance(out["mixer"]["wq"], LowRankWeight)
    np.testing.assert_allclose(out["mixer"]["wq"].materialize().numpy(), W_lr,
                               atol=1e-3)
    assert not isinstance(out["mixer"]["wo"], LowRankWeight)
    assert "compressed 1/2" in compression_report(report)
    assert tree["mixer"]["wq"] is not out["mixer"]["wq"]   # input untouched
    jout, jrep = jcompress.compress_params(
        jax.random.key(0), {"mixer": {"wq": jnp.asarray(W_lr),
                                      "wo": jnp.asarray(wo)}},
        rank=8, energy_keep=0.9)
    # the reference names leaves "['mixer']['wq']", the port "mixer.wq"
    assert {k.strip("[]'").replace("']['", "."): r["compressed"]
            for k, r in jrep.items()} == \
        {k: r["compressed"] for k, r in report.items()}
    np.testing.assert_allclose(out["mixer"]["wq"].materialize().numpy(),
                               np.asarray(jout["mixer"]["wq"].materialize()),
                               atol=1e-3)


def test_compress_factors_stacked_leaves_per_slice_all_or_none():
    """A stacked leaf (the port's (E, m, n) expert stacks) is a target and
    is factored one slice at a time, all slices or none, as the reference
    factors its stacked leaves: B (E, m, k), P (E, k, n); one full-rank
    slice keeps the whole stack dense.  A leaf of another name is skipped
    whatever its shape."""
    rng = np.random.default_rng(1)
    W_lr, wo = _planted_tree(rng)
    W2, _ = _planted_tree(rng)
    tree = {"w_up": torch.from_numpy(np.stack([W_lr, W2])),
            "w_gate": torch.from_numpy(np.stack([W_lr, wo.T.copy()])),
            "scale": torch.from_numpy(np.stack([W_lr, W_lr])),
            "w_down": torch.from_numpy(W_lr)}
    assert low_rank_targets(tree) == ["w_up", "w_gate", "w_down"]
    out, report = compress_params(0, tree, rank=8, energy_keep=0.9)
    assert list(report) == ["w_up", "w_gate", "w_down"]
    assert report["w_up"]["compressed"] and report["w_down"]["compressed"]
    assert not report["w_gate"]["compressed"]
    lw = out["w_up"]
    assert tuple(lw.B.shape) == (2, 64, 8) and tuple(lw.P.shape) == (2, 8, 96)
    assert lw.shape == (2, 64, 96)
    np.testing.assert_allclose(lw.materialize().numpy(),
                               np.stack([W_lr, W2]), atol=1e-3)
    assert report["w_up"]["dense_elems"] == 2 * 64 * 96
    assert report["w_up"]["factored_elems"] == 2 * 8 * (64 + 96)
    assert out["w_gate"] is tree["w_gate"] and out["scale"] is tree["scale"]
    jout, jrep = jcompress.compress_params(
        jax.random.key(0),
        {k: jnp.asarray(v.numpy()) for k, v in tree.items()},
        rank=8, energy_keep=0.9)
    assert {k.strip("[]'"): r["compressed"] for k, r in jrep.items()} == \
        {k: r["compressed"] for k, r in report.items()}
    assert compression_report(jrep) == compression_report(report)


def test_compress_module_reports_every_projection(models):
    """Every eligible leaf of the model is probed and each projection is
    reported once, over its layers; the input model keeps its dense
    parameters whatever is factored, and the layers of a projection are
    factored together or not at all."""
    _, _, tc, model = models
    out, report = compress_params(1, model, rank=8)
    targets = low_rank_targets(model)
    projections = list(dict.fromkeys(
        ".".join("*" if p.isdigit() else p for p in name.split("."))
        for name in targets))
    assert list(report) == projections and len(projections) == 7
    assert "/7 eligible weight matrices" in compression_report(report)
    assert all(isinstance(p, torch.nn.Parameter) for p in model.parameters())
    for name in targets:
        proj = ".".join("*" if p.isdigit() else p for p in name.split("."))
        mod, attr = name.rsplit(".", 1)
        leaf = getattr(out.get_submodule(mod), attr)
        assert isinstance(leaf, LowRankWeight) == report[proj]["compressed"]
        assert tuple(leaf.shape) == tuple(model.get_parameter(name).shape)


def test_compress_params_decides_per_projection_like_reference(
        jitted_reference_rsvd):
    """One projection is exactly rank 4 in every layer but one, where it
    is a flat-spectrum Gaussian (top-4 energy about 0.11 at 128 x 128,
    far under 0.95); another is exactly rank 4 in every layer.  Both
    packages factor the second and leave the first dense, whatever the
    draw, with one report entry per projection and equal totals."""
    jc = jcfgs.get_smoke_config(ARCH).replace(
        dtype="float32", n_layers=3, d_model=128, d_ff=256)
    tc = tcfgs.get_smoke_config(ARCH).replace(
        dtype="float32", n_layers=3, d_model=128, d_ff=256)
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        jp = jax.tree.map(np.asarray,
                          jmodels.init_params(jax.random.key(seed), jc))
        blk = jp["blocks"][0]

        def rank4(m, n):
            return (rng.standard_normal((m, 4)) @ rng.standard_normal((4, n))
                    ).astype(np.float32)
        wq = np.stack([rank4(*blk["mixer"]["wq"].shape[1:])
                       for _ in range(jc.n_layers)])
        wq[1] = rng.standard_normal(wq.shape[1:]).astype(np.float32)
        blk["mixer"]["wq"] = wq
        blk["mlp"]["w_up"] = np.stack([rank4(*blk["mlp"]["w_up"].shape[1:])
                                       for _ in range(jc.n_layers)])
        model = tmodels.params_from_jax(jp, tc, device="cpu")
        out, report = compress_params(seed, model, rank=4)
        jout, jrep = jcompress.compress_params(
            jax.random.key(seed), jax.tree.map(jnp.asarray, jp), rank=4)
        assert not report["blocks.*.mixer.wq"]["compressed"]
        assert report["blocks.*.mlp.w_up"]["compressed"]
        assert len(report) == len(jrep) == 7
        assert not jrep["['blocks'][0]['mixer']['wq']"]["compressed"]
        assert jrep["['blocks'][0]['mlp']['w_up']"]["compressed"]
        for i in range(tc.n_layers):
            assert isinstance(out.blocks[i].mlp.w_up, LowRankWeight)
            assert isinstance(out.blocks[i].mixer.wq, torch.nn.Parameter)
        assert sorted(r["compressed"] for r in report.values()) == \
            sorted(r["compressed"] for r in jrep.values())
        assert compression_report(report) == compression_report(jrep)


def test_compress_module_sets_a_factor_in_a_copy(models):
    _, _, tc, model = models
    out, report = compress_params(0, model, rank=8, energy_keep=0.0)
    assert out is not model and isinstance(out.blocks[0].mixer.wq,
                                           LowRankWeight)
    assert isinstance(model.blocks[0].mixer.wq, torch.nn.Parameter)
    assert sum(r["compressed"] for r in report.values()) == len(report)


def test_low_rank_weight_is_not_consumed_by_either_model(models):
    """The reference's models call ``.astype`` on each projection, which
    a LowRankWeight lacks; the port mirrors it (ROADMAP Queue C)."""
    jc, jp, tc, model = models
    toks = np.arange(6, dtype=np.int32)[None]
    jtree = jax.tree.map(lambda a: a, jp)
    wq = jtree["blocks"][0]["mixer"]["wq"]
    jtree["blocks"][0]["mixer"]["wq"] = jcompress.LowRankWeight(
        B=wq[..., :4], P=wq[..., :4, :])
    with pytest.raises(AttributeError, match="astype"):
        jmodels.forward(jtree, jc, jnp.asarray(toks))
    out, _ = compress_params(0, model, rank=8, energy_keep=0.0)
    with pytest.raises(AttributeError, match="'to'"):
        tmodels.forward(out, tc, torch.from_numpy(toks))


def test_apply_low_rank_equivalence():
    rng = np.random.default_rng(2)
    B = torch.from_numpy(rng.standard_normal((32, 4)).astype(np.float32))
    P = torch.from_numpy(rng.standard_normal((4, 24)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((7, 32)).astype(np.float32))
    np.testing.assert_allclose(apply_low_rank(x, LowRankWeight(B=B, P=P)),
                               x @ (B @ P), atol=1e-5)
    np.testing.assert_array_equal(apply_low_rank(x, B @ P), x @ (B @ P))


def test_low_rank_targets_lists_projections(models):
    _, jp, _, model = models
    names = low_rank_targets(model)
    assert "blocks.0.mixer.wq" in names and "blocks.1.mlp.w_down" in names
    assert not any("scale" in n or "embed" in n for n in names)
    # the reference stacks each projection over the layers; the port holds
    # one leaf a layer (compress_params groups them back per projection)
    assert len(names) == 2 * len(jcompress.low_rank_targets(jp))
