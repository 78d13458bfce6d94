"""The port's sharded steps (``launch.steps`` under a mesh) on gloo ranks,
held to the JAX reference.

Every case runs in rank subprocesses (``torch_ranks.start_ranks``, one
torch import each, ``OMP_NUM_THREADS=1``); no test process joins a
group.  Two rank programs hold all the cases: one of eight ranks (the
world-4 cases on two halves of four at once, then the world-8 drill on
all eight) and one of one rank.  Each rank prints one JSON line of
results (per-step losses and grad norms among them) and writes its
logits and greedy tokens to a file; the tests below read them.  While
the eight ranks run, this process runs the reference (``repro``'s
``make_train_step``, ``prefill`` and ``decode_step``, each jitted once) on
``params_to_numpy`` of the same ``init_params`` seed, the same batches
(``data.batch_for_step``) and the tokens the ranks fed.  The reference's
step without an entered mesh is its sharded step's math, so every sharded
case is held to it.

World 4.  On a (2, 2) ("data", "model") mesh over ranks 0-3, SMOKE
granite-3-2b in f32:
three sharded train steps in modes ``tp`` and ``fsdp`` and with
``cast_params``, their losses and grad norms against the reference's
step with the same ``TrainConfig``; each rank's local shard of every
parameter against the block the reference's ``NamedSharding`` gives it
(worked out from the spec, which equals the reference's:
``test_torch_sharding``); the sharded prefill and four greedy decode
steps against the reference's ``prefill`` / ``decode_step`` (logits, and
the greedy tokens equal).  At the same time, on a (1, 4) mesh over ranks
4-7, whose `model` axis divides
phi3.5-moe's 4 experts (EP) and not a 6-expert qwen2-moe (TP-MoE): a train
step and prefill + decode of each, in f32 with a dropless capacity; and
qwen2-7b with 6 heads (not a multiple of 4) on a 64-token prompt over a
patched ``BLOCKWISE_THRESHOLD`` (patched in both packages), so the
blockwise path pads the heads to 8, against the reference's unpadded
path.  A DTensor given to another kernel raises.

World 1.  The train CLI's ``--mesh`` on its own one-rank group; then, on a
(1, 1) mesh, four sharded steps at lr 3e-4 bit-equal to the plain ones
in f32 and bf16, and the sharded prefill and decode bit-equal to the
plain ones.

World 8.  On (2, 2, 2) ("pod", "data", "model"): RandLR at rank 8 within 5
% of the dense loss after four steps (the bar of the reference's
``test_train_step_sharded_with_compression``; the dense run is the port's
unsharded step); a tree saved on (2, 2, 2) and restored onto (4, 2),
bit-equal (the reference's ``test_elastic_reshard_restore``); and
``train_loop`` on the mesh through a host failure, re-meshed by
``plan_elastic_mesh`` onto (2, 2) over four of the ranks and resumed from
the checkpoint, to the bar of the reference's
``test_train_loop_failure_recovery`` (SMOKE granite-3-2b in place of its
xlstm-125m: the bar is the loop's, and the sLSTM's thousands of small
DTensor ops a step would take minutes here).

Tolerances: 1e-5 relative for the f32 losses and grad norms, and for the
logits relative to the reference's largest entry (the sharded sums are
ordered otherwise than XLA's; the gaps measured here are near 1e-6); the
reference's 5 % and 0.15.
"""
import json
import types
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticConfig, batch_for_step  # noqa: E402
from torch_ranks import failures, pin_threads, start_ranks  # noqa: E402

pin_threads()

TOL = 1e-5
TRAIN_B, TRAIN_S = 8, 32
SERVE_B, SERVE_NEW = 4, 4
# (case, smoke arch, config edits, train steps, train seq, prompt)
CASES = [("tp", "granite_3_2b", {}, 3, TRAIN_S, 32),
         ("fsdp", "granite_3_2b", {}, 3, TRAIN_S, None),
         ("tp+cast", "granite_3_2b", {}, 3, TRAIN_S, None),
         ("ep", "phi35_moe", {"moe_capacity_factor": 8.0}, 1, TRAIN_S, 32),
         ("tp_moe", "qwen2_moe_a2_7b", {"moe_capacity_factor": 8.0,
                                        "n_experts": 6}, 1, TRAIN_S, 32),
         ("padded", "qwen2_7b", {"n_heads": 6, "n_kv_heads": 2,
                                 "head_dim": 16}, 1, 64, 64)]
PADDED_THRESHOLD = 40

_COMMON = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world)
from torch.distributed.tensor import DTensor
from repro_torch import models
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticConfig, batch_for_step
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import make_elastic_mesh, make_host_mesh
from repro_torch.models import attention
from repro_torch.models.pshard import use_mesh
OUT = {}


def train(cfg, tcfg, n, mesh=None, B=8, S=32):
    st = steps.init_train_state(0, cfg, tcfg, device="cpu", mesh=mesh)
    fn = steps.make_train_step(cfg, tcfg, mesh=mesh)
    dc = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S,
                         global_batch=B, seed=0)
    out = []
    for s in range(n):
        st, m = fn(st, batch_for_step(dc, s, device="cpu"))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return st, out
"""

_RANKS = _COMMON + r"""

def serve(name, cfg, mesh, P, B=4, new=4):
    # The sharded prefill and greedy decode from init_params(1): the
    # last-position logits of each call and the tokens fed, to a file.
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    ml = P + new
    pf, pshard, _, _ = steps.sharded_prefill(cfg, mesh, B, ml)
    dfn, _, _ = steps.sharded_decode_step(cfg, mesh, B, ml)
    dm = sharding.distribute_params(models.init_params(1, cfg, device="cpu"),
                                    mesh, cfg, shardings=pshard)
    ls, cs = pf(dm, {"tokens": torch.from_numpy(prompt)})
    logits, fed = [ls.full_tensor()[:, -1]], []
    for i in range(new):
        tok = logits[-1].argmax(-1)[:, None].to(torch.int32)
        fed.append(tok)
        ls, cs = dfn(dm, tok, P + i, cs)
        logits.append(ls.full_tensor()[:, -1])
    np.savez(os.path.join(os.path.dirname(store), f"{name}_r{rank}.npz"),
             prompt=prompt, logits=torch.stack(logits).float().numpy(),
             fed=torch.cat(fed, 1).numpy())


# The world-4 cases on two halves of four ranks at once: ranks 0-3 on a
# (2, 2) ("data", "model") mesh, ranks 4-7 on a (1, 4) one.  Every rank
# builds both meshes (their groups are collective over the world).
from torch.distributed.device_mesh import DeviceMesh
mesh22 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                    mesh_dim_names=("data", "model"))
mesh4 = DeviceMesh("cpu", torch.arange(4, 8).reshape(1, 4),
                   mesh_dim_names=("data", "model"))
granite = get_smoke_config("granite_3_2b").replace(dtype="float32")
mesh = mesh22
if rank < 4:
    OUT["mesh"] = list(mesh.shape)
    for name, tc in (("tp", steps.TrainConfig()),
                     ("fsdp", steps.TrainConfig(sharding_mode="fsdp")),
                     ("tp+cast", steps.TrainConfig(cast_params=True))):
        st, OUT[name] = train(granite, tc, 3, mesh)
        if name == "tp":
            # each rank's shard of every parameter against its JAX block
            full = models.init_params(0, granite, device="cpu")
            specs = sharding.param_specs(granite, full, mesh)
            sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
            coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
            init = steps.init_train_state(0, granite, tc, device="cpu",
                                          mesh=mesh)
            bad = []
            for k, p in init.params.named_parameters():
                blk = full.get_parameter(k).detach()
                for d, ax in enumerate(specs[k]):
                    group = () if ax is None else (
                        ax if isinstance(ax, tuple) else (ax,))
                    n, idx = 1, 0
                    for a in group:
                        n *= sizes[a]
                        idx = idx * sizes[a] + coord[a]
                    L = blk.shape[d]
                    blk = blk.narrow(d, idx * L // n, L // n)
                if not torch.equal(p.to_local(), blk):
                    bad.append(k)
            OUT["blocks"] = {"checked": len(specs), "bad": bad}
    serve("tp", granite, mesh, 32)
    # a DTensor reaching a kernel without a sharded wrapper
    from torch.distributed.tensor import Replicate
    from repro_torch.kernels.sketch_accum import sketch_accum
    dt = DTensor.from_local(torch.ones(2, 2), mesh, [Replicate()] * 2,
                            run_check=False)
    try:
        sketch_accum(dt, dt)
        OUT["kernel_refuses"] = None
    except TypeError as e:
        OUT["kernel_refuses"] = str(e)
else:
    OUT["mesh14"] = list(mesh4.shape)
    # EP and TP-MoE on a (1, 4) mesh, dropless
    for name, arch, edit in (("ep", "phi35_moe", {}),
                             ("tp_moe", "qwen2_moe_a2_7b", {"n_experts": 6})):
        cfg = get_smoke_config(arch).replace(dtype="float32",
                                             moe_capacity_factor=8.0, **edit)
        st, OUT[name] = train(cfg, steps.TrainConfig(), 1, mesh4)
        w = st.params.blocks[0].moe.w_gate
        OUT[name + "_layout"] = {"ep": cfg.n_experts % 4 == 0,
                                 "w_gate_local": list(w.to_local().shape)}
        serve(name, cfg, mesh4, 32)

    # heads padded: 6 heads on a 4-wide model axis, a blockwise prompt
    default_threshold = attention.BLOCKWISE_THRESHOLD
    attention.BLOCKWISE_THRESHOLD = 40
    cfg = get_smoke_config("qwen2_7b").replace(dtype="float32", n_heads=6,
                                               n_kv_heads=2, head_dim=16)
    with use_mesh(mesh4):
        OUT["padded_heads"] = attention._padded_heads(cfg.n_heads)
    _, OUT["padded"] = train(cfg, steps.TrainConfig(), 1, mesh4, S=64)
    serve("padded", cfg, mesh4, 64)
    attention.BLOCKWISE_THRESHOLD = default_threshold
dist.barrier()

# The world-8 drill on all eight ranks.

from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.launch.train import train_loop
from repro_torch.optim import CompressorConfig
from repro_torch.runtime import HostFailure, plan_elastic_mesh
mesh = make_elastic_mesh((2, 2, 2), ("pod", "data", "model"),
                         device_type="cpu")
cfg = get_smoke_config("granite_3_2b")
g = torch.Generator().manual_seed(7)
B, S = 8, 32
batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                 dtype=torch.int32),
         "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                 dtype=torch.int32)}
losses = {}
for name, tcfg, m in (("dense", steps.TrainConfig(), None),
                      ("rcomp", steps.TrainConfig(compress=CompressorConfig(
                          rank=8, min_dim=16, min_numel=64)), mesh)):
    st = steps.init_train_state(7, cfg, tcfg, device="cpu", mesh=m)
    fn = steps.make_train_step(cfg, tcfg, mesh=m)
    for i in range(4):
        st, met = fn(st, batch)
    losses[name] = (float(met["loss"]), float(met["grad_norm"]),
                    float(met.get("compress_ratio", 0.0)))
OUT["randlr"] = losses

# save on (2, 2, 2), restore onto (4, 2)
mesh_b = make_elastic_mesh((4, 2), ("data", "model"), device_type="cpu")
x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
xa = steps.lay_out(x, sharding.NamedSharding(mesh, (("pod", "data"),
                                                     "model")))
d = os.path.join(os.path.dirname(store), "ckpt")
save_pytree(d, 3, {"x": xa}, write=rank == 0)
dist.barrier()
out = restore_pytree(d, 3, {"x": x}, device="cpu",
                     shardings={"x": sharding.NamedSharding(
                         mesh_b, ("data", "model"))})
c = dict(zip(mesh_b.mesh_dim_names, mesh_b.get_coordinate()))
OUT["reshard"] = {
    "whole_equal": bool(torch.equal(out["x"].full_tensor(), x)),
    "block_equal": bool(torch.equal(out["x"].to_local(),
                                    x[2 * c["data"]:2 * c["data"] + 2,
                                      4 * c["model"]:4 * c["model"] + 4])),
    "mesh": dict(zip(out["x"].device_mesh.mesh_dim_names,
                     out["x"].device_mesh.shape))}
dist.barrier()

# train_loop on the mesh through a failure, re-meshed, resumed
cfg = get_smoke_config("granite_3_2b").replace(dtype="float32")
tcfg = steps.TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=12)
ck = os.path.join(os.path.dirname(store), "loop")
kw = dict(global_batch=8, seq_len=32, steps=12, log=lambda *a: None,
          device="cpu")
try:
    train_loop(cfg, tcfg, mesh=mesh, ckpt_dir=ck, ckpt_every=4, fail_at=9,
               **kw)
    alive = None
except HostFailure as e:
    alive = 8 - len(e.dead_hosts)
shape, axes = plan_elastic_mesh(alive_chips=6, model_axis=2, chips_per_pod=4)
mesh_c = make_elastic_mesh(shape, axes, device_type="cpu")
ck_copy = ck + "_copy"
if rank == 0:
    import shutil
    shutil.copytree(ck, ck_copy)
dist.barrier()
res = {"alive": alive, "shape": list(shape), "axes": list(axes)}
if mesh_c.get_coordinate() is not None:
    got = train_loop(cfg, tcfg, mesh=mesh_c, ckpt_dir=ck, ckpt_every=4,
                     **kw)["losses"]
    replay = train_loop(cfg, tcfg, mesh=mesh_c, ckpt_dir=ck_copy,
                        ckpt_every=100, **kw)["losses"]
    full = train_loop(cfg, tcfg, mesh=mesh_c, **kw)["losses"]
    res.update(resumed=got, replay=replay, uninterrupted=full[8:])
OUT["loop"] = res
print(json.dumps(OUT))
dist.barrier()
dist.destroy_process_group()
"""


def _outputs(res):
    assert not failures(res), failures(res)
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in res]


def _reference(arch, edit, n_steps, seq, prompt_len):
    """The reference on the ranks' inputs: per-step (loss, grad norm) of
    its ``make_train_step`` from ``init_params(0)``'s weights, and a
    function of the ranks' prompt and fed tokens that gives its
    last-position logits of ``prefill`` and of each ``decode_step`` from
    ``init_params(1)``'s."""
    tc = get_smoke_config(arch).replace(dtype="float32", **edit)
    jc = jcfgs.get_smoke_config(arch).replace(dtype="float32", **edit)

    def weights(seed):
        return jax.tree.map(jnp.asarray, tmodels.params_to_numpy(
            tmodels.init_params(seed, tc, device="cpu")))

    def train(tcfg):
        jp = weights(0)
        state = jsteps.TrainState(
            jp, jsteps.adamw_init(jp),
            jax.tree.map(lambda _: jnp.zeros((), jnp.float32), jp),
            jnp.zeros((), jnp.int32))
        stand_in = types.SimpleNamespace(shape={"data": 1, "model": 1},
                                         axis_names=("data", "model"))
        step = jax.jit(jsteps.make_train_step(jc, tcfg, stand_in, TRAIN_B))
        dc = SyntheticConfig(vocab_size=tc.vocab_size, seq_len=seq,
                             global_batch=TRAIN_B, seed=0)
        out = []
        for s in range(n_steps):
            batch = {k: jnp.asarray(v.numpy())
                     for k, v in batch_for_step(dc, s, device="cpu").items()}
            state, m = step(state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out

    def serve(prompt, fed):
        P, B = prompt.shape[1], prompt.shape[0]

        def run(p, prompt, fed):
            lg, c = jmodels.prefill(p, jc, prompt, max_len=P + SERVE_NEW)
            outs = [lg[:, -1]]
            for i in range(SERVE_NEW):
                lg, c = jmodels.decode_step(p, jc, fed[:, i:i + 1],
                                            jnp.full((B,), P + i, jnp.int32),
                                            c)
                outs.append(lg[:, -1])
            return jnp.stack(outs)
        return np.asarray(jax.jit(run)(weights(1), prompt, fed))
    return train, serve


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(each rank's JSON line, each case's logits files by rank, the
    reference's per-step metrics and its serving function by case) of the
    one eight-rank program; the reference runs here while the ranks do.
    The one-rank program starts once the eight ranks have ended, beside
    the reference's serving below (the ``one_rank`` fixture waits)."""
    work = tmp_path_factory.mktemp("ranks")
    wait = start_ranks(_RANKS, 8, str(work / "store"), timeout=600,
                       OMP_NUM_THREADS="1")
    ref, default = {}, jattn.BLOCKWISE_THRESHOLD
    with pytest.MonkeyPatch.context() as mp:
        for case, arch, edit, n, seq, prompt in CASES:
            mp.setattr(jattn, "BLOCKWISE_THRESHOLD",
                       PADDED_THRESHOLD if case == "padded" else default)
            base, _, cast = case.partition("+")
            tcfg = jsteps.TrainConfig(
                sharding_mode="fsdp" if base == "fsdp" else "tp",
                cast_params=bool(cast))
            train, serve = _reference(arch, edit, n, seq, prompt)
            ref[case] = (train(tcfg), serve if prompt else None)
        outs = _outputs(wait())
        _ONE_RANK_WAIT.append(start_ranks(
            _ONE_RANK, 1, str(tmp_path_factory.mktemp("world1") / "store"),
            timeout=200, OMP_NUM_THREADS="1"))
        # the reference serves the tokens the ranks fed (patched as above
        # for the padded case, which runs last)
        served = {}
        for case, arch, edit, n, seq, prompt in CASES:
            if not prompt:
                continue
            mp.setattr(jattn, "BLOCKWISE_THRESHOLD",
                       PADDED_THRESHOLD if case == "padded" else default)
            half = range(4) if case == "tp" else range(4, 8)
            files = [np.load(work / f"{case}_r{r}.npz") for r in half]
            want = ref[case][1](files[0]["prompt"], files[0]["fed"])
            served[case] = (files, want)
    return outs, ref, served


@pytest.fixture(scope="module")
def world4(ranks):
    """The world-4 cases: each of the four entries joins rank ``i``'s
    results on the (2, 2) mesh with rank ``4 + i``'s on the (1, 4) one."""
    outs, ref, served = ranks
    return [{**outs[i], **outs[4 + i]} for i in range(4)], ref, served


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _held_to_reference(outs, ref, case):
    want = ref[case][0]
    for out in outs:
        got = out[case]
        assert len(got) == len(want)
        for (loss, gn), (wloss, wgn) in zip(got, want):
            assert _rel(loss, wloss) <= TOL, (case, got, want)
            assert _rel(gn, wgn) <= TOL, (case, got, want)


def _served_as_reference(served, case):
    files, want = served[case]
    scale = float(np.abs(want).max())
    for f in files:
        assert np.array_equal(f["prompt"], files[0]["prompt"])
        assert np.array_equal(f["fed"], files[0]["fed"])
        err = float(np.abs(f["logits"] - want).max())
        assert err <= TOL * scale, (case, err, scale)
        # the greedy tokens the ranks fed are the reference's too
        assert np.array_equal(f["fed"], want[:-1].argmax(-1).T), case


@pytest.mark.parametrize("mode", ["tp", "fsdp", "tp+cast"])
def test_sharded_train_step_matches_unsharded(world4, mode):
    outs, ref, _ = world4
    assert all(out["mesh"] == [2, 2] for out in outs)
    _held_to_reference(outs, ref, mode)


def test_local_shards_are_the_reference_blocks(world4):
    for out in world4[0]:
        assert out["blocks"]["checked"] > 10
        assert out["blocks"]["bad"] == []


def test_sharded_prefill_and_decode_match(world4):
    _served_as_reference(world4[2], "tp")


@pytest.mark.parametrize("case", ["ep", "tp_moe"])
def test_moe_under_ep_and_tp_moe(world4, case):
    outs, ref, served = world4
    for out in outs:
        lay = out[case + "_layout"]
        assert lay["ep"] == (case == "ep")
        # EP splits the expert dim over model=4; TP-MoE the hidden dim
        assert (lay["w_gate_local"][0] < 6) == (case == "ep")
    _held_to_reference(outs, ref, case)
    _served_as_reference(served, case)


def test_padded_heads_match_the_unpadded_path(world4):
    outs, ref, served = world4
    assert all(out["padded_heads"] == 8 for out in outs)
    _held_to_reference(outs, ref, "padded")
    _served_as_reference(served, "padded")


def test_a_dtensor_reaching_another_kernel_raises(world4):
    for out in world4[0]:
        assert out["kernel_refuses"] and "sketch_accum" in out[
            "kernel_refuses"]


@pytest.fixture(scope="module")
def world8(ranks):
    return ranks[0]


def test_randlr_on_a_pod_mesh_stays_near_dense(world8):
    for out in world8:
        d, r = out["randlr"]["dense"], out["randlr"]["rcomp"]
        assert abs(d[0] - r[0]) / d[0] < 0.05, out["randlr"]
        assert r[1] > 0 and 0 < r[2] < 1


def test_checkpoint_restores_onto_another_mesh(world8):
    for out in world8:
        r = out["reshard"]
        assert r["whole_equal"] and r["block_equal"]
        assert r["mesh"] == {"data": 4, "model": 2}


def test_train_loop_failure_recovery_on_a_mesh(world8):
    ran = 0
    for out in world8:
        r = out["loop"]
        assert r["alive"] == 7
        assert r["shape"] == [2, 2] and r["axes"] == ["data", "model"]
        if "resumed" not in r:
            continue
        ran += 1
        assert len(r["resumed"]) == 4
        assert r["replay"] == r["resumed"]
        assert all(abs(a - b) < 0.15
                   for a, b in zip(r["resumed"], r["uninterrupted"]))
    assert ran == 4


_ONE_RANK = r"""
import json, runpy, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
# the train CLI: its own one-rank gloo group, the host mesh (1, 1)
argv, sys.argv = sys.argv, ["train", "--arch", "granite-3-2b", "--smoke",
                            "--device", "cpu", "--mesh", "--steps", "3",
                            "--batch", "4", "--seq", "32"]
runpy.run_module("repro_torch.launch.train", run_name="__main__")
# the step on a (1, 1) mesh against the plain step, at an lr that moves
dist.init_process_group("gloo", init_method=f"file://{argv[3]}", rank=0,
                        world_size=1)
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticConfig, batch_for_step
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
mesh = make_host_mesh(device_type="cpu")
out = {}
for dt in ("float32", "bfloat16"):
    cfg = get_smoke_config("granite_3_2b").replace(dtype=dt)
    tc = steps.TrainConfig(peak_lr=3e-4, warmup_steps=1, total_steps=10)
    runs = []
    for m in (None, mesh):
        st = steps.init_train_state(0, cfg, tc, device="cpu", mesh=m)
        fn = steps.make_train_step(cfg, tc, mesh=m)
        dc = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=32,
                             global_batch=4, seed=0)
        ms = []
        for s in range(4):
            st, met = fn(st, batch_for_step(dc, s, device="cpu"))
            ms.append([float(met["loss"]), float(met["grad_norm"])])
        runs.append(ms)
    out[dt] = runs
# the sharded prefill and greedy decode on (1, 1) against the plain ones
from repro_torch import models
cfg = get_smoke_config("granite_3_2b").replace(dtype="float32")
toks = torch.randint(0, cfg.vocab_size, (2, 24),
                     generator=torch.Generator().manual_seed(0))
plain = models.init_params(1, cfg, device="cpu")
pf, pshard, _, _ = steps.sharded_prefill(cfg, mesh, 2, 32)
dfn, _, _ = steps.sharded_decode_step(cfg, mesh, 2, 32)
laid = models.init_params(1, cfg, device="cpu")
from repro_torch.launch import sharding
sharding.distribute_params(laid, mesh, cfg, shardings=pshard)
lp, cp = models.prefill(plain, cfg, toks, max_len=32)
ls, cs = pf(laid, {"tokens": toks})
same = [bool(torch.equal(ls.full_tensor(), lp))]
for i in range(6):
    tok = lp[:, -1].argmax(-1)[:, None]
    lp, cp = models.decode_step(plain, cfg, tok, 24 + i, cp)
    ls, cs = dfn(laid, tok, 24 + i, cs)
    same.append(bool(torch.equal(ls.full_tensor(), lp)))
out["serve"] = same
print(json.dumps(out))
dist.destroy_process_group()
"""


_ONE_RANK_WAIT: list = []


@pytest.fixture(scope="module")
def one_rank(ranks, tmp_path_factory):
    """The one-rank program's output (started after the eight ranks)."""
    res = _ONE_RANK_WAIT.pop()()
    assert not failures(res), failures(res)
    return res[0][1]


def test_train_cli_on_a_host_mesh(one_rank):
    """``launch.train --mesh`` joins a one-rank gloo group of its own and
    trains SMOKE granite on the host mesh (1, 1)."""
    assert "final loss" in one_rank


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_device_mesh_step_is_the_plain_step(one_rank, dtype):
    """On a (1, 1) mesh the sharded step runs the general code (the
    vocab-parallel loss, DTensor parameters, the flash op on the local
    shard) with no collective, and gives the plain step's bits: four steps
    at lr 3e-4, where AdamW's near-sign update would carry any other
    rounding of a gradient into the next loss (as the card's phase mesh
    holds at full width)."""
    plain, sharded = json.loads(one_rank.strip().splitlines()[-1])[dtype]
    assert sharded == plain


def test_one_device_mesh_serving_is_the_plain_serving(one_rank):
    """On a (1, 1) mesh the sharded prefill and six decode steps (the
    sequence-split decode attention, with nothing split) give the plain
    path's logits bit for bit (f32), as the card's phase mesh holds at
    full width, where its greedy tokens must equal the plain ones."""
    same = json.loads(one_rank.strip().splitlines()[-1])["serve"]
    assert same == [True] * 7
