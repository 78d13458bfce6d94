"""The step functions (counterpart of ``repro.launch.steps``): ``TrainState``,
``TrainConfig``, ``init_train_state`` and ``make_train_step``, and the
sharded steps ``sharded_train_step``, ``sharded_prefill`` and
``sharded_decode_step`` (the reference's ``jit_train_step``,
``jit_prefill`` and ``jit_decode_step``), each returning the reference's
tuple: the step, the shapes, and the placements of the state and of the
batch.

Without a mesh the step runs eagerly on one device and updates the state
in place (the parameters, the AdamW moments and the error-feedback
buffers), since at granite-3-2b's width a second copy of them would not
fit the card.  Under a mesh (``mesh=``, a ``DeviceMesh`` of
``launch.mesh``) the state's tensors are DTensors laid out by
``launch.sharding`` (the moments follow the parameters, the EF buffers
carry a leading pod dim over ``"pod"``), the batch is laid out on entry,
the model's hints act (``models.pshard.use_mesh``), and every op runs
under ``implicit_replication`` (rope tables, masks and carries are plain
tensors, the same on every rank).  The flash kernel runs on each rank's
local heads.  With ``mesh=None`` nothing of this happens: the step is the
single-device one, bit for bit.

Repeatability: the step runs with ``torch.use_deterministic_algorithms``
on, so two runs from one state and one batch give the same bits on the
card (the embedding's and the gold logits' gathers have backward passes
that add into shared rows, and the order of those adds is fixed that
way).  On the card cuBLAS then needs ``CUBLAS_WORKSPACE_CONFIG`` (say
``:4096:8``) in the environment from the start of the process, before its
first GEMM, as ``launch.train``'s CLI sets it; a step on a CUDA device
without it raises.
"""
from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Optional

import torch

from ..core.rng import block_seed
from ..models.config import ModelConfig
from ..models.pshard import (distribute, dp_axes, is_dtensor, resolve_spec,
                             use_mesh, wrap)
from ..models.transformer import (Transformer, caches_shape, init_params,
                                  loss_fn, params_shape)
from ..models.transformer import decode_step as model_decode
from ..models.transformer import prefill as model_prefill
from ..optim import (AdamWState, CompressorConfig, adamw_init, adamw_update,
                     clip_by_global_norm, compress_grads, ef_init,
                     warmup_cosine)
from .mesh import axis_names, axis_sizes
from .sharding import (NamedSharding, batch_spec, cache_shardings,
                       distribute_params, lay_out_caches, param_shardings,
                       train_batch_specs)

__all__ = ["TrainState", "TrainConfig", "init_train_state",
           "make_train_step", "state_tree", "load_state_tree",
           "train_state_shape", "train_state_shardings",
           "sharded_train_step", "sharded_prefill", "sharded_decode_step",
           "lay_out"]


class TrainState(NamedTuple):
    params: Transformer        # its parameters require grad
    opt: AdamWState
    ef: dict                   # error-feedback buffers (scalar zeros when
                               # compression is off)
    step: torch.Tensor         # int32 scalar


class TrainConfig(NamedTuple):
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0
    weight_decay: float = 0.1
    compress: Optional[CompressorConfig] = None
    sharding_mode: str = "tp"          # "tp" (Megatron TP + FSDP) or
                                       # "fsdp" (ZeRO-3)
    cast_params: bool = False          # pre-cast big f32 weights to the
                                       # compute dtype once a step (the same
                                       # math: the model casts at every use)


# Leaves the model deliberately consumes in f32 (routing/SSM numerics):
# never pre-cast these.
_KEEP_F32 = {"router", "A_log", "dt_bias", "D", "b_in",
             "w_igate", "w_fgate", "b_igate", "b_fgate"}


def _cast_params_for_compute(params: dict, cfg: ModelConfig) -> dict:
    """The big f32 weights (at least two dims and 65,536 elements, not in
    ``_KEEP_F32``) cast to the compute dtype, by name.  A DTensor keeps
    its placements through the cast, so what the layout then moves is the
    narrow copy (the reference pins the cast to the spec for the same
    reason)."""
    out = {}
    for name, p in params.items():
        if (p.dim() >= 2 and p.dtype == torch.float32
                and name.rsplit(".", 1)[-1] not in _KEEP_F32
                and p.numel() >= (1 << 16)):
            out[name] = p.to(cfg.compute_dtype)
    return out


def init_train_state(gen_or_seed, cfg: ModelConfig, tcfg: TrainConfig,
                     npods: int = 1, *, device="cuda", mesh=None
                     ) -> TrainState:
    """A model from ``gen_or_seed`` (``models.init_params``) with its
    parameters requiring grad, zero moments and EF buffers, step 0.  With
    ``mesh`` (every rank calling with one seed) the state is laid out by
    ``train_state_shardings`` and ``npods`` is the mesh's pod axis."""
    model = init_params(gen_or_seed, cfg, device=device)
    if mesh is not None:
        npods = axis_sizes(mesh).get("pod", 1)
        distribute_params(model, mesh, cfg, tcfg.sharding_mode)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    ccfg = tcfg.compress or CompressorConfig()
    dev = torch.device(device)
    if not (tcfg.compress and npods > 1):
        ef = {k: torch.zeros((), device=dev) for k in params}
    elif mesh is None:
        ef = ef_init(params, ccfg, npods)
    else:
        # ef_init's shapes, then each rank's block of zeros alone
        from torch.distributed.tensor import zeros as dzeros
        shd = train_state_shardings(
            cfg, train_state_shape(cfg, tcfg, npods), mesh,
            tcfg.sharding_mode).ef
        ef = {k: (torch.zeros((), device=dev) if e.dim() == 0 else
                  dzeros(e.shape, dtype=e.dtype, device_mesh=mesh,
                         placements=shd[k].placements))
              for k, e in ef_init({k: torch.empty(p.shape, dtype=p.dtype,
                                                  device="meta")
                                   for k, p in params.items()},
                                  ccfg, npods).items()}
    return TrainState(params=model, opt=adamw_init(params), ef=ef,
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def train_state_shape(cfg: ModelConfig, tcfg: TrainConfig, npods: int = 1
                      ) -> TrainState:
    """The state on the ``meta`` device (shapes and dtypes)."""
    model = params_shape(cfg)
    params = dict(model.named_parameters())
    ccfg = tcfg.compress or CompressorConfig()
    ef = (ef_init(params, ccfg, npods) if tcfg.compress and npods > 1
          else {k: torch.zeros((), device="meta") for k in params})
    return TrainState(params=model, opt=adamw_init(params), ef=ef,
                      step=torch.zeros((), dtype=torch.int32, device="meta"))


def train_state_shardings(cfg: ModelConfig, state_shape: TrainState, mesh,
                          mode: str = "tp") -> TrainState:
    """Param shardings extend to the optimizer moments and the EF buffers
    (which carry a leading pod axis, sharded over ``pod``)."""
    pshard = param_shardings(cfg, state_shape.params, mesh, mode)
    rep = NamedSharding(mesh, ())
    lead = ("pod",) if "pod" in axis_names(mesh) else (None,)

    def ef_shard(name, leaf):
        if leaf.dim() == 0:
            return rep
        return NamedSharding(mesh, lead + tuple(pshard[name].spec))

    return TrainState(
        params=pshard,
        opt=AdamWState(mu=pshard, nu=pshard, count=rep),
        ef={k: ef_shard(k, e) for k, e in state_shape.ef.items()},
        step=rep)


def lay_out(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``t`` laid out by ``sharding``: a DTensor redistributed, a plain
    tensor (the same on every rank) distributed.  A scalar spec leaves a
    plain tensor as it is."""
    if not sharding.spec and not is_dtensor(t):
        return t
    pl = sharding.placements
    if is_dtensor(t):
        return t if tuple(t.placements) == pl else t.redistribute(
            sharding.mesh, pl)
    return distribute(t, sharding.mesh, pl)


def _plain(t):
    """A DTensor's full value (a collective on every rank of its mesh)."""
    return t.full_tensor() if is_dtensor(t) else t


@contextlib.contextmanager
def _on_mesh(mesh):
    """The active mesh for the model's hints, and mixed DTensor / plain
    operands allowed (plain ones count as replicated)."""
    from torch.distributed.tensor.experimental import implicit_replication
    with use_mesh(mesh), implicit_replication():
        yield


def state_tree(state: TrainState) -> dict:
    """The state as a tree of tensors (``checkpoint.save_pytree``'s
    input), the parameters by name."""
    return {"params": dict(state.params.named_parameters()),
            "opt": {"mu": state.opt.mu, "nu": state.opt.nu,
                    "count": state.opt.count},
            "ef": state.ef, "step": state.step}


@torch.no_grad()
def load_state_tree(state: TrainState, tree: dict) -> TrainState:
    """Copy ``tree`` (``state_tree``'s structure, tensors or numpy arrays,
    as ``restore_pytree`` gives them) into ``state``'s tensors, in place,
    leaf by leaf (a restore from the host holds one leaf on the card at a
    time).  A DTensor leaf takes this rank's block of the whole it is
    given (the whole as any mesh saved it)."""
    from ..models.pshard import _local_block

    def copy(dst: dict, src: dict):
        for key, t in dst.items():
            if isinstance(t, dict):
                copy(t, src[key])
            elif is_dtensor(t):
                whole = torch.as_tensor(src[key])
                t.to_local().copy_(_local_block(whole, t.device_mesh,
                                                t.placements))
            else:
                t.copy_(torch.as_tensor(src[key]))
    copy(state_tree(state), tree)
    return state


@contextlib.contextmanager
def _deterministic(device: torch.device):
    """``torch.use_deterministic_algorithms(True)`` for the block, without
    filling fresh allocations (nothing reads them before writing).  On a
    CUDA device ``CUBLAS_WORKSPACE_CONFIG`` must be set already: cuBLAS
    reads it when it makes its first workspace, so setting it here would
    only quiet PyTorch's check."""
    import torch.utils.deterministic as det
    if device.type == "cuda" and not os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
        raise RuntimeError(
            "train step: set CUBLAS_WORKSPACE_CONFIG (e.g. ':4096:8') in the "
            "environment before the process's first GEMM on the card; "
            "repeatable steps need a fixed cuBLAS workspace")
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *, npods: int = 1,
                    mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the
    state's tensors are updated in place.

    With ``tcfg.compress`` and ``npods > 1`` the batch is cut into
    ``npods`` groups along its first axis, each group's gradients are
    computed apart and stacked on a leading axis (the reference's ``vmap``
    over pods), and they are reduced through the RandLR low-rank path
    (``optim.compress_grads``, Omega seeded from the step).

    With ``mesh`` the state must be laid out (``init_train_state(...,
    mesh=)``); the batch (plain tensors, the same on every rank, or
    DTensors) is laid out by ``train_batch_specs``, ``npods`` is the mesh's
    pod axis, and the pod groups' batches shard over the remaining dp
    axes (the reference narrows ``dp_axes`` inside its pod ``vmap``).
    The metrics come back as plain tensors."""
    if mesh is not None:
        npods = axis_sizes(mesh).get("pod", 1)
    use_compress = tcfg.compress is not None and npods > 1
    mode = tcfg.sharding_mode
    act_axes = (("pod", "data", "model") if mode == "fsdp"
                else ("pod", "data"))

    def loss_of(model: Transformer, batch: dict):
        if not tcfg.cast_params:
            return loss_fn(model, cfg, batch)
        from torch.nn.utils.stateless import _reparametrize_module
        cast = _cast_params_for_compute(dict(model.named_parameters()), cfg)
        with _reparametrize_module(model, cast):
            return loss_fn(model, cfg, batch)

    def grads_of(model: Transformer, batch: dict) -> tuple[dict, dict]:
        params = dict(model.named_parameters())
        total, metrics = loss_of(model, batch)
        grads = torch.autograd.grad(total, list(params.values()))
        if mesh is not None:     # each gradient laid out as its parameter
            grads = [g.redistribute(p.device_mesh, p.placements)
                     if is_dtensor(g) and g.placements != p.placements else g
                     for g, p in zip(grads, params.values())]
        return ({k: v.detach() for k, v in metrics.items()},
                dict(zip(params, grads)))

    def apply_updates(state: TrainState, grads: dict, metrics: dict):
        grads, gnorm = clip_by_global_norm(grads, tcfg.max_grad_norm)
        lr = warmup_cosine(state.step, peak_lr=tcfg.peak_lr,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)
        _, opt = adamw_update(grads, state.opt,
                              dict(state.params.named_parameters()), lr=lr,
                              weight_decay=tcfg.weight_decay)
        return opt, dict(metrics, grad_norm=gnorm, lr=lr)

    def per_pod_grads(state: TrainState, batch: dict):
        """Each pod group's gradients, stacked on a leading axis."""
        if mesh is not None:
            return pod_grads_on_mesh(state, batch)
        groups = [{k: t.chunk(npods, 0)[p] for k, t in batch.items()}
                  for p in range(npods)]
        per_pod = [grads_of(state.params, g) for g in groups]
        metrics = {k: torch.stack([m[k] for m, _ in per_pod]).mean(0)
                   for k in per_pod[0][0]}
        grads_pp = {k: torch.stack([g[k] for _, g in per_pod])
                    for k in per_pod[0][1]}
        return metrics, grads_pp

    def pod_grads_on_mesh(state: TrainState, batch: dict):
        """The reference's pod ``vmap`` on a mesh: each pod's ranks take
        the gradients of that pod's batch group on their own (data, model)
        sub-mesh, the batch over the remaining dp axes, and the stacked
        gradients are a DTensor whose leading pod dim is sharded over
        ``"pod"``; the metrics are averaged over the pods."""
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.tensor import DTensor, Shard
        from torch.nn.utils.stateless import _reparametrize_module
        names = axis_names(mesh)
        pod = names.index("pod")
        sub = mesh[tuple(a for a in names if a != "pod")]
        inner = tuple(a for a in act_axes if a != "pod")
        me = mesh.get_coordinate()[pod]
        model = state.params
        full = dict(model.named_parameters())
        local = {k: DTensor.from_local(
            p.detach().to_local(), sub,
            [q for i, q in enumerate(p.placements) if i != pod],
            run_check=False).requires_grad_(True) for k, p in full.items()}
        group = {k: t.chunk(npods, 0)[me] for k, t in batch.items()}
        specs = train_batch_specs(cfg, sub, group["tokens"].shape[0], mode)
        with use_mesh(sub), dp_axes(inner), \
                _reparametrize_module(model, local):
            group = {k: lay_out(t, NamedSharding(sub, specs[k]))
                     if k in specs else t for k, t in group.items()}
            total, metrics = loss_of(model, group)
            grads = torch.autograd.grad(total, list(local.values()))
        grads_pp = {}
        for (k, p), g in zip(local.items(), grads):
            g = g.redistribute(sub, p.placements)
            pl = [Shard(q.dim + 1) if q.is_shard() else q
                  for q in p.placements]
            pl.insert(pod, Shard(0))
            grads_pp[k] = wrap(g.to_local()[None], mesh, pl,
                               (npods,) + tuple(g.shape))
        metrics = {k: funcol.all_reduce(_plain(v.detach()), "sum",
                                        (mesh, pod)) / npods
                   for k, v in metrics.items()}
        return metrics, grads_pp

    def step_body(state: TrainState, batch: dict):
        if not use_compress:
            with (dp_axes(act_axes) if mesh is not None
                  else contextlib.nullcontext()):
                metrics, grads = grads_of(state.params, batch)
            opt, metrics = apply_updates(state, grads, metrics)
            return TrainState(state.params, opt, state.ef,
                              state.step + 1), metrics
        metrics, grads_pp = per_pod_grads(state, batch)
        grads, ef, cstats = compress_grads(
            block_seed(0, int(state.step)), grads_pp, state.ef,
            tcfg.compress)
        del grads_pp
        opt, metrics = apply_updates(state, grads, metrics)
        metrics["compress_ratio"] = torch.tensor(
            cstats["ratio"], dtype=torch.float32)
        return TrainState(state.params, opt, ef, state.step + 1), metrics

    def train_step(state: TrainState, batch: dict):
        if use_compress and batch["tokens"].shape[0] % npods:
            raise ValueError(f"batch of {batch['tokens'].shape[0]} does not "
                             f"split into {npods} pod groups")
        with _deterministic(state.step.device):
            if mesh is None:
                return step_body(state, batch)
            with _on_mesh(mesh):
                if use_compress:
                    batch = {k: _plain(t) for k, t in batch.items()}
                else:
                    specs = train_batch_specs(
                        cfg, mesh, batch["tokens"].shape[0], mode)
                    batch = {k: lay_out(t, NamedSharding(mesh, specs[k]))
                             if k in specs else t for k, t in batch.items()}
                state, metrics = step_body(state, batch)
                return state, {k: _plain(v) for k, v in metrics.items()}

    return train_step


def sharded_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                       global_batch: int, state_shape=None):
    """The train step on ``mesh`` with its layouts (the reference's
    ``jit_train_step``): ``(step, state_shape, state_shardings,
    batch_shardings)``.  ``step(state, batch)`` takes a state laid out by
    ``state_shardings`` (``init_train_state(..., mesh=)``)."""
    npods = axis_sizes(mesh).get("pod", 1)
    state_shape = state_shape or train_state_shape(cfg, tcfg, npods)
    st_shard = train_state_shardings(cfg, state_shape, mesh,
                                     tcfg.sharding_mode)
    b_shard = {k: NamedSharding(mesh, s) for k, s in train_batch_specs(
        cfg, mesh, global_batch, tcfg.sharding_mode).items()}
    return (make_train_step(cfg, tcfg, mesh=mesh), state_shape, st_shard,
            b_shard)


# ------------------------------------------------------------------ serving

def _serve_layouts(cfg: ModelConfig, mesh, global_batch: int, seq_len: int):
    b_ax = batch_spec(mesh, global_batch)[0]
    pshard = param_shardings(cfg, params_shape(cfg), mesh)
    c_shard = cache_shardings(cfg, caches_shape(cfg, global_batch, seq_len),
                              mesh, global_batch)
    return b_ax, pshard, c_shard


def _lay_logits(logits: torch.Tensor, mesh, b_ax) -> torch.Tensor:
    """Logits laid out (batch over dp, vocab over `model`), the
    reference's out sharding; an axis that does not divide is dropped."""
    spec = resolve_spec(mesh, logits.shape, (b_ax, None, "model"))
    return lay_out(logits, NamedSharding(mesh, spec))


def _lay_caches(caches: dict, c_shard: dict) -> dict:
    return lay_out_caches(caches, c_shard, lay_out)


def sharded_prefill(cfg: ModelConfig, mesh, global_batch: int, seq_len: int):
    """Prefill on ``mesh`` (the reference's ``jit_prefill``): ``(fn,
    param_shardings, batch_shardings, cache_shardings)``.
    ``fn(params, batch)`` takes a model laid out by ``param_shardings``
    (``sharding.distribute_params``) and ``{"tokens"}`` (and ``"frames"``
    for an encoder-decoder); returns (last logits, caches), laid out."""
    b_ax, pshard, c_shard = _serve_layouts(cfg, mesh, global_batch, seq_len)
    in_b = {"tokens": NamedSharding(mesh, (b_ax, None))}
    if cfg.encdec:
        in_b["frames"] = NamedSharding(mesh, (b_ax, None, None))

    def fn(params: Transformer, batch: dict):
        with _on_mesh(mesh), torch.inference_mode():
            b = {k: lay_out(batch[k], s) for k, s in in_b.items()
                 if k in batch}
            logits, caches = model_prefill(params, cfg, b["tokens"],
                                           max_len=seq_len,
                                           frames=b.get("frames"))
            return (_lay_logits(logits, mesh, b_ax),
                    _lay_caches(caches, c_shard))
    return fn, pshard, in_b, c_shard


def sharded_decode_step(cfg: ModelConfig, mesh, global_batch: int,
                        seq_len: int):
    """One decode step on ``mesh`` (the reference's ``jit_decode_step``):
    ``(fn, param_shardings, cache_shardings)``.  ``fn(params, tokens, pos,
    caches)`` returns (logits, caches), laid out; the caches are written
    in place when they arrive laid out."""
    b_ax, pshard, c_shard = _serve_layouts(cfg, mesh, global_batch, seq_len)
    tok_shard = NamedSharding(mesh, (b_ax, None))
    pos_shard = NamedSharding(mesh, (b_ax,))

    def fn(params: Transformer, tokens, pos, caches: dict):
        with _on_mesh(mesh), torch.inference_mode():
            pos = torch.as_tensor(pos, dtype=torch.int64,
                                  device=tokens.device)
            if pos.dim() == 0:
                pos = pos.expand(tokens.shape[0])
            logits, caches = model_decode(
                params, cfg, lay_out(tokens, tok_shard),
                lay_out(pos, pos_shard), _lay_caches(caches, c_shard))
            return _lay_logits(logits, mesh, b_ax), _lay_caches(caches,
                                                                c_shard)
    return fn, pshard, c_shard
