"""The training step (counterpart of the training half of
``repro.launch.steps``): ``TrainState``, ``TrainConfig``,
``init_train_state`` and ``make_train_step``.

One process, one device: the reference's shardings, ``jit_train_step``
and the serving step functions wait for the port's sharding (ROADMAP
Queue A item 3.7).  The step runs eagerly and updates the state in place
(the parameters, the AdamW moments and the error-feedback buffers), since
at granite-3-2b's width a second copy of them would not fit the card.

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
from ..models.transformer import Transformer, init_params, loss_fn
from ..optim import (AdamWState, CompressorConfig, adamw_init, adamw_update,
                     clip_by_global_norm, compress_grads, ef_init,
                     warmup_cosine)

__all__ = ["TrainState", "TrainConfig", "init_train_state",
           "make_train_step", "state_tree", "load_state_tree"]


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


def init_train_state(gen_or_seed, cfg: ModelConfig, tcfg: TrainConfig,
                     npods: int = 1, *, device="cuda") -> TrainState:
    """A model from ``gen_or_seed`` (``models.init_params``) with its
    parameters requiring grad, zero moments and EF buffers, step 0."""
    model = init_params(gen_or_seed, cfg, device=device)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    ccfg = tcfg.compress or CompressorConfig()
    dev = model.embed.tok.device
    ef = (ef_init(params, ccfg, npods) if tcfg.compress and npods > 1
          else {k: torch.zeros((), device=dev) for k in params})
    return TrainState(params=model, opt=adamw_init(params), ef=ef,
                      step=torch.zeros((), dtype=torch.int32, device=dev))


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
    time)."""
    def copy(dst: dict, src: dict):
        for key, t in dst.items():
            if isinstance(t, dict):
                copy(t, src[key])
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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *, npods: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the
    state's tensors are updated in place.

    With ``tcfg.compress`` and ``npods > 1`` the batch is cut into
    ``npods`` groups along its first axis, each group's gradients are
    computed apart and stacked on a leading axis (the reference's ``vmap``
    over pods), and they are reduced through the RandLR low-rank path
    (``optim.compress_grads``, Omega seeded from the step)."""
    use_compress = tcfg.compress is not None and npods > 1

    def grads_of(model: Transformer, batch: dict) -> tuple[dict, dict]:
        params = dict(model.named_parameters())
        total, metrics = loss_fn(model, cfg, batch)
        grads = torch.autograd.grad(total, list(params.values()))
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

    def train_step(state: TrainState, batch: dict):
        if use_compress and batch["tokens"].shape[0] % npods:
            raise ValueError(f"batch of {batch['tokens'].shape[0]} does not "
                             f"split into {npods} pod groups")
        with _deterministic(state.step.device):
            if not use_compress:
                metrics, grads = grads_of(state.params, batch)
                opt, metrics = apply_updates(state, grads, metrics)
                return TrainState(state.params, opt, state.ef,
                                  state.step + 1), metrics
            per_pod = [grads_of(state.params,
                                {k: t.chunk(npods, 0)[p]
                                 for k, t in batch.items()})
                       for p in range(npods)]
            metrics = {k: torch.stack([m[k] for m, _ in per_pod]).mean(0)
                       for k in per_pod[0][0]}
            grads_pp = {k: torch.stack([g[k] for _, g in per_pod])
                        for k in per_pod[0][1]}
            del per_pod
            grads, ef, cstats = compress_grads(
                block_seed(0, int(state.step)), grads_pp, state.ef,
                tcfg.compress)
            opt, metrics = apply_updates(state, grads, metrics)
            metrics["compress_ratio"] = torch.tensor(
                cstats["ratio"], dtype=torch.float32)
            return TrainState(state.params, opt, ef, state.step + 1), metrics

    return train_step
