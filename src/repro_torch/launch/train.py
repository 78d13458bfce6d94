"""Training loop and CLI (counterpart of ``repro.launch.train``): the
fault-tolerant loop.

  data (replayable from (seed, step)) -> train step (+ optional RandLR
  gradient compression over pod groups) -> async checkpoints -> heartbeat
  and straggler monitors -> restore on restart.

One process on one device (``device``, the card unless ``cpu`` is
asked), or, with ``mesh=``, every rank of a ``DeviceMesh`` running the
sharded step (``launch.steps``): the same data on every rank, laid out by
the step, checkpoints gathered whole and written by the mesh's first rank,
so a run restores onto another mesh (the reference's elastic re-mesh).
The CLI's ``--mesh`` trains on the host mesh over the ranks of its
process group (``torchrun``'s, or its own one-rank group), and
``--production`` on the 16x16 pod mesh (256 ranks).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --smoke --device cpu --steps 20 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --steps 5 --batch 2 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --smoke --device cpu --mesh --steps 5 --batch 4 --seq 64
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.rng import check_device
from repro_torch.data import SyntheticConfig, batch_for_step
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import (TrainConfig, init_train_state,
                                      load_state_tree, make_train_step,
                                      state_tree)
from repro_torch.obs.clock import now as obs_now
from repro_torch.optim import CompressorConfig
from repro_torch.runtime import Coordinator, HostFailure, StragglerMonitor


def _host_copy(tree: dict) -> dict:
    """A host copy of a state tree for the checkpoint writer: the step
    updates the state in place, and the writer shares a CPU tensor's
    memory, so it must get tensors no later step writes into.  A DTensor
    is gathered whole (a collective over its mesh)."""
    def host(v):
        if isinstance(v, DTensor):
            v = v.full_tensor()
        return v.detach().to("cpu", copy=True)
    return {k: _host_copy(v) if isinstance(v, dict) else host(v)
            for k, v in tree.items()}


def train_loop(cfg, tcfg: TrainConfig, *, global_batch: int, seq_len: int,
               steps: int, ckpt_dir: str | None = None, ckpt_every: int = 50,
               log_every: int = 10, fail_at: int | None = None, seed: int = 0,
               npods: int = 1, log=print, device="cuda", mesh=None) -> dict:
    """Returns ``{"losses", "final", "history", "state"}``: the loss of
    each step run, the last step's metrics as floats, a record a step
    (``step``, synchronized ``seconds``, ``loss``, ``grad_norm``, ``lr``)
    and the final ``TrainState``.  A checkpoint in ``ckpt_dir`` is resumed
    from; ``fail_at`` injects a host failure after that step (tests).
    ``mesh``: train sharded on it (every rank of the mesh calls; the pod
    axis gives ``npods``)."""
    dev = check_device(device)
    data_cfg = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                               global_batch=global_batch, seed=seed)
    step_fn = make_train_step(cfg, tcfg, npods=npods, mesh=mesh)
    first = mesh is None or not any(mesh.get_coordinate())
    mgr = (CheckpointManager(ckpt_dir, keep=3, write=first) if ckpt_dir
           else None)
    coord = Coordinator(n_hosts=1)
    mon = StragglerMonitor(n_hosts=1)

    state = init_train_state(seed, cfg, tcfg, npods, device=dev, mesh=mesh)
    start = 0
    if mgr is not None:
        restored, tree = mgr.restore_latest(state_tree(state), host=True)
        if restored is not None:
            start = restored
            state = load_state_tree(state, tree)
            del tree
            log(f"restored checkpoint at step {start}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses, history = [], []
    metrics = {}
    for s in range(start, steps):
        t0 = obs_now()
        # mon.step times the synchronized step with the obs clock and feeds
        # this host's EWMA (straggler detection).
        with mon.step(0):
            batch = batch_for_step(data_cfg, s, device=dev)
            state, metrics = step_fn(state, batch)
            sync()
        seconds = obs_now() - t0
        coord.heartbeat(0)
        try:
            if fail_at is not None and s == fail_at:
                # injected failure (tests / chaos drills): a peer host died
                raise HostFailure([1], alive=max(0, coord.n_hosts - 1))
            coord.check()
        except HostFailure:
            if mgr is not None:
                mgr.wait()   # never lose the last in-flight checkpoint
            raise
        losses.append(float(metrics["loss"]))
        history.append({"step": s + 1, "seconds": seconds,
                        "loss": losses[-1],
                        "grad_norm": float(metrics["grad_norm"]),
                        "lr": float(metrics["lr"])})
        if mgr is not None and (s + 1) % ckpt_every == 0:
            mgr.save(s + 1, _host_copy(state_tree(state)))
        if (s + 1) % log_every == 0:
            log(f"step {s + 1:5d}  loss {losses[-1]:.4f}  "
                f"lr {history[-1]['lr']:.2e}  "
                f"gnorm {history[-1]['grad_norm']:.3f}  "
                f"{obs_now() - t0:.2f}s")
    if mgr is not None:
        mgr.save(steps, _host_copy(state_tree(state)))
        mgr.wait()
    return {"losses": losses, "history": history, "state": state,
            "final": {k: float(v) for k, v in metrics.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress-rank", type=int, default=0,
                    help="RandLR gradient compression rank (0 = off)")
    ap.add_argument("--npods", type=int, default=1,
                    help="pod groups the batch is cut into for compression")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", action="store_true",
                    help="train sharded on the host mesh over the ranks of "
                         "the process group")
    ap.add_argument("--production", action="store_true",
                    help="train sharded on the 16x16 pod mesh (256 ranks)")
    args = ap.parse_args(argv)
    # The step is deterministic on the card (``launch.steps``); cuBLAS
    # reads its workspace setting when the process makes its first GEMM.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(
        peak_lr=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10),
        compress=(CompressorConfig(rank=args.compress_rank)
                  if args.compress_rank else None))
    mesh = None
    joined = False
    if args.mesh or args.production:
        if not dist.is_initialized():
            _join_group(args.device)
            joined = True
        mesh = (make_production_mesh(device_type=args.device)
                if args.production
                else make_host_mesh(device_type=args.device))
    try:
        out = train_loop(cfg, tcfg, global_batch=args.batch, seq_len=args.seq,
                         steps=args.steps, ckpt_dir=args.ckpt_dir,
                         npods=args.npods, device=args.device, mesh=mesh)
    finally:
        if joined:
            dist.destroy_process_group()
    print(f"final loss {out['losses'][-1]:.4f} "
          f"(first {out['losses'][0]:.4f})")
    return out


def _join_group(device: str) -> None:
    """Join ``torchrun``'s group from its environment, or a one-rank group
    of this process (NCCL on the card, gloo on the CPU)."""
    backend = "nccl" if device == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        return
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)


if __name__ == "__main__":
    main()
