"""Training on the port, end to end: an LM trained for a few hundred
steps through the whole stack -- the sharded train step on a mesh over
the ranks (gloo ranks on the CPU, one rank a card over NCCL), AdamW with
the cosine schedule, deterministic data, checkpoints, and optional RandLR
gradient compression.

  PYTHONPATH=src python examples/torch/train_lm.py [--device cpu] \\
      [--arch xlstm-125m] [--steps 300] [--scale 0.25] [--compress-rank 8]

``--scale`` shrinks width and depth (1.0 is the real config).
"""
import argparse
import os
import sys
import tempfile

import torch.distributed as dist

from ranks import add_rank_args, launch
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import TrainConfig
from repro_torch.launch.train import train_loop
from repro_torch.optim import CompressorConfig


def scaled(cfg, s: float):
    def rnd(x, mult):
        return max(mult, int(x * s) // mult * mult)
    kw = dict(
        n_layers=max(2, int(cfg.n_layers * s)),
        d_model=rnd(cfg.d_model, 64),
        n_heads=max(2, int(cfg.n_heads * s)),
        n_kv_heads=max(2, min(cfg.n_kv_heads, int(cfg.n_heads * s))),
        d_ff=rnd(cfg.d_ff, 64) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 8192),
    )
    if cfg.head_dim is not None:
        kw["head_dim"] = rnd(cfg.head_dim, 16)
    if cfg.moe:
        kw["n_experts"] = max(4, int(cfg.n_experts * s))
        kw["moe_d_ff"] = rnd(cfg.moe_d_ff, 64)
    if cfg.family == "ssm":
        kw["slstm_at"] = tuple(i for i in cfg.slstm_at
                               if i < kw["n_layers"])
    return cfg.replace(**kw)


def body(args, group, dev):
    rank = dist.get_rank(group)
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = scaled(get_config(args.arch), args.scale)
    say(f"{cfg.name} @ scale {args.scale}: ~{cfg.param_count() / 1e6:.1f}M "
        f"params, {cfg.n_layers}L d={cfg.d_model}")
    mesh = make_host_mesh(device_type=dev.type)
    say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} on {dev.type}")
    tcfg = TrainConfig(
        peak_lr=args.lr, total_steps=args.steps,
        warmup_steps=max(5, args.steps // 20),
        compress=(CompressorConfig(rank=args.compress_rank)
                  if args.compress_rank else None))
    out = train_loop(cfg, tcfg, mesh=mesh, global_batch=args.batch,
                     seq_len=args.seq, steps=args.steps,
                     ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=20,
                     log=say, device=dev)
    ls = out["losses"]
    say(f"\nloss: start {ls[0]:.3f} -> min {min(ls):.3f} -> "
        f"final {ls[-1]:.3f} over {len(ls)} steps")
    assert ls[-1] < ls[0] - 0.5, "model failed to learn the synthetic task"
    say("learning verified (>0.5 nats drop).")
    return ls


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--compress-rank", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    add_rank_args(ap, cpu_ranks=4)
    args = ap.parse_args(argv)
    return launch(os.path.abspath(__file__), argv, args, body)


if __name__ == "__main__":
    main()
