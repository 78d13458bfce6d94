"""Serving on the port: continuous batching and the paper's low-rank
weights.

Runs the ``ServeEngine`` over a batch of requests twice, dense weights and
RID-compressed weights, and reports the storage saving and the outputs'
drift (the paper's "stored in a much smaller amount of memory" claim,
end to end).

  PYTHONPATH=src python examples/torch/serve_batched.py \\
      [--arch granite-3-2b] [--device cpu]
"""
import argparse
import sys
import time

import torch
from torch import nn

from repro_torch.configs import get_smoke_config
from repro_torch.core.rng import check_device
from repro_torch.models import init_params
from repro_torch.serving import (GenerationRequest, ServeEngine,
                                 compress_params, compression_report)
from repro_torch.serving.compress import LowRankWeight

REQUESTS, MAX_NEW_TOKENS = 8, 12


def run_engine(cfg, params, prompts, label):
    eng = ServeEngine(cfg, params, max_batch=4, max_len=96)
    for i, p in enumerate(prompts):
        eng.submit(GenerationRequest(request_id=i, prompt=p,
                                     max_new_tokens=MAX_NEW_TOKENS))
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    toks = sum(len(r.output) for r in done)
    print(f"  [{label:12s}] {len(done)} requests, {toks} tokens, "
          f"{dt:.1f}s ({toks / dt:.1f} tok/s)")
    return {r.request_id: r.output for r in done}


def materialize(model: nn.Module) -> nn.Module:
    """The model with every factored weight multiplied back out (the
    models take dense weights; ``apply_low_rank`` is the factored
    product)."""
    for mod in model.modules():
        for name, v in list(vars(mod).items()):
            if isinstance(v, LowRankWeight):
                delattr(mod, name)
                mod.register_parameter(name, nn.Parameter(
                    v.materialize().detach(), requires_grad=False))
    return model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--rank", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = check_device(args.device)
    # The SMOKE model with f32 weights; a generous rank lets some layers of
    # the random init pass the energy test.
    cfg = get_smoke_config(args.arch).replace(dtype="float32")
    params = init_params(0, cfg, device=dev)
    g = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab_size,
                             (int(torch.randint(4, 10, (), generator=g)),),
                             generator=g, dtype=torch.int32).numpy()
               for _ in range(REQUESTS)]

    print(f"{cfg.name} (reduced) on {dev}: serving {len(prompts)} requests")
    dense_out = run_engine(cfg, params, prompts, "dense")
    cparams, report = compress_params(1, params, rank=args.rank,
                                      energy_keep=0.80)
    print(compression_report(report))
    rid_out = run_engine(cfg, materialize(cparams), prompts,
                         f"rid rank={args.rank}")
    agree = sum(dense_out[i] == rid_out[i] for i in dense_out) / len(
        dense_out)
    print(f"greedy outputs identical for {agree:.0%} of requests "
          f"(drift is expected where energy was truncated)")
    return {"dense": dense_out, "rid": rid_out, "report": report,
            "agree": agree}


if __name__ == "__main__":
    main(sys.argv[1:])
