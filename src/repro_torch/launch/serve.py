"""Serving driver: batched requests through the port's ServeEngine,
optionally with RID-compressed weights (counterpart of
``repro.launch.serve``; the same flags and defaults, plus ``--device`` and
``--layers``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --smoke --device cpu --requests 8 --new-tokens 16 [--rid-rank 32]

Without ``--device cpu`` it runs on the card and stops with an error if
there is none.  It serves every decoder-only architecture (xlstm-125m and
qwen2-vl-2b's text ids among them); for an encoder-decoder (whisper-tiny)
it exits with the engine's refusal: a request carries no encoder frames.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.rng import check_device
from repro_torch.models import init_params
from repro_torch.serving import GenerationRequest, ServeEngine
from repro_torch.serving.compress import compress_params, compression_report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--rid-rank", type=int, default=0,
                    help="compress weights with the paper's RID (0 = off)")
    ap.add_argument("--qr-impl", default="blocked",
                    choices=["cgs2", "blocked"],
                    help="pivoted-QR engine for the compression RSVD")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill long prompts in pieces of this many "
                         "tokens, interleaved with decode steps "
                         "(0 = one-shot prefill; attention-only archs)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the "
                         "config's; jamba-v0.1-52b fits one card at 8, one "
                         "pattern period)")
    args = ap.parse_args(argv)

    device = check_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    params = init_params(0, cfg, device=device)
    if args.rid_rank:
        params, report = compress_params(1, params, rank=args.rid_rank,
                                         qr_impl=args.qr_impl)
        print(compression_report(report))

    try:
        eng = ServeEngine(cfg, params, max_batch=args.max_batch,
                          max_len=args.max_len,
                          prefill_chunk_tokens=args.prefill_chunk or None)
    except ValueError as e:
        raise SystemExit(f"serve: {e}") from e
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        plen = int(rng.integers(4, 12))
        eng.submit(GenerationRequest(
            request_id=i,
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=args.new_tokens))
    done = eng.run()
    dt = time.time() - t0
    total_tokens = sum(len(r.output) for r in done)
    print(f"served {len(done)}/{args.requests} requests, "
          f"{total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens / dt:.1f} tok/s) on {device}")
    for r in done[:3]:
        print(f"  req {r.request_id}: prompt {len(r.prompt)} toks -> "
              f"{r.output[:8]}...")
    return done


if __name__ == "__main__":
    main()
