"""Chrome trace-event files of the port's two instrumented paths: one
streamed decomposition and one ``ServeEngine`` run (counterpart of the JAX
harness's ``bench_trace``).

    python -m repro_torch.benchmarks.bench_trace [--out DIR] [--deep]
        [--device cuda|cpu]

Writes ``stream_trace.json`` (one ``stream.h2d`` / ``stream.accumulate``
span a chunk of pass 1, the ``stream.gather`` spans, the QR's spans, the
counters and the ``eq3.certificate`` instant; f32, ``m, n, k, chunk_rows
= 4096, 256, 24, 512`` from an ``ArraySource``) and ``serve_trace.json``
(admit, prefill-chunk and decode spans, queue-depth and slot counter
tracks; granite-3-2b's SMOKE config in f32, three requests) into
``--out`` (default ``experiments/traces`` at the repository's root), to
be opened in Perfetto (https://ui.perfetto.dev).  ``--deep`` turns on
deep tracing: each span waits for the device, which serializes the
stream's pipeline.

Both files are checked before exit: the stream trace holds one
``stream.h2d`` and one ``stream.accumulate`` span a chunk, the serve run
finishes its requests with decode spans, and each file parses as
trace-event JSON with complete events.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

from ..core.rng import check_device
from ..obs import tracing

__all__ = ["export_stream_trace", "export_serve_trace", "validate", "main"]

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "experiments" / "traces"


def export_stream_trace(path, *, deep: bool = False, device="cuda") -> int:
    """Trace one warm streamed ID into ``path``; returns its span count."""
    from ..stream import ArraySource, rid_streamed
    dev = check_device(device)
    m, n, k, chunk = 4096, 256, 24, 512
    A = torch.from_numpy(np.asarray(
        np.random.default_rng(11).standard_normal((m, n)), np.float32))
    src = ArraySource(A, chunk)
    rid_streamed(3, src, k, device=dev)                 # warm-up
    with tracing(chrome=path, deep=deep) as tr:
        rid_streamed(3, src, k, device=dev)
    chunks = m // chunk
    h2d = sum(s.name == "stream.h2d" for s in tr.spans)
    acc = sum(s.name == "stream.accumulate" for s in tr.spans)
    if h2d != chunks or acc != chunks:
        raise AssertionError(f"stream trace shape off: {h2d} h2d / {acc} "
                             f"accumulate spans for {chunks} chunks")
    return len(tr.spans)


def export_serve_trace(path, *, deep: bool = False, device="cuda") -> int:
    """Trace one ``ServeEngine.run()`` of three requests into ``path``;
    returns its span count."""
    from ..configs import get_smoke_config
    from ..models import init_params
    from ..serving import GenerationRequest, ServeEngine
    dev = check_device(device)
    cfg = get_smoke_config("granite-3-2b").replace(dtype="float32")
    params = init_params(0, cfg, device=dev)
    eng = ServeEngine(cfg, params, max_batch=2, max_len=64,
                      prefill_chunk_tokens=8)
    for i in range(3):
        prompt = (np.arange(4 + 13 * i) % cfg.vocab_size).astype(np.int32)
        eng.submit(GenerationRequest(request_id=i, prompt=prompt,
                                     max_new_tokens=4))
    with tracing(chrome=path, deep=deep) as tr:
        done = eng.run()
    if len(done) != 3:
        raise AssertionError(f"serve trace run incomplete: {len(done)}/3")
    if not any(s.name == "serve.decode" for s in tr.spans):
        raise AssertionError("serve trace has no decode spans")
    return len(tr.spans)


def validate(path) -> None:
    """``path`` parses as trace-event JSON with complete events and only
    the event kinds the Chrome exporter writes."""
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    if not any(e["ph"] == "X" for e in ev):
        raise AssertionError(f"{path}: no complete events")
    for e in ev:
        if e["ph"] not in ("M", "X", "i", "C"):
            raise AssertionError(f"{path}: bad ph {e!r}")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description="Chrome traces of a streamed "
                                 "ID and a ServeEngine run")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--deep", action="store_true",
                    help="deep tracing: every span waits for the device "
                         "(serializes the stream's pipeline)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    written = []
    for name, fn in (("stream_trace.json", export_stream_trace),
                     ("serve_trace.json", export_serve_trace)):
        path = os.path.join(args.out, name)
        nspans = fn(path, deep=args.deep, device=args.device)
        validate(path)
        print(f"wrote {path} ({nspans} spans)")
        written.append((path, nspans))
    return written


if __name__ == "__main__":
    main()
