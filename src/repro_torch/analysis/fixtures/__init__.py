"""Known-bad entry points: the analyzer's positive controls (counterpart
of ``repro.analysis.fixtures``).

Each build function here violates exactly ONE rule, so tests (and the runner's
control pass) can assert the rule fires there and nowhere on the
production registry.  None of these are registered in the global
registry — they are constructed on demand via :data:`FIXTURES`.  The
panel loops and the gather run on the default process group (a one-rank
group is enough).

``badkernel/`` is a complete kernel package whose contract example
declares a shared-memory-hostile launch; ``kernels.check_package(
"badkernel", base=BADKERNEL_BASE)`` must flag it or the smem rule is
vacuous.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..registry import EntryPoint, OverlapSpec

__all__ = ["FIXTURES", "BAD_LINT_SRC", "BAD_SLEEP_SRC", "BAD_SERVER_SRC",
           "BADKERNEL_BASE"]

BADKERNEL_BASE = "repro_torch.analysis.fixtures"

_L, _N, _PANELS = 16, 64, 3


def _randn(shape, dtype, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return torch.randn(shape, dtype=dtype, device=device, generator=gen)


def _panel_loop(serialized: bool):
    """A miniature fused-panel loop on the default group.  With
    ``serialized=True`` each panel's norm all-reduce is issued from the
    freshly deflated shard (the hazard); otherwise it is issued from
    pre-deflation data and waited on after the deflation (the
    double-buffered schedule)."""
    def build(device):
        def fn(z):
            norms = (z * z).sum(0)
            work = dist.all_reduce(norms, async_op=True)       # prologue
            for _ in range(_PANELS):
                work.wait()
                q = z[:, :4]
                w = q.mT @ z
                if serialized:
                    z = z - q @ w              # deflate FIRST ...
                    norms = (z * z).sum(0)     # ... then reduce
                    work = dist.all_reduce(norms, async_op=True)
                else:
                    down = (w * w).sum(0)      # stage-A downdate only
                    norms = (z * z).sum(0) - down
                    work = dist.all_reduce(norms, async_op=True)
                    z = z - q @ w              # deflation overlaps it
            work.wait()
            return z, norms
        return fn, (_randn((_L, _N), torch.float32, device),)
    return build


_OVERLAP = OverlapSpec(norm_shape=(_N,), deflate="sub",
                       deflate_shape=(_L, _N), expect_overlap=True)


def _gather_blowup(device):
    def fn(z):
        parts = [torch.empty_like(z) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, z)             # the l x n blowup
        return torch.cat(parts, 1).sum()
    return fn, (_randn((_L, _N), torch.float32, device),)


def _f64_leak(device):
    def fn(x):
        return (x.double() @ x.double().mT).sum()
    return fn, (_randn((8, 8), torch.float32, device),)


def _complex_truncation(device):
    def fn(x):
        return x.to(torch.float32) + 1.0      # drops the imaginary part
    return fn, (_randn((8,), torch.complex64, device),)


def _host_transfer(device):
    def fn(x):
        total = x.sum().item()                # a scalar read: host sync
        return x.to("cpu") * total            # device-to-host on a card
    return fn, (_randn((8,), torch.float32, device),)


def _span_timer(device):
    """A span timer that syncs INSIDE the loop it times: each iteration
    reads the (sanctioned) obs clock around a scalar read that forces the
    device to finish — exactly the instrumentation mistake the port's
    ``obs.trace`` spans avoid (they bracket the call from host code).
    The host-transfer rule must flag it, or such timers could land in
    instrumented entry points unnoticed."""
    from ...obs.clock import now

    def fn(x):
        spans = []
        for _ in range(_PANELS):
            t0 = now()
            x = x * 2.0
            x.sum().item()                    # the sync that times the span
            spans.append(now() - t0)
        return x, spans
    return fn, (_randn((8,), torch.float32, device),)


FIXTURES = {
    "fixture.serialized-psum": EntryPoint(
        name="fixture.serialized-psum", build=_panel_loop(serialized=True),
        overlap=_OVERLAP, tags=("fixture", "distributed")),
    "fixture.overlapped-psum": EntryPoint(
        name="fixture.overlapped-psum", build=_panel_loop(serialized=False),
        overlap=_OVERLAP, tags=("fixture", "distributed")),
    "fixture.gather-blowup": EntryPoint(
        name="fixture.gather-blowup", build=_gather_blowup,
        max_collective_elems=_L * _N - 1, tags=("fixture", "distributed")),
    "fixture.f64-leak": EntryPoint(
        name="fixture.f64-leak", build=_f64_leak, tags=("fixture",)),
    "fixture.complex-truncation": EntryPoint(
        name="fixture.complex-truncation", build=_complex_truncation,
        tags=("fixture",)),
    "fixture.host-transfer": EntryPoint(
        name="fixture.host-transfer", build=_host_transfer,
        tags=("fixture",)),
    "fixture.span-timer": EntryPoint(
        name="fixture.span-timer", build=_span_timer, tags=("fixture",)),
}

# For the lint tests: a file that trips every message rule exactly once.
BAD_LINT_SRC = '''\
import time
import numpy as np
import torch


def bad(kind, panel):
    if panel < 1:
        raise ValueError("bad panel")            # no value interpolated
    if kind == "a":
        out = 1
    elif kind == "b":
        out = 2
    elif kind == "c":
        out = 3
    else:
        raise ValueError(f"need l >= k, got l={panel} < k={panel}")
    torch.set_default_dtype(torch.float64)
    t0 = time.time()
    noise = np.random.standard_normal(4)
    return out, t0, noise
'''

# For the time-sleep rule's control pair: a library module that blocks
# the host thread directly instead of waiting through an injected
# Clock.sleep.  Linted as ``serving/bad_sleep.py`` the rule must fire;
# linted as ``obs/clock.py`` (the sanctioned implementation site) it
# must stay silent.
BAD_SLEEP_SRC = '''\
import time


def wait_for_chunk(delay):
    time.sleep(delay)
    return delay
'''

# For the socket-server rule's control pair: a library module that opens
# its own HTTP listener instead of going through the sanctioned
# telemetry endpoint.  Linted as ``serving/bad_server.py`` the rule must
# fire (once per banned import); linted as ``obs/telemetry.py`` (the one
# sanctioned server module) it must stay silent.
BAD_SERVER_SRC = '''\
import socket
from http.server import HTTPServer, BaseHTTPRequestHandler


def open_listener(port):
    srv = HTTPServer(("127.0.0.1", port), BaseHTTPRequestHandler)
    host = socket.gethostname()
    return srv, host
'''
