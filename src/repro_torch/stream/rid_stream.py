"""Streamed randomized ID (counterpart of ``repro.stream.rid_stream``):
decompose a matrix that is only ever seen one row chunk at a time.

``rid`` needs all of ``A`` on the device; ``rid_streamed`` takes a
:class:`~repro_torch.stream.chunks.ChunkSource` and keeps
``O(l n + chunk_rows n)`` on the device, whatever ``m``.  The gaussian
sketch ``Y = Omega A`` is a one-pass row reduction: each chunk goes
through the ``sketch_accum`` kernel onto a running ``l x n``
accumulator, then the finished sketch takes the in-memory path's QR and
interpolation (``core.rid._qr_interp``).

Memory and transfers by phase (``C = ceil(m / chunk_rows)`` chunks):

  phase             device bytes                     host -> device
  sketch (pass 1)   l n (accumulator)                m n (each chunk once)
                    + 2 chunk_rows n (two buffers)
                    + l chunk_rows (operator columns)
  pivoted QR        l n + the engine's panel state   0
  interp solve      k n                              0
  gather (pass 2)   one chunk's k columns            0 (host chunks are
                                                     gathered on the host;
                                                     a device chunk sends
                                                     its m x k back)

Pass 1's schedule (``overlap=True``): a host chunk is copied into one of
two pinned buffers on the host, then sent with ``non_blocking=True`` on a
copy stream into one of two device buffers, while ``sketch_accum`` runs
the previous chunk on the compute stream.  Events order the streams:
the compute stream waits for a buffer's copy before it reads it, the
copy stream waits for the compute stream to finish with a device buffer
before it overwrites it, and the host waits for a pinned buffer's copy
before it refills it.  The device buffers are marked as used on the copy
stream (``record_stream``), so the caching allocator never hands them
out while a copy is in flight.  ``overlap=False`` runs every copy and
accumulation on the compute stream and waits for each chunk (the
baseline of ``bench_overlap``).  A chunk already on the device (a
``SpectrumSource``'s) is used where it is, without a copy.

Replay: ``rid_streamed`` gives the bits of the in-memory
``rid(seed, A, k, sketch_kind="gaussian")`` on the same device, in all
five fields, for every ``chunk_rows`` that is a multiple of
``ACCUM_BLOCK``: the operator is seeded per ``ACCUM_BLOCK``-row block
(``core.sketch.gaussian_omega_cols``), ``sketch_accum`` reduces in those
fixed blocks in order from any accumulator it is given, the accumulator
keeps its canonical dtype (``accum_dtype_for``) across chunks and
checkpoints, the QR and solve are the same function, and the gather
copies values untouched.  Only the gaussian sketch streams: srft and srht
mix all ``m`` rows.

Observability (``repro_torch.obs``): under an ambient tracer one
``rid_streamed`` root span with per-chunk children ``stream.h2d`` /
``stream.accumulate`` (pass 1) and ``stream.gather`` (pass 2), the
counters ``stream.chunks``, ``stream.h2d_bytes`` (bytes sent to the
device) and ``stream.checkpoints``, the ``device.live_bytes`` gauge
(``obs.metrics.live_device_bytes``) at every chunk, and an
``eq3.certificate`` event with the paper's eq. (3) bound for the job.
Every span carries ``job=``, the first 12 hex digits of the resume
fingerprint.  The chunk spans time dispatch; deep tracing
(``tracing(deep=True)``) synchronizes each for device time, which
serializes the pipeline.

Faults (``repro_torch.runtime.faults``): ``retry=RetryPolicy(...)`` retries
transient read errors and timeouts with backoff; an exhausted budget
raises ``ChunkReadFailed``, a dead source ``SourceDied``; a killed
process (``ProcessKilled``) leaves its checkpoints.

Checkpoint and resume: with ``resume_dir``, the pipeline saves
``(fp, phase, chunks_done, acc)`` every ``checkpoint_every`` chunks of
pass 1, ``(fp, phase, chunks_done, P, J, Q, R, B)`` after the QR and
every ``checkpoint_every`` chunks of pass 2 (``checkpoint.store``).
Resuming replays the remaining blocks onto the saved accumulator bits,
so a killed and resumed run is bit-equal to an uninterrupted one.  The
fingerprint covers ``(m, n, k, l, chunk_rows, dtype, seed, the injected
operator's bytes, the QR arguments, the source's fingerprint())``; a
checkpoint of another job is refused, naming both fingerprints.
"""
from __future__ import annotations

import hashlib
import json
import os
import types
from typing import Optional

import numpy as np
import torch

from ..checkpoint.store import CheckpointManager, latest_step, restore_pytree
from ..core.errors import error_bound
from ..core.qr import resolve_norm_recompute, resolve_panel
from ..core.rid import _cast_interp, _qr_interp
from ..core.rng import check_device, seed_of
from ..core.sketch import finalize_gaussian_sketch, gaussian_omega_cols
from ..core.types import IDResult
from ..core.validate import check_l_ge_k, check_panel, check_rank_bounds
from ..kernels.sketch_accum import ACCUM_BLOCK, sketch_accum
from ..obs import trace as obs_trace
from ..obs.metrics import live_device_bytes
from .chunks import ChunkSource, chunk_bounds, num_chunks

__all__ = ["rid_streamed", "source_fingerprint"]


def _checked_chunk(source: ChunkSource, c: int) -> torch.Tensor:
    """Chunk ``c``, its shape and dtype checked (a source that lies about
    its geometry fails here, with the chunk named)."""
    r0, r1 = chunk_bounds(source, c)
    ch = torch.as_tensor(source.chunk(c))
    n = source.shape[1]
    if tuple(ch.shape) != (r1 - r0, n):
        raise ValueError(f"source.chunk({c}) returned shape "
                         f"{tuple(ch.shape)}, expected ({r1 - r0}, {n}) "
                         f"for rows [{r0}, {r1}) of {tuple(source.shape)}")
    if ch.dtype != source.dtype:
        raise ValueError(f"source.chunk({c}) dtype {ch.dtype} disagrees "
                         f"with source.dtype {source.dtype}")
    return ch


def source_fingerprint(seed: int, source: ChunkSource, k: int, l: int,
                       qr_impl: str, qr_panel, qr_norm_recompute,
                       omega: Optional[torch.Tensor] = None) -> np.ndarray:
    """The resume identity: a sha256 digest (a (32,) uint8 array, the
    checkpointable form) of everything that fixes the output bits:
    geometry, dtype, chunking, the seed (or the injected operator's
    bytes), the QR arguments and the source's own ``fingerprint()``."""
    m, n = source.shape
    extra = getattr(source, "fingerprint", None)
    extra = extra() if callable(extra) else extra
    op = (None if omega is None else hashlib.sha256(
        omega.detach().cpu().contiguous().numpy().tobytes()).hexdigest())
    text = (f"m={m} n={n} k={k} l={l} chunk_rows={source.chunk_rows} "
            f"dtype={str(source.dtype).removeprefix('torch.')} "
            f"seed={seed} omega={op} "
            f"qr={qr_impl}/{qr_panel}/{qr_norm_recompute} src={extra!r}")
    digest = hashlib.sha256(text.encode()).digest()
    return np.frombuffer(digest, np.uint8).copy()


def _resume_like(resume_dir: str, step: int) -> dict:
    """The ``restore_pytree`` structure of ``step``, from its manifest
    (shapes only: the fingerprint check authenticates the state)."""
    path = os.path.join(resume_dir, f"step_{step:06d}", "manifest.json")
    with open(path) as f:
        leaves = json.load(f)["leaves"]
    names = ["fp", "phase", "chunks_done"]
    names += ["P", "J", "Q", "R", "B"] if "['B']" in leaves else ["acc"]
    return {name: types.SimpleNamespace(shape=tuple(leaves[f"['{name}']"]
                                                    ["shape"]))
            for name in names}


def _load_resume_state(resume_dir: str, fp: np.ndarray) -> Optional[dict]:
    """The latest checkpoint in ``resume_dir`` as host numpy state, or None
    for a fresh directory; refuses another job's checkpoint."""
    step = latest_step(resume_dir)
    if step is None:
        return None
    state = restore_pytree(resume_dir, step, _resume_like(resume_dir, step),
                           host=True)
    if not np.array_equal(state["fp"], fp):
        raise ValueError(
            f"checkpoint at {resume_dir} (step {step}) was written by a "
            f"different job: its fingerprint "
            f"{bytes(state['fp']).hex()[:16]}... != this job's "
            f"{bytes(fp).hex()[:16]}...; the same source, seed, k, l, "
            f"chunking and qr arguments are required for a bit-identical "
            f"resume")
    return state


class _Feed:
    """Pass 1's host -> device feed (module docstring): two pinned host
    buffers, two device buffers, a copy stream (the compute stream itself
    without ``overlap``) and the events that order them.  Sends nothing
    for a chunk already on the device, or when the device is the CPU."""

    def __init__(self, dev: torch.device, overlap: bool):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.stream = (torch.cuda.Stream(dev) if self.cuda and overlap
                       else None)
        self.pinned = [None, None]
        self.dbuf = [None, None]
        self.sent = [None, None]     # copy of slot s done (copy stream)
        self.used = [None, None]     # compute stream done with dbuf[s]

    def put(self, chunk: torch.Tensor, slot: int) -> tuple:
        """``(chunk on the device, bytes sent)``; the compute stream waits
        for the copy before anything it enqueues next."""
        if chunk.device.type != "cpu" or not self.cuda:
            return chunk.to(self.dev), 0
        rows = chunk.shape[0]
        if self.pinned[slot] is None or self.pinned[slot].shape[0] < rows:
            shape = (rows,) + tuple(chunk.shape[1:])
            self.pinned[slot] = torch.empty(shape, dtype=chunk.dtype,
                                            pin_memory=True)
            self.dbuf[slot] = torch.empty(shape, dtype=chunk.dtype,
                                          device=self.dev)
            if self.stream is not None:
                self.dbuf[slot].record_stream(self.stream)
        if self.sent[slot] is not None:
            self.sent[slot].synchronize()    # its last copy has left
        host, dst = self.pinned[slot][:rows], self.dbuf[slot][:rows]
        host.copy_(chunk)
        compute = torch.cuda.current_stream(self.dev)
        stream = self.stream or compute
        with torch.cuda.stream(stream):
            if self.used[slot] is not None:
                stream.wait_event(self.used[slot])
            dst.copy_(host, non_blocking=True)
            self.sent[slot] = torch.cuda.Event()
            self.sent[slot].record(stream)
        compute.wait_event(self.sent[slot])
        return dst, host.numel() * host.element_size()

    def done_with(self, slot: int) -> None:
        """The compute stream has enqueued its last read of ``slot``."""
        if self.cuda and self.dbuf[slot] is not None:
            self.used[slot] = torch.cuda.Event()
            self.used[slot].record(torch.cuda.current_stream(self.dev))

    def close(self) -> None:
        """Wait for the copies in flight, so the buffers may be freed."""
        for ev in self.sent:
            if ev is not None:
                ev.synchronize()


def rid_streamed(gen_or_seed, source: ChunkSource, k: int, *,
                 l: Optional[int] = None, sketch_kind: str = "gaussian",
                 qr_impl: str = "auto", qr_panel=32,
                 qr_norm_recompute="auto", overlap: bool = True,
                 retry=None, resume_dir: Optional[str] = None,
                 checkpoint_every: int = 1, progress=None, device="cuda",
                 omega: Optional[torch.Tensor] = None) -> IDResult:
    """Rank-``k`` randomized ID of a chunk-fed matrix: ``A ~= B @ P``.

    Bit-equal to ``rid(gen_or_seed, A, k, sketch_kind="gaussian", ...)``
    on the whole matrix on ``device``, for every ``chunk_rows`` that is a
    multiple of ``ACCUM_BLOCK`` (module docstring), and so is a run
    resumed from ``resume_dir``.

    Args:
      gen_or_seed: an int seed or a generator (one seed is drawn from it),
        as ``rid``'s.
      source: a ``ChunkSource`` of ``A``, read twice (the sketch pass and
        the pivot-column gather).
      k: target rank.  l: sketch rows (default ``2 k``).
      sketch_kind: must be ``'gaussian'``, the one operator that applies
        row chunk by row chunk.
      qr_impl / qr_panel / qr_norm_recompute: as ``rid``'s; ``'auto'``
        resolves to ``'blocked'`` (the sharded ``'panel_parallel'`` needs
        a process group, which this entry does not take yet).
      overlap: pipeline the host -> device copies with the accumulation
        (default); ``False`` serializes them.
      retry: a ``RetryPolicy`` every chunk read goes through (``None``:
        the first error is raised).
      resume_dir: a checkpoint directory: a fresh one turns checkpoints
        on, one holding this job's checkpoint resumes from it (either
        pass), another job's is refused.
      checkpoint_every: checkpoint cadence in chunks (default 1).
      progress: a ``ProgressReporter``: ``2 C`` units (the chunks of both
        passes), the phases ``pass1`` / ``qr_interp`` / ``pass2``,
        checkpoints, retries, and ``done`` / ``failed``.
      device: where the accumulation and QR run (default ``"cuda"``,
        which raises without a card; ``"cpu"`` runs the plain versions).
      omega: the unscaled gaussian operator (``l x m``) injected instead
        of drawn (the parity tests give it the reference's).

    Returns an ``IDResult`` whose ``B`` (``m x k``) is a host tensor, so
    the device holds nothing that grows with ``m``; ``P``, ``J``, ``Q``
    and ``R`` are on ``device``.
    """
    if not isinstance(source, ChunkSource):
        raise ValueError(f"source must implement the ChunkSource protocol "
                         f"(shape/dtype/chunk_rows/chunk), got "
                         f"{type(source).__name__}")
    dev = check_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    m, n = source.shape
    chunk_rows = source.chunk_rows
    dtype = source.dtype
    if sketch_kind != "gaussian":
        raise ValueError(f"sketch kind {sketch_kind!r} cannot stream row "
                         f"chunks (srft/srht mix all m rows through the "
                         f"FFT/FWHT); pick 'gaussian'")
    if chunk_rows < 1:
        raise ValueError(f"need chunk_rows >= 1, got chunk_rows={chunk_rows}")
    if chunk_rows < m and chunk_rows % ACCUM_BLOCK:
        raise ValueError(
            f"need chunk_rows a multiple of ACCUM_BLOCK={ACCUM_BLOCK} (the "
            f"canonical reduction block that keeps the streamed sketch "
            f"bit-for-bit identical to the in-memory one), got "
            f"chunk_rows={chunk_rows}")
    l = 2 * k if l is None else l
    check_l_ge_k(l, k)
    check_rank_bounds(k, l, n)
    if checkpoint_every < 1:
        raise ValueError(f"need checkpoint_every >= 1, got "
                         f"checkpoint_every={checkpoint_every}")
    if qr_impl == "auto":
        qr_impl = "blocked"
    if qr_impl == "panel_parallel":
        raise ValueError(f"qr_impl={qr_impl!r} factors column shards in "
                         f"place over a process group, which rid_streamed "
                         f"does not take yet; use 'blocked' or 'cgs2'")
    if qr_impl == "blocked":
        check_panel(resolve_panel(qr_panel, k, l), name="qr_panel")
        resolve_norm_recompute(qr_norm_recompute)
    if omega is not None and tuple(omega.shape) != (l, m):
        raise ValueError(f"omega {tuple(omega.shape)} must be (l, m) = "
                         f"{(l, m)}")
    seed = seed_of(gen_or_seed)

    def read_chunk(c):
        if retry is None:
            return _checked_chunk(source, c)
        return retry.call(lambda: _checked_chunk(source, c),
                          description=f"source.chunk({c})",
                          on_retry=None if progress is None
                          else progress.on_retry)

    def omega_cols(r0, r1):
        if omega is None:
            return gaussian_omega_cols(seed, r0, r1, l, dtype, dev)
        return omega[:, r0:r1].to(dev)

    C = num_chunks(source)
    fp = source_fingerprint(seed, source, k, l, qr_impl, qr_panel,
                            qr_norm_recompute, omega)
    job = bytes(fp).hex()[:12]
    mgr = None
    phase, start1, start2 = 1, 0, 0
    acc = interp = B = None
    if resume_dir is not None:
        mgr = CheckpointManager(resume_dir)
        state = _load_resume_state(resume_dir, fp)
        if state is not None:
            phase = int(state["phase"])
            done = int(state["chunks_done"])
            if phase == 1:
                start1, acc = done, torch.from_numpy(state["acc"]).to(dev)
            else:
                interp = tuple(torch.from_numpy(state[name]).to(dev)
                               for name in ("P", "J", "Q", "R"))
                B, start2 = torch.from_numpy(state["B"]), done

    tracer = obs_trace.current_tracer()
    deep = obs_trace.deep_tracing()
    chunks_ctr = obs_trace.counter("stream.chunks")
    h2d_ctr = obs_trace.counter("stream.h2d_bytes")
    ckpt_ctr = obs_trace.counter("stream.checkpoints")
    live_gauge = obs_trace.gauge("device.live_bytes")

    def save(step, tree):
        # The manager copies the tree to the host now and writes the files
        # on its own thread, beside the next chunks.
        with obs_trace.span("stream.checkpoint", step=step):
            mgr.save(step, tree)
        ckpt_ctr.add(1)
        if progress is not None:
            progress.checkpoint_saved(step)

    if progress is not None:
        if not progress.job:
            progress.job = job
        progress.update(total=2 * C,
                        phase="pass1" if phase == 1 else "pass2",
                        done=start1 if phase == 1 else C + start2,
                        force=True)

    feed = _Feed(dev, overlap)
    with obs_trace.attributes(job=job), \
            obs_trace.span("rid_streamed", m=m, n=n, k=k, l=l,
                           chunk_rows=chunk_rows, overlap=overlap,
                           dtype=str(dtype).removeprefix("torch."),
                           device=str(dev)):
        if resume_dir is not None and (start1 or phase == 2):
            obs_trace.event("stream.resume", phase=phase,
                            chunks_done=start1 if phase == 1 else start2)
        try:
            # ---- pass 1: the sketch, chunk by chunk --------------------
            if phase == 1:
                with obs_trace.span("stream.pass1", chunks=C,
                                    start=start1) as p1:

                    def send(c):
                        with obs_trace.span("stream.h2d", chunk=c,
                                            sync=deep) as sp:
                            d, sent = feed.put(read_chunk(c), c % 2)
                            h2d_ctr.add(sent)
                            if deep:
                                sp.block_on(d)
                        return d

                    nxt = send(start1) if start1 < C else None
                    for c in range(start1, C):
                        cur = nxt
                        if tracer is not None:
                            live_gauge.set(live_device_bytes())
                        r0, r1 = chunk_bounds(source, c)
                        with obs_trace.span("stream.accumulate", chunk=c,
                                            rows=r1 - r0,
                                            sync=deep or not overlap) as sp:
                            acc = sketch_accum(omega_cols(r0, r1), cur, acc)
                            feed.done_with(c % 2)
                            if not overlap and feed.cuda:
                                torch.cuda.current_stream(dev).synchronize()
                            elif deep:
                                sp.block_on(acc)
                        del cur
                        if c + 1 < C:     # sent while the kernel runs
                            nxt = send(c + 1)
                        chunks_ctr.add(1)
                        if progress is not None:
                            progress.update(done=c + 1)
                        if mgr is not None and \
                                ((c + 1) % checkpoint_every == 0
                                 or c + 1 == C):
                            save(c + 1, {"fp": fp, "phase": np.int64(1),
                                         "chunks_done": np.int64(c + 1),
                                         "acc": acc})
                    feed.close()
                    Y = finalize_gaussian_sketch(acc, l, dtype)
                    p1.block_on(Y)
                    del acc

            # ---- steps 2-3: the in-memory path's QR and solve ----------
            if interp is None:
                if progress is not None:
                    progress.update(phase="qr_interp")
                with obs_trace.span("stream.qr_interp", qr_impl=qr_impl,
                                    qr_panel=qr_panel) as sp:
                    P, piv, Q, R = _qr_interp(Y, k, qr_impl, qr_panel,
                                              qr_norm_recompute)
                    P = _cast_interp(P, dtype)
                    sp.block_on((P, piv, Q, R))
                del Y
            else:
                P, piv, Q, R = interp

            # ---- pass 2: the pivot columns B = A[:, J] on the host -----
            J_host = piv.cpu()
            if B is None:
                B = torch.empty((m, k), dtype=dtype)

            def phase2_tree(done):
                # B is shared with the writer thread: the gather only
                # writes rows past `done`, the snapshot's meaningful rows.
                return {"fp": fp, "phase": np.int64(2),
                        "chunks_done": np.int64(done), "P": P, "J": J_host,
                        "Q": Q, "R": R, "B": B}

            if mgr is not None and phase == 1:
                save(C + 1, phase2_tree(0))   # a pass-2 resume redoes
            if progress is not None:          # neither pass 1 nor the QR
                progress.update(phase="pass2")
            with obs_trace.span("stream.pass2", chunks=C, start=start2):
                for c in range(start2, C):
                    r0, r1 = chunk_bounds(source, c)
                    with obs_trace.span("stream.gather", chunk=c,
                                        rows=r1 - r0, sync=deep):
                        ch = read_chunk(c)
                        cols = ch.index_select(
                            1, J_host if ch.device.type == "cpu" else
                            piv.to(ch.device))
                        B[r0:r1] = cols.cpu()
                    if progress is not None:
                        progress.update(done=C + c + 1)
                    if mgr is not None and \
                            ((c + 1) % checkpoint_every == 0 or c + 1 == C):
                        save(C + 1 + c + 1, phase2_tree(c + 1))
        except BaseException:
            if progress is not None:
                progress.on_failure()
                progress.finish("failed")
            if mgr is not None:       # a failed background write must not
                try:                  # hide the pipeline's own failure
                    mgr.wait()
                except Exception:
                    pass
            raise
        if mgr is not None:
            mgr.wait()                # the last checkpoint durable on return

        # The trace doubles as a correctness record: the paper's eq. (3)
        # bound for this job, as an event.
        if tracer is not None:
            cert = {"m": m, "n": n, "k": k, "l": l,
                    "bound_constant": error_bound(m, n, k)}
            sigmas = getattr(source, "sigmas", None)
            if sigmas is not None:
                cert["sigma_kp1"] = float(sigmas[k])
                cert["bound"] = cert["bound_constant"] * cert["sigma_kp1"]
            obs_trace.event("eq3.certificate", **cert)
    if progress is not None:
        progress.finish("done")
    return IDResult(B=B, P=P, J=piv, Q=Q, R=R)


# ----------------------------------------------------- analysis registry
# One pass-1 accumulation fused with the shared QR and solve: the device
# program of the streamed path at the reference's registration shapes (the
# host chunk loop is not a device program; its residency is metered by
# obs.metrics.live_device_bytes and bench_stream).

def _analysis_build_stream_step(device):
    l, n, k, rows = 48, 400, 21, 2 * ACCUM_BLOCK
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    f32 = torch.float32
    x = torch.randn((l, rows), generator=gen, dtype=f32, device=device)
    a = torch.randn((rows, n), generator=gen, dtype=f32, device=device)
    acc = torch.randn((l, n), generator=gen, dtype=f32, device=device)

    def step(x, a, acc):
        Y = finalize_gaussian_sketch(sketch_accum(x, a, acc), l, f32)
        return _qr_interp(Y, k, "blocked", 7, "auto")
    return step, (x, a, acc)


def _register_analysis_entries():
    from ..analysis.registry import register
    # k = 21 at panel width 7 is three panels, one scalar read each.
    register("rid_streamed.step", _analysis_build_stream_step,
             max_host_syncs=3)


_register_analysis_entries()
