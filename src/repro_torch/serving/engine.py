"""Batched serving engine (counterpart of ``repro.serving.engine``):
continuous-batching prefill/decode loop.

Design (vLLM-shaped, sized for the assignment's decode cells):
  * fixed decode batch of ``max_batch`` slots, each slot = one sequence;
  * arriving requests are prefilled (right-aligned into the slot's cache)
    and then join the shared decode step;
  * every decode step advances ALL active slots by one token (the
    ``decode_32k``/``long_500k`` cells lower exactly this step function);
  * finished slots (EOS or max_new_tokens) free immediately — continuous
    batching, no head-of-line blocking;
  * with ``prefill_chunk_tokens`` set, a LONG prompt is prefilled in
    fixed-size pieces (``models.transformer.prefill_chunk`` — each piece
    attends to the cached prefix, no recompute) with one decode step for
    the rest of the batch between pieces, so a 10k-token arrival no
    longer stalls every active slot for its whole prefill.

It serves every decoder-only architecture: attention, Mamba and xLSTM
stacks (a slot's state, whatever its kind, is copied in whole at
install) and qwen2-vl's text ids.  An encoder-decoder (whisper) is
refused when the engine is built: a request carries no encoder frames
(the reference's engine fails at its first prefill instead).

The engine is deliberately synchronous and on one card.  ``jax.jit``
has no counterpart here: the step functions run eagerly, under
``torch.inference_mode``; prompts longer than 2048 tokens prefill through
the flash kernel (``models.attention``).  The shared cache is written in
place (one slot at install, one position per decode step) where the
reference builds an updated copy.

GRACEFUL DEGRADATION — a multi-tenant engine must not let one tenant
take the loop down, and must never lose track of a request:

  * every request carries a TERMINAL STATUS (``done`` / ``failed`` /
    ``evicted`` / ``timeout``) — ``run()`` accounts for every submitted
    request on exit (a ``max_steps`` stop evicts the leftovers
    explicitly instead of silently dropping them);
  * per-request QUARANTINE: an exception while admitting or prefilling
    one request (e.g. a poisoned prompt — out-of-vocab ids, wrong
    shape/dtype, longer than the cache) marks THAT request ``failed``
    (with the error), frees its slot, and the engine lives
    (``serve.quarantined`` counter + ``serve.quarantine`` event);
  * DEADLINES: ``GenerationRequest.deadline_s`` is a per-request wall
    budget from submit, checked once per loop iteration against the
    engine's injected obs clock (``FakeClock`` makes timeout tests
    instant); overdue requests terminate as ``timeout`` wherever they
    are (queued, prefilling, or decoding).  ``cancel(request_id)``
    is the caller-driven version and terminates as ``evicted``;
  * bounded-queue ADMISSION CONTROL: with ``max_queue`` set, ``submit``
    SHEDS (returns False, request ``evicted``, ``serve.shed`` counter)
    instead of queueing unboundedly — shed-rather-than-stall, the
    back-pressure contract a load balancer can act on.

OBSERVABILITY (``repro_torch.obs``): under an active tracer, ``run()`` opens a
``serve.run`` root span and each loop iteration records a
``serve.admit`` span (one ``serve.prefill`` child per one-shot
admission), one ``serve.prefill_chunk`` span per in-flight chunked
prefill advanced, and one ``serve.decode`` span per shared decode step
(the decode span's close is an honest device time — the step's argmax
already syncs on the logits).  Two gauges sample once per iteration:
``serve.queue_depth`` (waiting requests) and ``serve.slot_occupancy``
(active + prefilling slots, of ``max_batch``).  Degradation events ride
the same trace: ``serve.quarantined`` / ``serve.shed`` /
``serve.timeout`` / ``serve.evicted`` counters with matching events.
All spans open and close in HOST code around the step calls, and with no
tracer every hook is a shared no-op.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import (decode_step, init_caches, prefill,
                                  prefill_chunk, supports_chunked_prefill)
from ..obs import trace as obs_trace
from ..obs.clock import MONOTONIC, Clock

# The four ways a request can leave the engine.  `run()` guarantees
# every submitted request ends in exactly one of them.
TERMINAL_STATES = ("done", "failed", "evicted", "timeout")


@dataclasses.dataclass
class GenerationRequest:
    request_id: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 32
    eos_token: Optional[int] = None
    deadline_s: Optional[float] = None  # wall budget from submit, or None
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    status: str = "queued"             # "queued"/"running" -> TERMINAL_STATES
    error: Optional[str] = None        # why, for failed/evicted/timeout

    @property
    def done(self) -> bool:
        """Completed successfully (the historical flag, now derived)."""
        return self.status == "done"


class ServeEngine:
    """Greedy decoding over a shared cache; one model, many requests."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_len: int = 512,
                 prefill_chunk_tokens: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 clock: Clock = MONOTONIC, progress=None, device=None):
        """``params``: a ``models.Transformer`` (or None for an engine that
        only queues, sheds and expires); the engine runs on its device.
        ``device`` places the caches of a model-less engine (default
        ``"cuda"``).  An encoder-decoder config raises ``ValueError``."""
        if cfg.encdec:
            raise ValueError(
                f"arch {cfg.name!r} is an encoder-decoder: a "
                f"GenerationRequest carries no encoder frames, so the engine "
                f"cannot prefill it (serve it through models.prefill(..., "
                f"frames=) and models.decode_step)")
        if prefill_chunk_tokens is not None:
            if prefill_chunk_tokens < 1:
                raise ValueError(f"need prefill_chunk_tokens >= 1, got "
                                 f"prefill_chunk_tokens="
                                 f"{prefill_chunk_tokens}")
            if not supports_chunked_prefill(cfg):
                raise ValueError(
                    f"chunked prefill unsupported for arch {cfg.name!r} "
                    f"(needs an attention-only stack, no encdec/mrope/"
                    f"sliding window); got prefill_chunk_tokens="
                    f"{prefill_chunk_tokens}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"need max_queue >= 1 (or None for unbounded), "
                             f"got max_queue={max_queue}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.max_queue = max_queue
        self._clock = clock
        # Optional ProgressReporter (obs/progress.py): one unit per
        # request reaching a terminal status, queue/slot occupancy in
        # ``extra`` — the live view of a drain.
        self.progress = progress
        self._queue: list[GenerationRequest] = []
        self._all: list[GenerationRequest] = []
        self._active: dict[int, GenerationRequest] = {}   # slot -> request
        # slot -> in-flight chunked prefill: {"req", "consumed", "caches"}
        self._prefilling: dict[int, dict] = {}
        self._deadline: dict[int, float] = {}   # request_id -> absolute t
        if params is not None:
            device = next(params.parameters()).device
        self.device = torch.device("cuda" if device is None else device)
        self._pos = np.zeros(max_batch, dtype=np.int32)
        with torch.inference_mode():
            self._caches = init_caches(cfg, max_batch, max_len, self.device)
        self._last_tok = np.zeros((max_batch, 1), dtype=np.int32)


    # ------------------------------------------------------------- intake
    def submit(self, req: GenerationRequest) -> bool:
        """Enqueue ``req``; returns whether it was ADMITTED to the queue.

        With ``max_queue`` set and the queue full, the request is shed
        immediately (status ``evicted``, ``False`` returned) — explicit
        back-pressure instead of an unbounded queue stalling everyone.
        Either way the request is tracked in the engine's ledger."""
        self._all.append(req)
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self._finish(req, "evicted",
                         f"shed at submit: queue full "
                         f"(max_queue={self.max_queue})", "serve.shed")
            return False
        if req.deadline_s is not None:
            self._deadline[req.request_id] = self._clock() + req.deadline_s
        self._queue.append(req)
        return True

    def cancel(self, request_id: int) -> bool:
        """Terminate a queued/prefilling/active request as ``evicted``
        (its slot frees immediately); returns whether it was found."""
        for req in self._queue:
            if req.request_id == request_id:
                self._queue.remove(req)
                self._finish(req, "evicted", "cancelled by caller",
                             "serve.evicted")
                return True
        for slot, st in list(self._prefilling.items()):
            if st["req"].request_id == request_id:
                del self._prefilling[slot]
                self._finish(st["req"], "evicted", "cancelled by caller",
                             "serve.evicted")
                return True
        for slot, req in list(self._active.items()):
            if req.request_id == request_id:
                del self._active[slot]
                self._finish(req, "evicted", "cancelled by caller",
                             "serve.evicted")
                return True
        return False

    # --------------------------------------------------------- bookkeeping
    def _finish(self, req: GenerationRequest, status: str,
                error: Optional[str] = None,
                metric: Optional[str] = None):
        req.status = status
        if error is not None:
            req.error = error
        self._deadline.pop(req.request_id, None)
        if metric is not None:
            obs_trace.counter(metric).add(1)
            obs_trace.event(metric, request_id=req.request_id,
                            status=status, error=error)

    def _quarantine(self, req: GenerationRequest, exc: Exception):
        """A poisoned request dies alone: mark it failed (with the
        error), leave every other slot running."""
        self._finish(req, "failed", f"{type(exc).__name__}: {exc}",
                     "serve.quarantined")

    def _validate_prompt(self, req: GenerationRequest):
        """Eager per-request validation at admission — the errors a
        poisoned request would otherwise smuggle into the shared steps
        (where they would take the whole batch down or, worse, index out
        of range)."""
        p = np.asarray(req.prompt)
        if p.ndim != 1 or p.size < 1:
            raise ValueError(f"request {req.request_id}: prompt must be a "
                             f"non-empty 1-D token array, got shape "
                             f"{tuple(p.shape)}")
        if not np.issubdtype(p.dtype, np.integer):
            raise ValueError(f"request {req.request_id}: prompt dtype must "
                             f"be integer token ids, got {p.dtype}")
        lo, hi = int(p.min()), int(p.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            raise ValueError(f"request {req.request_id}: prompt token ids "
                             f"must lie in [0, vocab_size="
                             f"{self.cfg.vocab_size}), got range "
                             f"[{lo}, {hi}]")
        if p.size > self.max_len - 1:
            raise ValueError(f"request {req.request_id}: prompt length "
                             f"{p.size} does not fit the cache "
                             f"(max_len={self.max_len} incl. one generated "
                             f"token)")

    def _expire(self):
        """Time out overdue requests wherever they are (queued,
        prefilling, or decoding) — one clock read per sweep."""
        if not self._deadline:
            return
        now = self._clock()

        def overdue(req):
            t = self._deadline.get(req.request_id)
            return t is not None and now > t

        for req in [r for r in self._queue if overdue(r)]:
            self._queue.remove(req)
            self._finish(req, "timeout", f"deadline_s={req.deadline_s} "
                         f"exceeded while queued", "serve.timeout")
        for slot, st in list(self._prefilling.items()):
            if overdue(st["req"]):
                del self._prefilling[slot]
                self._finish(st["req"], "timeout",
                             f"deadline_s={st['req'].deadline_s} exceeded "
                             f"during chunked prefill", "serve.timeout")
        for slot, req in list(self._active.items()):
            if overdue(req):
                del self._active[slot]
                self._finish(req, "timeout", f"deadline_s={req.deadline_s} "
                             f"exceeded after {len(req.output)} tokens",
                             "serve.timeout")

    def _free_slots(self) -> list[int]:
        return [s for s in range(self.max_batch)
                if s not in self._active and s not in self._prefilling]

    def _install(self, slot: int, req: GenerationRequest, caches1,
                 first_tok: int) -> bool:
        """Finish admission given the request's filled single-row caches
        and first greedy token.  A request the first token already
        completes (EOS, or ``max_new_tokens == 1``) is marked done and
        never occupies a decode slot; returns whether the slot was
        taken."""
        req.output.append(first_tok)
        if ((req.eos_token is not None and first_tok == req.eos_token)
                or len(req.output) >= req.max_new_tokens):
            self._finish(req, "done")
            return False
        # Copy the single-sequence cache into this slot of the shared
        # cache, in place: under every key, per layer, every tensor of the
        # layer's state along its batch axis (a NamedTuple's fields, a
        # (k, v) pair's two), whatever the kind of state.
        for key, layers in self._caches.items():
            for full, one in zip(layers, caches1[key]):
                for dst, src in zip(full, one):
                    dst[slot:slot + 1].copy_(src)
        req.status = "running"
        self._active[slot] = req
        self._pos[slot] = len(req.prompt)
        self._last_tok[slot, 0] = first_tok
        return True

    def _tokens(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                               device=self.device)

    @torch.inference_mode()
    def _admit(self):
        """Move waiting requests into free slots.

        Short prompts prefill in one shot here (and a request whose FIRST
        greedy token already completes it is done at admit, never
        occupying a decode slot).  With ``prefill_chunk_tokens`` set,
        longer prompts only RESERVE their slot here; their prompt is
        consumed chunk-at-a-time by ``_step_prefill`` so decode steps for
        the rest of the batch run in between.  A request that raises
        anywhere in its own admission is quarantined (``failed``) and
        the pass moves on to the next one.
        """
        free = self._free_slots()
        if not (free and self._queue):
            return
        with obs_trace.span("serve.admit", waiting=len(self._queue),
                            free_slots=len(free)):
            while free and self._queue:
                req = self._queue.pop(0)
                try:
                    self._validate_prompt(req)
                    chunk = self.prefill_chunk_tokens
                    if chunk is not None and len(req.prompt) > chunk:
                        slot = free.pop(0)
                        obs_trace.event("serve.slot_reserved",
                                        request_id=req.request_id, slot=slot,
                                        prompt_tokens=len(req.prompt))
                        req.status = "running"
                        self._prefilling[slot] = {
                            "req": req, "consumed": 0,
                            "caches": init_caches(self.cfg, 1, self.max_len,
                                                  self.device)}
                        continue
                    with obs_trace.span("serve.prefill",
                                        request_id=req.request_id,
                                        prompt_tokens=len(req.prompt)):
                        toks = self._tokens(req.prompt)[None, :]
                        logits, caches1 = prefill(self.params, self.cfg,
                                                  toks, max_len=self.max_len)
                        nxt = int(torch.argmax(logits[0, -1]))
                    slot = free[0]
                    if self._install(slot, req, caches1, nxt):
                        free.pop(0)
                except Exception as e:          # noqa: BLE001 — quarantine
                    self._quarantine(req, e)

    @torch.inference_mode()
    def _step_prefill(self):
        """Advance every in-flight chunked prefill by ONE chunk (the
        fixed work quantum that bounds how long the decode batch waits).
        On the final chunk the request either completes at admit-time
        semantics or joins the decode batch in its reserved slot.  A
        chunk that raises quarantines ITS request and frees the slot."""
        for slot, st in list(self._prefilling.items()):
            req, consumed = st["req"], st["consumed"]
            end = min(consumed + self.prefill_chunk_tokens, len(req.prompt))
            try:
                with obs_trace.span("serve.prefill_chunk",
                                    request_id=req.request_id, slot=slot,
                                    start=consumed, end=end) as sp:
                    toks = self._tokens(req.prompt[consumed:end])[None, :]
                    logits, st["caches"] = prefill_chunk(
                        self.params, self.cfg, toks, consumed, st["caches"])
                    if obs_trace.deep_tracing():
                        sp.block_on(logits)
                st["consumed"] = end
                if end == len(req.prompt):
                    del self._prefilling[slot]
                    self._install(slot, req, st["caches"],
                                  int(torch.argmax(logits[0, -1])))
            except Exception as e:              # noqa: BLE001 — quarantine
                self._prefilling.pop(slot, None)
                self._quarantine(req, e)

    # -------------------------------------------------------------- decode
    @torch.inference_mode()
    def _step_decode(self):
        if not self._active:
            return
        # One shared decode step at per-slot positions (continuous
        # batching); inactive slots compute-but-discard.
        with obs_trace.span("serve.decode", active=len(self._active)):
            logits, self._caches = decode_step(
                self.params, self.cfg, self._tokens(self._last_tok),
                self._tokens(self._pos), self._caches)
            # the argmax transfer below syncs, so the span close is an
            # honest device time for the step
            nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for slot, req in list(self._active.items()):
            tok = int(nxt[slot])
            req.output.append(tok)
            self._pos[slot] += 1
            self._last_tok[slot, 0] = tok
            if ((req.eos_token is not None and tok == req.eos_token)
                    or len(req.output) >= req.max_new_tokens
                    or self._pos[slot] >= self.max_len - 1):
                self._finish(req, "done")
                del self._active[slot]

    # ----------------------------------------------------------------- run
    def run(self, max_steps: int = 10_000) -> list[GenerationRequest]:
        """Drive until every submitted request reaches a terminal status
        (or the step budget).  Each iteration: expire deadlines, admit,
        ONE prefill chunk per in-flight long prompt, ONE shared decode
        step — so chunked prefills and decode interleave instead of
        serializing.  Hitting ``max_steps`` EVICTS whatever is still in
        flight (named in ``error``) rather than silently dropping it;
        the return value is every request that reached a terminal
        status this run, whatever that status was."""
        tracer = obs_trace.current_tracer()
        queue_gauge = obs_trace.gauge("serve.queue_depth")
        occ_gauge = obs_trace.gauge("serve.slot_occupancy")
        steps = 0
        with obs_trace.span("serve.run", max_batch=self.max_batch,
                            submitted=len(self._all)) as root:
            while (self._queue or self._active or self._prefilling) \
                    and steps < max_steps:
                if tracer is not None:
                    queue_gauge.set(len(self._queue))
                    occ_gauge.set(len(self._active) + len(self._prefilling))
                self._expire()
                self._admit()
                self._step_prefill()
                self._step_decode()
                steps += 1
                if self.progress is not None:
                    self.progress.update(
                        done=sum(r.status in TERMINAL_STATES
                                 for r in self._all),
                        total=len(self._all), phase="serve",
                        extra={"queue": len(self._queue),
                               "active": len(self._active),
                               "prefilling": len(self._prefilling),
                               "steps": steps})
            self._expire()
            leftovers = (list(self._queue)
                         + [st["req"] for st in self._prefilling.values()]
                         + list(self._active.values()))
            for req in leftovers:
                self._finish(req, "evicted",
                             f"evicted at engine stop after "
                             f"{len(req.output)} tokens: step budget "
                             f"max_steps={max_steps} exhausted",
                             "serve.evicted")
            self._queue.clear()
            self._prefilling.clear()
            self._active.clear()
            if tracer is not None:
                queue_gauge.set(0)
                occ_gauge.set(0)
                root.set(steps=steps,
                         completed=sum(r.done for r in self._all))
        if self.progress is not None:
            terminal = [r for r in self._all if r.status in TERMINAL_STATES]
            self.progress.update(done=len(terminal), total=len(self._all),
                                 phase="serve",
                                 extra={"queue": 0, "active": 0,
                                        "prefilling": 0, "steps": steps},
                                 force=True)
            return terminal
        return [r for r in self._all if r.status in TERMINAL_STATES]
