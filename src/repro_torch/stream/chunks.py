"""Chunk sources (counterpart of ``repro.stream.chunks``): the feeding
half of the streamed ID.

A :class:`ChunkSource` hands the pipeline one row chunk of ``A`` at a
time, the only way the streamed decomposition ever sees the matrix.
Three implementations ship:

  * ``ArraySource``    -- slices a host-resident array (a CPU tensor or a
                          numpy array, kept as a tensor without a copy):
                          the paper's "matrix on the host, not in HBM"
                          case.  Chunks are row views.
  * ``SpectrumSource`` -- a seeded known-spectrum matrix
                          (``data.synthetic.spectrum_factors``) whose rows
                          are generated per chunk in closed form ON ITS
                          DEVICE: ``m`` scales past device and host memory
                          with the exact ``sigma_{k+1}`` in hand, and no
                          host copy of ``A`` exists.
  * ``FileSource``     -- a memory-mapped ``.npy`` on disk, with a
                          read-ahead thread (``data.prefetch.
                          PrefetchIterator``) so the next chunk's disk read
                          overlaps the current chunk's transfer and
                          accumulation.

Sources must be re-readable: the decomposition makes two passes (the
sketch accumulation, then the pivot-column gather ``B = A[:, J]``), so
``chunk(c)`` may be called more than once and returns the same rows each
time.  ``chunk(c)`` and ``chunk_bounds`` with ``c`` outside
``[0, num_chunks)`` raise ``ValueError`` naming ``c`` and the valid count
(a slice past the end would be an empty ``(0, n)`` chunk that corrupts
the accumulator silently).

Fingerprints: a source may expose ``fingerprint()``, a value that
identifies the MATRIX (not only its geometry); it is folded into the
resume identity (``rid_stream.source_fingerprint``), so a checkpoint
written against one matrix is refused for any other.  ``FileSource``
fingerprints ``(path, size, mtime_ns)``; ``SpectrumSource`` ``(seed,
spectrum, k, r, floor, dtype)``; ``ArraySource`` has none (its caller owns
the identity of the array).

``FileSource`` failure modes (the reference's): a missing file raises
``FileNotFoundError`` and a file that is not a 2-D ``.npy`` ``ValueError``
at construction (a truncated one fails in the mmap there); a file
replaced or appended mid-job raises ``SourceDied`` (permanent, never
retried) at the next read, which re-stats it; a read after ``close()``
raises ``ValueError``.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..core.rng import check_device
from ..data.prefetch import PrefetchIterator
from ..data.synthetic import SpectrumFactors, spectrum_factors, spectrum_rows
from ..runtime.faults import SourceDied

__all__ = ["ChunkSource", "ArraySource", "SpectrumSource", "FileSource",
           "num_chunks", "chunk_bounds", "check_chunk_index"]


@runtime_checkable
class ChunkSource(Protocol):
    """Row-chunked read access to an ``m x n`` matrix."""

    shape: tuple[int, int]
    dtype: torch.dtype
    chunk_rows: int

    def chunk(self, c: int) -> torch.Tensor:
        """Rows ``[c * chunk_rows, min((c + 1) * chunk_rows, m))`` as a
        tensor (host or device).  Deterministic per ``c``; ``c`` outside
        ``[0, num_chunks)`` raises ``ValueError``."""
        ...


def num_chunks(source: ChunkSource) -> int:
    m = source.shape[0]
    return -(-m // source.chunk_rows)


def check_chunk_index(source: ChunkSource, c: int) -> None:
    """Refuse an out-of-range chunk index, naming ``c`` and the range."""
    C = num_chunks(source)
    if not 0 <= c < C:
        raise ValueError(f"chunk index c={c} out of range for "
                         f"{type(source).__name__} with {C} chunks "
                         f"(m={source.shape[0]}, "
                         f"chunk_rows={source.chunk_rows}); valid c are "
                         f"[0, {C})")


def chunk_bounds(source: ChunkSource, c: int) -> tuple[int, int]:
    check_chunk_index(source, c)
    m = source.shape[0]
    r0 = c * source.chunk_rows
    return r0, min(r0 + source.chunk_rows, m)


def _check_chunk_rows(chunk_rows: int) -> None:
    if chunk_rows < 1:
        raise ValueError(f"need chunk_rows >= 1, got chunk_rows={chunk_rows}")


class ArraySource:
    """Host-array slicer: ``A`` stays where it is (a numpy array becomes a
    tensor that shares its memory); each chunk is a row view that the
    pipeline sends to the device on demand."""

    def __init__(self, A, chunk_rows: int):
        A = torch.as_tensor(A)
        if A.ndim != 2:
            raise ValueError(f"need a 2-D matrix, got shape "
                             f"{tuple(A.shape)}")
        _check_chunk_rows(chunk_rows)
        self._A = A
        self.shape = tuple(A.shape)
        self.dtype = A.dtype
        self.chunk_rows = int(chunk_rows)

    def chunk(self, c: int) -> torch.Tensor:
        r0, r1 = chunk_bounds(self, c)
        return self._A[r0:r1]


class SpectrumSource:
    """Seeded known-spectrum source whose chunks are generated on its
    device.

    ``sigmas`` carries the exact singular values (``sigmas[k]`` is the
    eq. (3) reference ``sigma_{k+1}``); rows are generated per chunk and
    never held all at once.  Generation is closed-form per global row
    index, so the matrix does not depend on ``chunk_rows``.  ``factors``
    holds the factorization (``V`` on ``device``), from which
    ``data.synthetic.spectrum_id_error`` gives an ID's exact error norm.
    """

    def __init__(self, seed: int, m: int, n: int, spectrum: str, k: int, *,
                 chunk_rows: int, r: Optional[int] = None,
                 dtype: torch.dtype = torch.float64, floor: float = 1e-6,
                 device="cuda"):
        _check_chunk_rows(chunk_rows)
        self.device = check_device(device)
        self.factors: SpectrumFactors = spectrum_factors(
            int(seed), m, n, spectrum, k, r=r, dtype=dtype, floor=floor,
            device=self.device)
        self.sigmas = np.asarray(self.factors.sig)
        self.shape = (m, n)
        self.dtype = dtype
        self.chunk_rows = int(chunk_rows)
        # The matrix identity beyond geometry: two sources of one geometry
        # but another seed / spectrum / k / r / floor are other matrices.
        self._fp = (int(seed), str(spectrum), int(k),
                    int(r) if r is not None else None, float(floor),
                    str(dtype).removeprefix("torch."))

    def fingerprint(self) -> tuple:
        """Everything the generated values depend on: (seed, spectrum, k,
        r, floor, dtype)."""
        return self._fp

    def chunk(self, c: int) -> torch.Tensor:
        r0, r1 = chunk_bounds(self, c)
        return spectrum_rows(self.factors, r0, r1)

    def materialize(self) -> torch.Tensor:
        """Every chunk concatenated (small ``m`` only)."""
        return torch.cat([self.chunk(c) for c in range(num_chunks(self))])


class FileSource:
    """Memory-mapped ``.npy`` chunk source with read-ahead.

    The matrix lives on disk; ``chunk(c)`` copies rows out of the mmap
    (the page-in happens on the reader thread, not in the pipeline), so
    host memory is ``O(readahead * chunk_rows * n)``.

    Read-ahead: with ``readahead >= 1`` a background thread
    (``PrefetchIterator``) walks the chunks in order and keeps up to
    ``readahead`` of them in a bounded queue, so the disk read of chunk
    ``c + 1`` overlaps the transfer and accumulation of chunk ``c``.  A
    read out of order (a resume, a retry of the same chunk) restarts the
    read-ahead at the chunk asked for.  ``readahead=0`` reads
    synchronously.

    ``fingerprint()`` is ``(abspath, size, mtime_ns)`` at construction,
    and every read re-stats the file (module docstring).  ``close()``
    stops the reader thread and drops the mmap; it is idempotent, and the
    source is a context manager.
    """

    def __init__(self, path, chunk_rows: int, *, readahead: int = 2):
        _check_chunk_rows(chunk_rows)
        if readahead < 0:
            raise ValueError(f"need readahead >= 0, got "
                             f"readahead={readahead}")
        path = os.fspath(path)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"FileSource: no such file: {path!r}")
        # A truncated file fails here: the .npy header promises more bytes
        # than the file holds, and the mmap refuses it.
        self._mm = np.load(path, mmap_mode="r")
        if self._mm.ndim != 2:
            raise ValueError(f"FileSource needs a 2-D .npy, got ndim="
                             f"{self._mm.ndim} (shape {self._mm.shape}) "
                             f"in {path!r}")
        st = os.stat(path)
        self.path = os.path.abspath(path)
        self._size = int(st.st_size)
        self._mtime_ns = int(st.st_mtime_ns)
        self.shape = tuple(self._mm.shape)
        self.dtype = torch.from_numpy(np.empty(0, self._mm.dtype)).dtype
        self.chunk_rows = int(chunk_rows)
        self._readahead = int(readahead)
        self._pf: Optional[PrefetchIterator] = None
        self._pf_next = 0            # the chunk the prefetcher yields next
        self._closed = False

    def fingerprint(self) -> tuple:
        """``(abspath, size, mtime_ns)`` at construction."""
        return (self.path, self._size, self._mtime_ns)

    def _read(self, c: int) -> torch.Tensor:
        """The disk read (on the read-ahead thread): re-stat first, since a
        file replaced or appended mid-job would mix old and new bytes."""
        st = os.stat(self.path)
        if (int(st.st_size), int(st.st_mtime_ns)) != (self._size,
                                                      self._mtime_ns):
            raise SourceDied(
                f"file {self.path!r} changed mid-job: (size, mtime_ns) now "
                f"({st.st_size}, {st.st_mtime_ns}), was ({self._size}, "
                f"{self._mtime_ns}) at open; the mmap would mix old and new "
                f"bytes, so start a fresh job against the new file")
        r0, r1 = chunk_bounds(self, c)
        return torch.from_numpy(np.array(self._mm[r0:r1]))  # the page-in

    def _chunks_from(self, c0: int) -> Iterator[torch.Tensor]:
        for c in range(c0, num_chunks(self)):
            yield self._read(c)

    def chunk(self, c: int) -> torch.Tensor:
        check_chunk_index(self, c)
        if self._closed:
            raise ValueError(f"FileSource({self.path!r}) is closed; "
                             f"chunk({c}) after close() is a bug in the "
                             f"caller's lifetime management")
        if self._readahead == 0:
            return self._read(c)
        if self._pf is None or self._pf_next != c:
            if self._pf is not None:
                self._pf.close()
            self._pf = PrefetchIterator(self._chunks_from(c),
                                        depth=self._readahead)
            self._pf_next = c
        try:
            out = next(self._pf)
        except BaseException:
            # The reader died raising (e.g. the file changed): drop it, so
            # a later read restarts instead of blocking on a dead queue.
            self._pf.close()
            self._pf = None
            self._pf_next = 0
            raise
        self._pf_next = c + 1
        if self._pf_next >= num_chunks(self):
            self._pf.close()         # pass done; the next pass restarts
            self._pf = None
            self._pf_next = 0
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._pf is not None:
            self._pf.close()
            self._pf = None
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
