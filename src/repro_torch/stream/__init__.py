"""The streamed ID of the port (counterpart of ``repro.stream``): the RID
of a matrix seen one row chunk at a time (``rid_stream.py``), and the
chunk sources (``chunks.py``)."""
from .chunks import (ArraySource, ChunkSource, FileSource, SpectrumSource,
                     check_chunk_index, chunk_bounds, num_chunks)
from .rid_stream import rid_streamed, source_fingerprint

__all__ = ["rid_streamed", "ChunkSource", "ArraySource", "SpectrumSource",
           "FileSource", "num_chunks", "chunk_bounds", "check_chunk_index",
           "source_fingerprint"]
