"""Synthetic data of the port (counterpart of ``repro.data``): the
known-spectrum matrices of the eq. (3) verification grid, their
row-generable form for the streamed ID, the LM stack's replayable token
batches, and the background prefetcher."""
from .prefetch import PrefetchIterator
from .synthetic import (DTYPE_FLOORS, SPECTRA, SpectrumFactors,
                        SyntheticConfig, batch_for_step, make_batch_iterator,
                        row_diagonal, spectrum_factors, spectrum_id_error,
                        spectrum_matrix, spectrum_rows, spectrum_sigmas)

__all__ = ["SPECTRA", "DTYPE_FLOORS", "spectrum_sigmas", "spectrum_matrix",
           "SpectrumFactors", "spectrum_factors", "spectrum_rows",
           "row_diagonal", "spectrum_id_error", "SyntheticConfig",
           "batch_for_step", "make_batch_iterator", "PrefetchIterator"]
