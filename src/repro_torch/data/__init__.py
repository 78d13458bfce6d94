"""Synthetic data of the port (counterpart of ``repro.data``): the
known-spectrum matrices of the eq. (3) verification grid."""
from .synthetic import (DTYPE_FLOORS, SPECTRA, spectrum_matrix,
                        spectrum_sigmas)

__all__ = ["SPECTRA", "DTYPE_FLOORS", "spectrum_sigmas", "spectrum_matrix"]
