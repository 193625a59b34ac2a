"""Double-precision NumPy golden models.

The reference (`bbc/bbcat-dsp`) ships no tests and no published benchmark
numbers (SURVEY.md §4, §6).  This package is the substitute: bit-faithful,
double-precision NumPy implementations of the reference's numeric contracts,
used by the test suite as the oracle for the >=90 dB SNR equivalence bound and
by `bench.py` as the accuracy reference.

These are NOT the production path — they are deliberately scalar/NumPy and
slow.  The device implementations live in the sibling packages and are validated
against these.
"""

from .biquad import (
    FilterType,
    biquad_coeffs,
    biquad_process,
    biquad_process_interpolated,
    biquad_response,
    cascade_process,
)
from .fractional import fractional_sample, fractional_delay_block, ADDITIONAL_DELAY
from .convolve import direct_convolve, partitioned_convolve, crossfade_swap_convolve
from .loudness import k_weighting_coeffs, integrated_loudness, CHANNEL_WEIGHTS_5_1
from .allpass import allpass_process

__all__ = [
    "FilterType",
    "biquad_coeffs",
    "biquad_process",
    "biquad_process_interpolated",
    "biquad_response",
    "cascade_process",
    "fractional_sample",
    "fractional_delay_block",
    "ADDITIONAL_DELAY",
    "direct_convolve",
    "partitioned_convolve",
    "crossfade_swap_convolve",
    "k_weighting_coeffs",
    "integrated_loudness",
    "CHANNEL_WEIGHTS_5_1",
    "allpass_process",
]
