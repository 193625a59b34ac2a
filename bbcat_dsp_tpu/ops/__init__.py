"""Core ops: mixing, interpolation ramps, 2-D convolution
(ref: src/SoundMixing.*, src/Interpolator.h, README:30)."""

from .interpolator import (
    ComplexInterpolator,
    Interpolator,
    complex_interp_ramp,
    complex_interpolator,
    interp_ramp,
    interpolator,
)
from .mixing import mix_samples, mix_samples_ramped
from .conv2d import convolve2d

__all__ = [
    "ComplexInterpolator",
    "Interpolator",
    "complex_interp_ramp",
    "complex_interpolator",
    "interp_ramp",
    "interpolator",
    "mix_samples",
    "mix_samples_ramped",
    "convolve2d",
]
