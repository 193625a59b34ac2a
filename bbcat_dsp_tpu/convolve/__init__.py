"""Partitioned FFT convolution engines (the reference's documented-absent
BlockConvolver/Convolver capability, ref: README:38-44, rebuilt as batched
array programs).
"""

from .fft import rfft_planes, irfft_planes, cmul, register_backend, backends, default_backend, set_precision
from .block import (
    BlockConvolver,
    ConvolverState,
    convolver_init,
    convolver_render,
    convolver_step,
    convolver_step_crossfade,
    partition_ir,
)
from .nonuniform import (
    NonUniformConvolver,
    NonUniformState,
    nonuniform_render,
    nonuniform_render_looped,
)
from .offline import offline_convolve
from .matrix import (
    MatrixConvolver,
    matrix_step,
    matrix_step_crossfade,
    partition_ir_matrix,
)

__all__ = [
    "rfft_planes",
    "irfft_planes",
    "cmul",
    "default_backend",
    "set_precision",
    "register_backend",
    "backends",
    "BlockConvolver",
    "ConvolverState",
    "convolver_init",
    "convolver_render",
    "convolver_step",
    "convolver_step_crossfade",
    "partition_ir",
    "NonUniformConvolver",
    "NonUniformState",
    "nonuniform_render",
    "nonuniform_render_looped",
    "offline_convolve",
    "MatrixConvolver",
    "matrix_step",
    "matrix_step_crossfade",
    "partition_ir_matrix",
]
