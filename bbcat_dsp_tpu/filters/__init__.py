"""L3 — DSP filters: RBJ biquads, cascades/banks, all-pass, fractional delay.

Batched-array reimagining of the reference's filter layer (ref: src/BiQuad.*,
src/AllPassFilter.h, src/FractionalSample.*): per-sample recurrences become
associative scans, channel loops become batched axes, SSE intrinsics become
vectorised XLA ops (SURVEY.md §7).
"""

from .biquad import (
    FilterType,
    biquad_coeffs,
    biquad_response,
    cascade_response,
    write_response,
    design_bank,
)
from .iir import (
    ParallelCascadeParams,
    biquad_apply,
    biquad_ssm,
    cascade_apply,
    interp_trajectory,
    parallel_cascade_apply,
    parallel_cascade_params,
)
from .bank import (
    BankState,
    BiQuadBlock,
    BiQuadCascade,
    BiQuadFilterBank,
    bank_init,
    bank_process,
    bank_set_stage,
)
from .allpass import AllPassFilter, AllPassFilterChain, allpass_apply, comb_apply
from .fractional import (
    ADDITIONAL_DELAY,
    FractionalDelayLine,
    additional_delay_required,
    fractional_read,
)
from .manager import FilterManager
from .resample import Resampler, resample

__all__ = [
    "FilterType",
    "biquad_coeffs",
    "biquad_response",
    "cascade_response",
    "write_response",
    "design_bank",
    "biquad_apply",
    "biquad_ssm",
    "cascade_apply",
    "ParallelCascadeParams",
    "parallel_cascade_apply",
    "parallel_cascade_params",
    "interp_trajectory",
    "BankState",
    "BiQuadBlock",
    "BiQuadCascade",
    "BiQuadFilterBank",
    "bank_init",
    "bank_process",
    "bank_set_stage",
    "AllPassFilter",
    "AllPassFilterChain",
    "allpass_apply",
    "comb_apply",
    "ADDITIONAL_DELAY",
    "FractionalDelayLine",
    "additional_delay_required",
    "fractional_read",
    "FilterManager",
    "Resampler",
    "resample",
]
