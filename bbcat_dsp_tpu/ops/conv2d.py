"""2-D convolution (ref: README:30, 2DConvolution.h — documented-absent
template; built from spec as a thin XLA conv wrapper).

``lax.conv_general_dilated`` lowers 2-D convolution to the device's
convolution library — the idiomatic replacement for a C++ loop template.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["convolve2d"]


@partial(jax.jit, static_argnames=("mode",))
def convolve2d(image: jax.Array, kernel: jax.Array, mode: str = "same") -> jax.Array:
    """2-D convolution of ``image [..., H, W]`` with ``kernel [kh, kw]``.

    ``mode``: "same" (output size H x W), "valid", or "full" — matching
    scipy.signal.convolve2d semantics (true convolution: kernel flipped).
    """
    kh, kw = kernel.shape
    batch_shape = image.shape[:-2]
    x = image.reshape((-1, 1) + image.shape[-2:]).astype(jnp.float32)
    k = jnp.flip(kernel, (0, 1)).astype(jnp.float32)[None, None]
    if mode == "same":
        pad = [((kh - 1) // 2, kh // 2), ((kw - 1) // 2, kw // 2)]
    elif mode == "valid":
        pad = [(0, 0), (0, 0)]
    elif mode == "full":
        pad = [(kh - 1, kh - 1), (kw - 1, kw - 1)]
    else:
        raise ValueError(f"unknown mode {mode!r}")
    y = jax.lax.conv_general_dilated(
        x, k, window_strides=(1, 1), padding=pad,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return y.reshape(batch_shape + y.shape[-2:]).astype(image.dtype)
