"""Differentiability: the convolution engine is a pure jax program, so IRs
(and any other parameter) can be FIT by gradient descent through it — a
capability the reference's C++ cannot express."""

import numpy as np
import jax
import jax.numpy as jnp

from bbcat_dsp_tpu.convolve import partition_ir
from bbcat_dsp_tpu.convolve.block import convolver_init
from bbcat_dsp_tpu.convolve.fft import rfft_planes
from conftest import snr_db


def test_fit_ir_by_gradient_descent(rng):
    """Recover an unknown 128-tap IR from (input, output) pairs by
    optimising the TIME-DOMAIN IR through the spectral engine."""
    from bbcat_dsp_tpu.convolve.block import convolver_render

    B, N, T = 64, 128, 64 * 8
    true_ir = (rng.standard_normal(N) * np.exp(-np.arange(N) / 30.0)).astype(
        np.float32)
    x = rng.standard_normal((1, T)).astype(np.float32)
    H_true = partition_ir(true_ir, B)
    state0 = convolver_init(1, B, H_true.shape[1])
    _, y_target = convolver_render(state0, H_true, jnp.asarray(x), B)

    P = H_true.shape[1]

    def spectra(ir):
        parts = ir.reshape(P, B)
        padded = jnp.concatenate([parts, jnp.zeros_like(parts)], -1)
        Hs = rfft_planes(padded, 2 * B)          # [2, P, 2B//2+1]
        return Hs[:, :, None, :]                  # [2, P, 1, F]

    @jax.jit
    def loss(ir):
        st = convolver_init(1, B, P)
        _, y = convolver_render(st, spectra(ir), jnp.asarray(x), B)
        return jnp.mean((y - y_target) ** 2)

    import optax

    ir = jnp.zeros(P * B, jnp.float32)
    opt = optax.adam(3e-2)
    opt_state = opt.init(ir)
    g = jax.jit(jax.grad(loss))

    @jax.jit
    def step(ir, opt_state):
        grads = g(ir)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(ir, updates), opt_state

    for _ in range(200):
        ir, opt_state = step(ir, opt_state)
    fitted = np.asarray(ir)[:N]
    assert snr_db(true_ir, fitted) > 30.0
    # scale-free residual: absolute loss depends on the seed's signal energy
    rel = float(loss(ir)) / float(jnp.mean(y_target ** 2))
    assert rel < 1e-3, rel


def _two_level_loss_case(rng):
    """A small two-level engine (head + 2 tail partitions) whose whole
    render is differentiated through ``_render_impl``."""
    from bbcat_dsp_tpu.convolve import NonUniformConvolver

    C, B, ratio = 16, 32, 2
    B2 = B * ratio
    N = 2 * ratio * B + 2 * B2
    irs = rng.standard_normal((C, N)).astype(np.float32) * 0.3
    x = jnp.asarray(rng.standard_normal((C, 2 * 2 * B2)).astype(np.float32))
    return NonUniformConvolver(irs, block=B, ratio=ratio), x, B


def test_grad_through_kernel_path(rng):
    """``jax.grad`` through the two-level render (the path that once ran
    hand-written kernels with ``custom_vjp`` adjoints, now plain XLA):
    reverse-mode cotangents w.r.t. both IR spectra stacks and the input
    match central finite differences along random directions."""
    from bbcat_dsp_tpu.convolve.nonuniform import _render_impl

    conv, x, B = _two_level_loss_case(rng)

    def loss(Hh, Ht, xs):
        _, y = _render_impl(conv.state, Hh, Ht, xs, B, 0, conv.specs)
        return jnp.sum(y ** 2)

    args = (conv.H_head, conv.H_tail, x)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    f = jax.jit(loss)
    for k, (g, what) in enumerate(zip(grads, ("dH_head", "dH_tail", "dx"))):
        assert g.shape == args[k].shape and np.isfinite(np.asarray(g)).all()
        d = jnp.asarray(rng.standard_normal(g.shape).astype(np.float32))
        eps = 1e-2
        plus = list(args)
        minus = list(args)
        plus[k] = args[k] + eps * d
        minus[k] = args[k] - eps * d
        fd = (float(f(*plus)) - float(f(*minus))) / (2 * eps)
        ad = float(jnp.sum(g * d))
        assert abs(fd - ad) <= 2e-3 * max(abs(ad), 1.0), (what, fd, ad)


def test_jvp_contract_on_kernel_path(rng):
    """Forward mode works through the same render (the ``custom_vjp``
    kernel wrappers that forbade it are gone): ``jax.jvp`` agrees with the
    reverse-mode directional derivative and with the linearised render."""
    from bbcat_dsp_tpu.convolve.nonuniform import _render_impl

    conv, x, B = _two_level_loss_case(rng)

    def loss(xs):
        _, y = _render_impl(conv.state, conv.H_head, conv.H_tail, xs, B, 0,
                            conv.specs)
        return jnp.mean(y ** 2)

    t = jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))
    val, tangent = jax.jvp(loss, (x,), (t,))
    g = jax.grad(loss)(x)
    assert np.isfinite(float(val)) and np.isfinite(float(tangent))
    np.testing.assert_allclose(float(tangent), float(jnp.sum(g * t)),
                               rtol=1e-4)


def test_gradients_flow_through_iir(rng):
    """Gradients flow through the modal IIR engine (e.g. for matched-EQ
    optimisation of pole/zero parameters)."""
    from bbcat_dsp_tpu.filters.iir import ModalParams, modal_apply

    x = jnp.asarray(rng.standard_normal(256).astype(np.float32))

    def loss(pr):
        params = ModalParams(
            b0=jnp.float32(1.0), d1=jnp.float32(0.5), d2=jnp.float32(0.1),
            p1r=pr, p1i=jnp.float32(0.3), p2r=pr, p2i=jnp.float32(-0.3),
        )
        y, _ = modal_apply(x, params)
        return jnp.mean(y ** 2)

    gval = jax.grad(loss)(jnp.float32(0.5))
    assert np.isfinite(float(gval)) and abs(float(gval)) > 0
