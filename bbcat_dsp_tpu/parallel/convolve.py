"""Sharded partitioned convolution: channel-parallel and time-parallel.

Device-mesh replacement for the reference Convolver's thread-per-channel
parallelism (ref: README:43-44) at multi-card scale (BASELINE.json config #5):

* **Channel sharding** — each device owns a contiguous channel slice of the
  queue / IR spectra / signal and runs the identical convolver step with
  ZERO communication (channels are independent).  Expressed with
  ``shard_map`` so XLA cannot accidentally reshard the 10s-of-MB state.

* **Time sharding** (offline render) — the signal's time axis is split into
  contiguous spans, one per device.  Overlap-save needs the P*B input
  samples preceding each span (the spectral-queue history): exactly the
  halo-exchange pattern of context parallelism (SURVEY.md §5), implemented
  with ``ppermute`` from the left neighbour, after which every span renders
  independently and bit-identically to the sequential stream.

Both compose: a 2-D (ch, t) mesh shards channels and time simultaneously.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..convolve.block import (
    ConvolverState,
    convolver_render,
    convolver_step,
)
from ..convolve.fft import (
    SpectralSpec,
    half_window_signs,
    rfft_half_planes,
)

__all__ = [
    "channel_sharded_step",
    "channel_sharded_render",
    "channel_sharded_nonuniform_render",
    "time_sharded_render",
    "time_sharded_nonuniform_render",
]


def channel_sharded_step(mesh: Mesh, axis_name: str = "ch",
                         spec: SpectralSpec | None = None):
    """Build a jitted ``(state, H, x) -> (state, y)`` with every operand's
    channel axis sharded over ``mesh``.

    State layout (SURVEY.md §5): queue ``[2, P, C, F]`` (C sharded), prev
    ``[C, B]``, step replicated; ``H [2, P, C, F]``; ``x [C, B]``.

    ``spec`` is the engine's frozen :class:`SpectralSpec` (layout/radix/
    kernel gates resolved at construction — pass the owning convolver's,
    so the sharded program matches its state layout exactly).
    """
    state_spec = ConvolverState(
        queue=P(None, None, axis_name, None),
        prev=P(None, axis_name, None),
        step=P(),
    )
    h_spec = P(None, None, axis_name, None)
    x_spec = P(axis_name, None)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(state_spec, h_spec, x_spec),
        out_specs=(state_spec, x_spec),
        check_vma=False,
    )
    def _step(state, H, x):
        return convolver_step(state, H, x, spec=spec)

    return jax.jit(_step, donate_argnums=(0,))


def channel_sharded_render(mesh: Mesh, block: int, axis_name: str = "ch",
                           spec: SpectralSpec | None = None):
    """Like :func:`channel_sharded_step` but renders a whole ``[C, T]``
    signal via the on-device block scan (the pod-scale bench path)."""
    state_spec = ConvolverState(
        queue=P(None, None, axis_name, None),
        prev=P(None, axis_name, None),
        step=P(),
    )
    h_spec = P(None, None, axis_name, None)
    x_spec = P(axis_name, None)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(state_spec, h_spec, x_spec),
        out_specs=(state_spec, x_spec),
        check_vma=False,
    )
    def _render(state, H, x):
        return convolver_render(state, H, x, block, spec=spec)

    return jax.jit(_render, donate_argnums=(0,))


def channel_sharded_nonuniform_render(mesh: Mesh, block: int,
                                      axis_name: str = "ch",
                                      tail_slot0: int | None = None,
                                      specs: tuple | None = None):
    """Channel-sharded render for the NON-UNIFORM (two-level) engine — the
    pod config's flagship path (BASELINE.json config #5: 1024 ch shard to
    N hosts with zero cross-device communication).

    Every state leaf, both IR spectra stacks and the signal shard their
    channel axis; each device runs the identical
    :func:`bbcat_dsp_tpu.convolve.nonuniform._render_impl`.  Returns a jitted
    ``(state, H_head, H_tail, x) -> (state, y)``.

    ``specs`` is the engine's frozen (head, tail) SpectralSpec pair
    (``NonUniformConvolver.specs``) — REQUIRED whenever the engine resolved
    a non-default configuration (e.g. the dftmm backend with a permuted
    tail layout), so the sharded program agrees
    with the engine's state/IR layout.
    """
    from ..convolve.nonuniform import NonUniformState, _render_impl

    state_spec = NonUniformState(
        xcarry=P(None, None, axis_name, None),
        prev=P(None, axis_name, None),
        tail=ConvolverState(
            queue=P(None, None, axis_name, None),
            prev=P(None, axis_name, None),
            step=P(),
        ),
        pending=P(None, axis_name, None),
    )
    h_spec = P(None, None, axis_name, None)
    x_spec = P(axis_name, None)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(state_spec, h_spec, h_spec, x_spec),
        out_specs=(state_spec, x_spec),
        check_vma=False,
    )
    def _render(state, H_head, H_tail, x):
        return _render_impl(state, H_head, H_tail, x, block, tail_slot0,
                            specs)

    return jax.jit(_render, donate_argnums=(0,))


def time_sharded_nonuniform_render(mesh: Mesh, block: int, ratio: int,
                                   head_parts: int, tail_parts: int,
                                   axis_name: str = "t",
                                   ch_axis: str | None = None,
                                   specs: tuple | None = None):
    """Time(+channel)-sharded offline render for the NON-UNIFORM two-level
    engine — the low-channel-count long-render use
    case the channel-sharded path cannot serve.

    Each device owns a contiguous span of ``T / n_t`` samples (a multiple
    of ``tail_parts * ratio * block`` so every local stream enters the
    grouped render with ``tail_slot0 = 0``) and receives the trailing
    ``(tail_parts + 2) * B2`` input samples of its LEFT neighbour via ONE
    ``ppermute`` — the overlap-save halo covering every piece of two-level
    state:

    * head ``xcarry`` (last ``head_parts`` window spectra) + ``prev`` —
      the final ``head_parts + 1`` small blocks of the halo;
    * tail queue (last ``tail_parts`` super-window spectra) + ``prev``;
    * the 2-slot ``pending`` re-alignment queue — the tail outputs of the
      two super-steps preceding the span, each a ``tail_parts``-deep MAC
      over halo windows (this is why the halo is ``Pt + 2`` supers, not
      ``Pt + 1``).

    Returns a jitted ``(H_head, H_tail, x) -> y`` whose output matches the
    sequential stream from zero initial state (>=110 dB; bit-comparable in
    practice).  ``specs`` is the engine's frozen (head, tail) SpectralSpec
    pair, as in :func:`channel_sharded_nonuniform_render`.
    """
    from ..convolve.nonuniform import NonUniformState, _head_mac, _render_impl
    from ..convolve.fft import irfft_tail_planes

    sh, st = specs if specs is not None else (None, None)
    B = block
    B2 = B * ratio
    Pt = tail_parts
    Ph = head_parts
    halo_sup = Pt + 2
    halo_len = halo_sup * B2

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, None, ch_axis, None), P(None, None, ch_axis, None),
                  P(ch_axis, axis_name)),
        out_specs=P(ch_axis, axis_name),
        check_vma=False,
    )
    def _render(H_head, H_tail, x):
        n = jax.lax.axis_size(axis_name)
        C, T_local = x.shape
        nsuper = T_local // B2
        assert nsuper % Pt == 0, (
            "per-device span must be a whole number of render groups "
            f"(got {nsuper} supers, Pt={Pt})"
        )
        assert T_local >= halo_len, (
            "per-device span must cover the (Pt+2)-super halo (one-hop "
            f"ppermute): span {T_local} < halo {halo_len}"
        )
        # ---- halo: last (Pt+2) super-blocks of the LEFT neighbour
        tail_x = x[:, -halo_len:]
        halo = jax.lax.ppermute(
            tail_x, axis_name, [(i, (i + 1) % n) for i in range(n)]
        )
        idx = jax.lax.axis_index(axis_name)
        halo = jnp.where(idx == 0, jnp.zeros_like(halo), halo)

        # ---- tail state: half spectra of the halo supers.  The tail
        # queue holds RAW half spectra (xt-slot layout): the last Pt halo
        # supers' spectra, chronological == slot-encoded at slot0 = 0
        # (step ≡ 0 mod Pt by the span rule).
        hsup = jnp.moveaxis(halo.reshape(C, halo_sup, B2), 1, 0)
        t_half = rfft_half_planes(hsup, 2 * B2, spec=st)  # [2, Pt+2, C, F2]
        s2 = jnp.asarray(half_window_signs(2 * B2, spec=st))
        w = t_half[:, :-1] + s2 * t_half[:, 1:]           # [2, Pt+1, C, F2]
        queue = t_half[:, 2:]
        # pending[k] = tail output of super-step s0 - 2 + k (k = 0, 1):
        # a Pt-deep sliding MAC over the halo windows, then the tail
        # irfft.  _head_mac computes acc[i] = sum_p ext[Pt + i - p]; the
        # windows wanted are w[Pt - 1 + i - p], so prepend one (never
        # referenced) dummy slot to shift the indexing by one.
        ext = jnp.concatenate([jnp.zeros_like(w[:, :1]), w], axis=1)
        acc = _head_mac(ext, H_tail, 2)
        pending = irfft_tail_planes(acc, 2 * B2,
                                    spec=st).astype(x.dtype)  # [2, C, B2]

        # ---- head state: window spectra of the last Ph small blocks
        # (window at small block m covers blocks m-1, m)
        head_x = halo[:, -(Ph + 1) * B:]
        hb = jnp.moveaxis(head_x.reshape(C, Ph + 1, B), 1, 0)
        h_half = rfft_half_planes(hb, 2 * B, spec=sh)     # [2, Ph+1, C, F]
        s1 = jnp.asarray(half_window_signs(2 * B, spec=sh))
        xcarry = h_half[:, :-1] + s1 * h_half[:, 1:]      # [2, Ph, C, F]
        prev = h_half[:, -1]

        from ..convolve.block import ConvolverState

        state = NonUniformState(
            xcarry=xcarry,
            prev=prev,
            tail=ConvolverState(
                queue=queue,
                prev=t_half[:, -1],
                step=jnp.asarray(0, jnp.int32),
            ),
            pending=pending,
        )
        _, y = _render_impl(state, H_head, H_tail, x, B, 0, specs)
        return y

    return jax.jit(_render)


def time_sharded_render(mesh: Mesh, block: int, nparts: int,
                        axis_name: str = "t", ch_axis: str | None = None,
                        spec: SpectralSpec | None = None):
    """Build a jitted ``(H, x) -> y`` rendering ``x [C, T]`` with the TIME
    axis sharded: each device gets a span of ``T / n_devices`` samples
    (must be a multiple of ``block``), receives its left neighbour's
    trailing ``nparts * block`` samples via ``ppermute`` (the overlap-save
    halo), locally reconstructs the spectral queue from those halo windows,
    and renders its span.  Output is bit-comparable to the sequential
    stream from zero initial state."""
    halo_len = nparts * block

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, None, ch_axis, None), P(ch_axis, axis_name)),
        out_specs=P(ch_axis, axis_name),
        check_vma=False,
    )
    def _render(H, x):
        n = jax.lax.axis_size(axis_name)
        # halo: last nparts*block input samples of the LEFT neighbour
        tail = x[:, -halo_len:]
        halo = jax.lax.ppermute(
            tail, axis_name, [(i, (i + 1) % n) for i in range(n)]
        )
        idx = jax.lax.axis_index(axis_name)
        halo = jnp.where(idx == 0, jnp.zeros_like(halo), halo)

        C = x.shape[0]
        # rebuild the spectral queue: window w covers halo blocks
        # [w-1, w] (2*block samples) — exactly what the streaming engine
        # would have enqueued for the nparts most recent past blocks
        padded = jnp.concatenate(
            [jnp.zeros((C, block), x.dtype), halo], axis=-1
        )
        windows = jnp.stack(
            [
                jax.lax.dynamic_slice_in_dim(
                    padded, k * block, 2 * block, axis=-1
                )
                for k in range(nparts)
            ],
            axis=0,
        )  # [nparts, C, 2B] — window k ends at halo block k
        # window spectrum via the shift theorem on half-window transforms
        # (keeps the spectra in the half-window engine's layout — permuted
        # for large dftmm sizes — so the rebuilt queue matches the
        # streaming engine's state exactly)
        s = jnp.asarray(half_window_signs(2 * block, spec=spec))
        spectra = (
            rfft_half_planes(windows[..., :block], 2 * block, spec=spec)
            + s * rfft_half_planes(windows[..., block:], 2 * block,
                                   spec=spec)
        )  # [2, nparts, C, F]
        # queue slot for the block that is p blocks in the past must hold
        # that block's window spectrum.  Start the local stream at
        # step = nparts so slot = (step - p) % nparts: the window ending at
        # halo block nparts-1 (the most recent) sits p=1 in the past.
        # window k is (nparts - k) blocks in the past -> slot (nparts*2 - (nparts-k)) % nparts = k
        queue = spectra  # slot k == window k (derivation above)
        state = ConvolverState(
            queue=queue,
            prev=rfft_half_planes(halo[:, -block:], 2 * block, spec=spec),
            step=jnp.asarray(nparts, jnp.int32),
        )
        _, y = convolver_render(state, H, x, block, spec=spec)
        return y

    return jax.jit(_render)
