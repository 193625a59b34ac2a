"""MultilayerBuffer: mix N producers with different block sizes into one
stream.

Batched-array redesign of the reference's ``MultilayerBuffer<T>``
(ref: src/MultilayerBuffer.h:45-431): per-layer write positions, readable
frames = frames complete across ALL layers (``minposition``), furthest
write = ``maxposition`` (diagram at src/MultilayerBuffer.h:30-43).  The
reference compacts with memmove (ref: BufferRead, .h:383-407); here the
store is a device ring so "compaction" is just cursor arithmetic — no
copies.  This is the aggregation point for renderers/convolvers running at
different partition sizes (motivation comment, ref: .h:22-26).

Layer writes MIX into the buffer (scale-and-add, ref: WriteLayer .h:185-202
via MixSamples); reads can overwrite or mix into the destination
(ref: ReadBuffer .h:281-341).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["MultilayerBuffer"]


@jax.jit
def _mix_at(data: jax.Array, block: jax.Array, start, mul) -> jax.Array:
    L = data.shape[-1]
    idx = jnp.mod(start + jnp.arange(block.shape[-1]), L)
    return data.at[:, idx].add(mul * block.astype(data.dtype))


class MultilayerBuffer:
    """Fixed-capacity device ring + host-tracked layer cursors.

    ``capacity`` must cover the largest spread between the slowest and
    fastest producer (the reference grows dynamically, ref: ReserveSpace
    .h:160-167; here capacity is explicit — static shapes are the jit
    contract — and over-running it raises).
    """

    def __init__(self, nlayers: int, nchannels: int, capacity: int,
                 dtype=jnp.float32):
        self.nlayers = nlayers
        self.nchannels = nchannels
        self.capacity = int(capacity)
        self.data = jnp.zeros((nchannels, self.capacity), dtype)
        self.positions = np.zeros(nlayers, np.int64)  # absolute frames written
        self.base = 0  # absolute frame index of the ring's logical start

    # -- positions (ref: .h:227-250) ------------------------------------
    @property
    def min_position(self) -> int:
        """Frames complete across ALL layers — i.e. readable."""
        return int(self.positions.min())

    @property
    def max_position(self) -> int:
        return int(self.positions.max())

    def readable(self) -> int:
        return self.min_position - self.base

    # -- producer side ---------------------------------------------------
    def reserve_space(self, frames_in_flight: int) -> None:
        """Grow the ring so ``frames_in_flight`` frames fit
        (ref: ReserveSpace, src/MultilayerBuffer.h:160-167).  Doubles until
        sufficient; contents and cursors are preserved."""
        need = int(frames_in_flight)
        if need <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < need:
            new_cap *= 2
        old = np.asarray(self.data)
        data = np.zeros((self.nchannels, new_cap), old.dtype)
        # re-place live frames [base, max_position) at their new slots
        live = self.max_position - self.base
        if live > 0:
            src_idx = (self.base + np.arange(live)) % self.capacity
            dst_idx = (self.base + np.arange(live)) % new_cap
            data[:, dst_idx] = old[:, src_idx]
        self.capacity = new_cap
        self.data = jnp.asarray(data)

    def write_layer(self, layer: int, block: jax.Array, mul: float = 1.0) -> None:
        """Mix ``[C, B]`` frames at this layer's cursor and advance it
        (ref: WriteLayer + LayerWritten, .h:185-250).  Grows the ring when
        needed (host-side re-allocation, ref: ReserveSpace)."""
        B = block.shape[-1]
        pos = int(self.positions[layer])
        if pos + B - self.base > self.capacity:
            self.reserve_space(pos + B - self.base)
        self.data = _mix_at(
            self.data, block, jnp.asarray(pos % self.capacity), mul
        )
        self.positions[layer] = pos + B

    # -- consumer side ---------------------------------------------------
    def read(self, nframes: int, consume: bool = True) -> jax.Array:
        """Read up to ``nframes`` complete frames from the front; if
        ``consume``, the frames are released and their slots zeroed for
        reuse (the ring equivalent of the reference's shift-compact +
        zero-tail, ref: BufferRead .h:383-407)."""
        n = min(nframes, self.readable())
        idx = jnp.asarray(
            (self.base + np.arange(n)) % self.capacity, jnp.int32
        )
        out = self.data[:, idx]
        if consume and n:
            self.data = self.data.at[:, idx].set(0.0)
            self.base += n
        return out

    def read_into(self, dst: jax.Array, nframes: int, mix: bool = False,
                  mul: float = 1.0) -> jax.Array:
        """Overwrite-or-mix read into ``dst [C, nframes]``
        (ref: ReadBuffer overwrite/mix modes, .h:281-341)."""
        out = self.read(nframes)
        n = out.shape[-1]
        if mix:
            return dst.at[:, :n].add(mul * out)
        return dst.at[:, :n].set(mul * out)

    def reset(self) -> None:
        self.data = jnp.zeros_like(self.data)
        self.positions[:] = 0
        self.base = 0
