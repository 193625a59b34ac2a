"""Multichannel delay / ring buffers with sample-format edges.

Batched-array redesign of SoundDelayBuffer / SoundRingBuffer
(ref: src/SoundDelayBuffer.h:8,105 and src/SoundDelayBuffer.cpp): the
reference stores raw interleaved bytes of arbitrary format and converts on
every access; here the canonical store is a float32 ``[C, L]`` device ring
(channel-major) and sample formats exist only at the host I/O edge
(SURVEY.md §7 design stance).  API parity:

* ``SoundDelayBuffer`` — write at a cursor, read ``delay`` frames behind it
  (multi-tap safe: reads never consume).
* ``SoundRingBuffer`` — adds an independent read cursor with FIFO
  availability clamps using the reference's modular arithmetic
  (``read avail = (w - r) mod L``, ``write avail = (r - w - 1) mod L``,
  ref: src/SoundDelayBuffer.h:124-125).
* ``set_size`` preserves contents across resize
  (ref: SoundDelayBuffer::SetSize, src/SoundDelayBuffer.cpp:26-61).

Host-edge packed-byte I/O (``write_packed`` / ``read_packed``) funnels
through :mod:`bbcat_dsp_tpu.formats.host` exactly like the reference's
TransferSamples plumbing (SURVEY.md §3.2).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..formats.host import transfer_samples
from ..formats.sample_format import SampleFormat, get_bytes_per_sample
from .ring import Ring, ring_init, ring_write

__all__ = ["SoundDelayBuffer", "SoundRingBuffer"]


class SoundDelayBuffer:
    """Delay line: single write cursor, delayed reads (never consuming)."""

    def __init__(self, nchannels: int, length: int, dtype=jnp.float32):
        self.nchannels = nchannels
        self.length = int(length)
        self.ring = ring_init((nchannels,), self.length, dtype)

    # -- positions -------------------------------------------------------
    @property
    def write_position(self) -> int:
        return int(self.ring.writepos)

    def set_size(self, length: int) -> None:
        """Resize, preserving the most recent contents
        (ref: src/SoundDelayBuffer.cpp:26-61)."""
        keep = min(self.length, int(length))
        w = int(self.ring.writepos)
        idx = (w - keep + np.arange(keep)) % self.length
        old = np.asarray(self.ring.data)[:, idx]
        # re-place the kept samples so each remains `delay` frames behind
        # the (unchanged) cursor in the new ring
        data = np.zeros((self.nchannels, int(length)), old.dtype)
        nidx = (w - keep + np.arange(keep)) % int(length)
        data[:, nidx] = old
        self.length = int(length)
        self.ring = Ring(jnp.asarray(data), jnp.asarray(w, jnp.int32))

    # -- device-native I/O ----------------------------------------------
    def write(self, block: jax.Array) -> None:
        """Append ``[C, B]`` frames at the write cursor."""
        self.ring = ring_write(self.ring, block)

    def read(self, delay: int, nframes: int) -> jax.Array:
        """Read ``nframes`` frames starting ``delay`` frames back from the
        write cursor, clamped ``nframes <= delay`` like the reference
        (ref: src/SoundDelayBuffer.cpp:134-170)."""
        nframes = min(nframes, delay)
        idx = jnp.mod(
            self.ring.writepos - delay + jnp.arange(nframes), self.length
        )
        return self.ring.data[:, idx]

    def read_sample(self, channel: int, delay: int) -> float:
        """Single delayed sample (ref: ReadSample,
        src/SoundDelayBuffer.cpp:176-191)."""
        idx = jnp.mod(self.ring.writepos - delay, self.length)
        return float(self.ring.data[channel, idx])

    # -- host packed-byte edges -----------------------------------------
    def write_packed(
        self, raw: np.ndarray, fmt: SampleFormat, big_endian: bool,
        src_channel: int, nchannels: int, nframes: int,
    ) -> None:
        """Interleaved packed bytes -> a channel window at the cursor
        (ref: WriteSamples, src/SoundDelayBuffer.cpp:77-116)."""
        nch = min(nchannels, self.nchannels)
        flt = np.zeros(nframes * nch * 4, np.uint8)
        transfer_samples(
            np.asarray(raw), fmt, big_endian, src_channel, nchannels,
            flt, SampleFormat.FLOAT, False, 0, nch, nch, nframes,
        )
        frames = flt.view(np.float32).reshape(nframes, nch).T
        block = np.zeros((self.nchannels, nframes), np.float32)
        block[:nch] = frames
        self.write(jnp.asarray(block))

    def read_packed(
        self, fmt: SampleFormat, big_endian: bool, delay: int, nframes: int,
    ) -> np.ndarray:
        """Delayed frames -> interleaved packed bytes."""
        frames = np.asarray(self.read(delay, nframes)).T.copy()  # [n, C]
        out = np.zeros(
            frames.size * get_bytes_per_sample(fmt), np.uint8
        )
        transfer_samples(
            frames.astype(np.float32).view(np.uint8).reshape(-1),
            SampleFormat.FLOAT, False, 0, self.nchannels,
            out, fmt, big_endian, 0, self.nchannels,
            self.nchannels, frames.shape[0],
        )
        return out


class SoundRingBuffer(SoundDelayBuffer):
    """FIFO semantics: independent read cursor + availability clamps
    (ref: src/SoundDelayBuffer.h:105-180, src/SoundDelayBuffer.cpp:234-304).
    """

    def __init__(self, nchannels: int, length: int, dtype=jnp.float32):
        super().__init__(nchannels, length, dtype)
        self.readpos = 0

    def read_frames_available(self) -> int:
        """(w - r) mod L (ref: src/SoundDelayBuffer.h:124)."""
        return (int(self.ring.writepos) - self.readpos) % self.length

    def write_frames_available(self) -> int:
        """(r - w - 1) mod L (ref: src/SoundDelayBuffer.h:125)."""
        return (self.readpos - int(self.ring.writepos) - 1) % self.length

    def write(self, block: jax.Array) -> int:
        """Write clamped to availability; returns frames written."""
        n = min(block.shape[-1], self.write_frames_available())
        if n:
            super().write(block[..., :n])
        return n

    def read(self, nframes: int) -> jax.Array:
        """Consume up to ``nframes`` from the read cursor; returns
        ``[C, n]`` (n possibly < nframes)."""
        n = min(nframes, self.read_frames_available())
        idx = (self.readpos + np.arange(n)) % self.length
        out = self.ring.data[:, jnp.asarray(idx, jnp.int32)] if n else (
            self.ring.data[:, :0]
        )
        self.readpos = (self.readpos + n) % self.length
        return out

    def increment_read_position(self, n: int) -> int:
        n = min(n, self.read_frames_available())
        self.readpos = (self.readpos + n) % self.length
        return n

    def increment_write_position(self, n: int) -> int:
        """Advance write cursor over pre-written/zero frames, clamped."""
        n = min(n, self.write_frames_available())
        self.ring = Ring(self.ring.data, self.ring.writepos + n)
        return n

    def reset_positions(self) -> None:
        self.ring = Ring(self.ring.data, jnp.zeros((), jnp.int32))
        self.readpos = 0
