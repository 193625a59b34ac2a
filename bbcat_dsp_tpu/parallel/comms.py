"""Communication accounting + scaling model for the sharded render paths.

The reference has no distributed axis at all (SURVEY.md §2.3); the sharding
layer is new, so its scaling claims need a MODEL, not an appeal to
structure.  This module makes the communication of every sharded path in
``parallel/convolve.py`` explicit and deterministic from shapes:

* ``channel_sharded_*`` — zero collective bytes (channels independent);
  the only multi-device cost is the optional per-render loudness ``psum``
  (scalar) and input delivery.
* ``time_sharded_render`` — one ``ppermute`` of the overlap-save halo
  (``C_local * nparts * block`` float32 samples) per render per device.
* ``sharded_integrated_loudness`` — one scalar-vector ``psum`` per render.

The latency/bandwidth environment is parameterised (``CommEnv``): defaults
are published figures for NVLink between the cards of one H100 host and
data-center ethernet between hosts — override with measured values when
available.

``scaling_efficiency`` and :func:`config5_scaling_table` turn a MEASURED
single-card real-time factor into a projected N-card efficiency.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "CommEnv",
    "allreduce_bytes",
    "halo_bytes",
    "collective_seconds",
    "scaling_efficiency",
    "config5_scaling_table",
    "time_sharded_efficiency",
]


@dataclass(frozen=True)
class CommEnv:
    """Link parameters for the collective-time model.

    Provenance of each default (none of them measured):

    * ``link_bw`` — PUBLISHED: NVLink between the cards of one H100 host,
      450 GB/s each way per card (NVIDIA H100 data sheet, 900 GB/s
      bidirectional).  ``link_lat`` — ASSUMED: ~1 us per hop.
    * ``dcn_bw`` / ``dcn_lat`` — ASSUMED: 25 Gbps per-host data-center
      ethernet, ~25 us.

    The model is linear in all of them, so refitting to measured values
    rescales, never reshapes, the story.
    """

    link_bw: float = 4.5e11  # bytes/s per card, per direction (published)
    link_lat: float = 1e-6   # seconds per hop (assumed)
    dcn_bw: float = 3.125e9  # bytes/s per host, 25 Gbps (assumed)
    dcn_lat: float = 25e-6   # seconds per hop (assumed)


def allreduce_bytes(payload: int, n_devices: int) -> int:
    """Per-device bytes moved by a ring all-reduce (``psum``) of
    ``payload`` bytes over ``n_devices``: reduce-scatter + all-gather,
    ``2 * (N-1)/N * payload`` each way."""
    if n_devices <= 1:
        return 0
    return int(2 * (n_devices - 1) * payload / n_devices)


def halo_bytes(c_local: int, nparts: int, block: int,
               dtype_bytes: int = 4) -> int:
    """Per-device bytes ``ppermute``d by :func:`time_sharded_render`'s
    halo exchange: each device SENDS its trailing ``nparts * block``
    samples of every local channel to its right neighbour (and receives
    the same from its left)."""
    return int(c_local * nparts * block * dtype_bytes)


def collective_seconds(nbytes: int, env: CommEnv, hops_dcn: int = 0,
                       hops_link: int = 1) -> float:
    """Model time for moving ``nbytes`` per device: bandwidth term on the
    slowest traversed link class plus per-hop latencies."""
    t = hops_link * env.link_lat + hops_dcn * env.dcn_lat
    if hops_dcn:
        t += nbytes / env.dcn_bw
    elif hops_link:
        t += nbytes / env.link_bw
    return t


def scaling_efficiency(compute_seconds: float, comm_seconds: float) -> float:
    """Weak-scaling efficiency when per-device compute stays constant and
    communication is NOT overlapped: t_actual = t_comp + t_comm."""
    return compute_seconds / (compute_seconds + comm_seconds)


def config5_scaling_table(
    rtf_1chip: float,
    n_chips_list: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64),
    audio_seconds: float = 1.0,
    channels: int = 1024,
    env: CommEnv | None = None,
    chips_per_host: int = 8,
    loudness_psum: bool = True,
    fs: float = 48000.0,
) -> list[dict]:
    """Scaling projection for BASELINE config #5 (1024 ch x 64k taps),
    channel-sharded (``channel_sharded_nonuniform_render``).

    Per-chip compute time for a ``C/N``-channel shard of ``audio_seconds``
    of signal is ``audio_seconds / rtf_1chip / N`` (the engine is linear in
    channels; ``rtf_1chip`` is the MEASURED 1-chip, 1024-channel value).

    Two separate concerns are reported separately:

    * ``efficiency`` — SCALING degradation from collectives only: the
      render itself is communication-free; the only collective is an
      optional scalar loudness ``psum`` per render, over NVLink within a
      host and one DCN hop across hosts.
    * ``input_bound_rtf`` — the throughput CEILING a host's DCN link
      imposes when the input audio arrives from a remote source
      (pipelined/double-buffered, so it overlaps compute entirely until
      it saturates): per host, ``min(n, chips_per_host) * C_local``
      channels x fs x 4 bytes per audio-second through ``dcn_bw``.
      Locally-sourced input (files, generators) has no such ceiling.
    """
    env = env or CommEnv()
    rows = []
    for n in n_chips_list:
        t_comp = audio_seconds / rtf_1chip / n
        comm = 0.0
        if loudness_psum and n > 1:
            hops_dcn = 1 if n > chips_per_host else 0
            comm += collective_seconds(
                allreduce_bytes(4, n), env, hops_dcn=hops_dcn)
        eff = scaling_efficiency(t_comp, comm)
        c_local = channels / n
        per_host_in = (c_local * min(n, chips_per_host)
                       * audio_seconds * fs * 4)
        rows.append({
            "chips": n,
            "hosts": max(1, -(-n // chips_per_host)),
            "per_chip_compute_s": t_comp,
            "comm_s": comm,
            "efficiency": eff,
            "aggregate_rtf": rtf_1chip * n * eff,
            "input_bound_rtf": env.dcn_bw / per_host_in * audio_seconds,
        })
    return rows


def time_sharded_efficiency(
    rtf_1chip: float,
    span_seconds: float,
    c_local: int,
    nparts: int,
    block: int,
    n_devices: int,
    env: CommEnv | None = None,
    hops_dcn: int = 0,
) -> dict:
    """Efficiency of :func:`time_sharded_render` at a given span length:
    halo ``ppermute`` bytes vs per-span compute.  The halo is one exchange
    per RENDER (not per block), so efficiency -> 1 as spans grow."""
    env = env or CommEnv()
    t_comp = span_seconds / rtf_1chip
    nbytes = halo_bytes(c_local, nparts, block)
    t_comm = collective_seconds(nbytes, env, hops_dcn=hops_dcn)
    return {
        "halo_bytes": nbytes,
        "compute_s": t_comp,
        "comm_s": t_comm,
        "efficiency": scaling_efficiency(t_comp, t_comm),
        "devices": n_devices,
    }
