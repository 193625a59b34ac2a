"""Checkpoint / resume for streaming state pytrees.

The reference has no checkpointing; its deep-copy constructors merely show
WHAT constitutes resumable state per component (SURVEY.md §5): filter
w-registers, ring contents + cursors, interpolator controllers, convolver
spectral queues + crossfade phase.  In this framework all of that is
already explicit NamedTuple pytrees, so checkpointing is generic: any
state pytree round-trips through a plain pickle of host arrays.

Works for ConvolverState, BankState, ModalState, MeterState, Ring,
BinauralState, ... and arbitrary nests of them.

Spectral-layout portability: convolver spectral queues are stored in the
half-window engine's SPECTRAL LAYOUT of the backend that wrote them
(``convolve.fft.half_engine_layout`` — permuted for large dftmm block
sizes, standard elsewhere), and the two layouts have different bin counts
(e.g. 4104 vs 4097 at an 8192-point tail).  ``save_state`` therefore tags
checkpoints with the writer's layout metadata, and ``load_state(like=...)``
auto-converts spectral leaves between layouts when the target engine
resolves a different one (std->perm, perm->std, and perm(r1)->perm(r2)).
Conversion is exact: the permuted layout's extra bins are conjugate
mirrors, which are dropped going to std and reconstructed going to perm.

Structural portability: checkpoints written before a state NamedTuple
gained fields generally do not restore (leaf-count mismatch fails loudly).
One migration IS supported: ``BankState`` gained ``targets_lo``/
``origins_lo`` residual planes in round 2, and those planes are exactly
zero for any state the old format could represent (the lo planes carry
float32 residuals of float64 designs the old format never stored), so
``load_state(like=...)`` reconstructs old 5-leaf BankState checkpoints by
zero-filling them.  Other structure changes still fail loudly — re-save
from a current build.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

import jax

__all__ = ["save_state", "load_state"]

# 3: permuted spectral layout switched to the tile-aligned bin order
#    ("order 2" — fft.py layout derivation); format <= 2 perm leaves are
#    in the legacy order and are auto-reordered on load (power-of-two FFT
#    sizes; otherwise convert manually with fft.convert_perm_order).
# 4: the NON-UNIFORM engine's tail queue switched from assembled WINDOW
#    spectra to raw HALF-window spectra (the xt-slot layout — lets the
#    grouped render carry this group's transform output forward untouched
#    instead of writing Pt assembled windows back; nonuniform.py).
#    Format <= 3 NonUniformState blobs are converted on load: the window
#    recursion W(j) = t(j-1) + s t(j) inverts exactly (s = +-1 per bin,
#    anchored at t(step-1) = tail.prev, whose meaning is unchanged).
_FORMAT = 4


def _writer_meta() -> dict:
    """Layout metadata describing how spectral leaves were produced."""
    from ..convolve import fft

    return {
        "format": _FORMAT,
        "jax_backend": jax.default_backend(),
        "fft_backend": fft.default_backend(),
        "perm_layout_env": os.environ.get("BBCAT_DSP_PERM_LAYOUT", "auto"),
        "perm_radix_env": os.environ.get("BBCAT_DSP_PERM_RADIX", "8"),
        "perm_order": 2,
    }


def save_state(path: str, state) -> None:
    """Serialise a state pytree (device arrays -> host) to ``path``."""
    leaves, treedef = jax.tree.flatten(state)
    host_leaves = [np.asarray(leaf) for leaf in leaves]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fp:
        pickle.dump(
            {"treedef": treedef, "leaves": host_leaves,
             "meta": _writer_meta()},
            fp,
        )


def _candidate_radices(meta: dict | None) -> list[int]:
    """Radices to try when inferring the writer's permuted layout; the
    writer's env hint first, then every radix _perm_radix can select."""
    out = []
    if meta:
        try:
            out.append(int(meta.get("perm_radix_env", 8)))
        except (TypeError, ValueError):
            pass
    for r in (8, 16, 32, 4):
        if r not in out:
            out.append(r)
    return out


def _perm_n_from_bins(nbins: int, r: int) -> int | None:
    """Solve nbins == r * (n//r//2 + 1) for n; None if not integral."""
    if nbins % r:
        return None
    n1h1 = nbins // r
    return 2 * r * (n1h1 - 1)


def _try_layout_migration(got: np.ndarray, want: "np.ndarray",
                          meta: dict | None):
    """Convert a spectral plane leaf between half-window layouts, or
    return None when the shapes don't correspond to any layout pair.

    Spectral leaves are stacked re/im planes ``[2, ..., F]``; only the
    trailing (bin) axis may differ between source and target."""
    from ..convolve import fft

    if (got.ndim != want.ndim or got.ndim < 2
            or got.shape[0] != 2 or want.shape[0] != 2
            or got.shape[:-1] != want.shape[:-1]
            or got.shape[-1] == want.shape[-1]):
        return None
    Fs, Fd = got.shape[-1], want.shape[-1]
    z = got[0] + 1j * got[1]
    # perm bin order of the WRITER: format <= 2 blobs used the legacy
    # round-3 order; format >= 3 the tile-aligned order
    src_order = (meta or {}).get("perm_order", 1)

    def planes(c):
        return np.stack([c.real, c.imag]).astype(got.dtype)

    # perm -> std: target bins determine n directly.  All perm paths also
    # require n > _MAX_DIRECT — the permuted layout is never constructed
    # at direct-matmul sizes, so smaller solutions are false positives.
    n = 2 * (Fd - 1)
    for r in _candidate_radices(meta):
        if n > fft._MAX_DIRECT and _perm_n_from_bins(Fs, r) == n:
            try:
                return planes(fft.unpermute_half_spectrum(
                    z, n, radix=r, order=src_order))
            except ValueError:
                continue
    # std -> perm: source bins determine n; the TARGET radix is inferred
    # from the target bin count (NOT from the current env resolution — the
    # target engine may hold a frozen SpectralSpec the env no longer
    # matches)
    n = 2 * (Fs - 1)
    for r_dst in _candidate_radices(None):
        if n > fft._MAX_DIRECT and _perm_n_from_bins(Fd, r_dst) == n:
            return planes(fft.permute_half_spectrum(z, n, radix=r_dst))
    # perm(r_src) -> perm(r_dst): both radices inferred from bin counts
    for r_src in _candidate_radices(meta):
        n = _perm_n_from_bins(Fs, r_src)
        if not n or n <= fft._MAX_DIRECT:
            continue
        for r_dst in _candidate_radices(None):
            if r_dst == r_src or _perm_n_from_bins(Fd, r_dst) != n:
                continue
            try:
                std = fft.unpermute_half_spectrum(
                    z, n, radix=r_src, order=src_order)
            except ValueError:
                continue
            return planes(fft.permute_half_spectrum(std, n, radix=r_dst))
    return None


def _maybe_reorder_legacy_perm(got: np.ndarray, meta: dict | None):
    """Reorder a legacy-order (format <= 2) permuted spectral leaf to the
    tile-aligned order, in place of shape-identical restore.

    STRICT inference guards against touching non-spectral leaves: the leaf
    must look like stacked re/im planes (shape[0] == 2, ndim >= 3) whose
    bin count solves F = n/2 + r for a radix the layout can resolve at a
    POWER-OF-TWO n (every engine FFT size; e.g. a [2, C, 4096] pending
    buffer inverts to the non-power-of-two n = 8128 and is left alone)."""
    from ..convolve import fft

    order = (meta or {}).get("perm_order", 1)
    if order == 2:
        return None
    if got.ndim < 3 or got.shape[0] != 2:
        return None
    F = got.shape[-1]
    for r in _candidate_radices(meta):
        n = _perm_n_from_bins(F, r)
        # n must ALSO be a size the permuted layout can ever have been
        # written at (> _MAX_DIRECT): without that bound, small non-spectral
        # [2, .., F] leaves (ring/meter buffers) can solve F = n/2 + r at a
        # small power-of-two n and be silently scrambled.
        if (n and n & (n - 1) == 0 and n > fft._MAX_DIRECT
                and n % (2 * r) == 0
                and (n // r) % 2 == 0 and n // r <= 2048):
            import warnings

            warnings.warn(
                f"checkpoint leaf {got.shape} holds permuted spectra in "
                f"the legacy (round-3) bin order; auto-reordering to the "
                f"tile-aligned order (n={n}, radix={r})",
                RuntimeWarning, stacklevel=3)
            z = got[0] + 1j * got[1]
            z2 = fft.convert_perm_order(z, n, r, from_order=1, to_order=2)
            return np.stack([z2.real, z2.imag]).astype(got.dtype)
    return None


def _try_bankstate_migration(host_leaves: list, like):
    """Reconstruct a pre-round-2 (5-leaf) BankState from its leaves by
    zero-filling the ``targets_lo``/``origins_lo`` residual planes — which
    are exactly zero for any state the old format could represent.
    Returns the new-format leaf list, or None when the blob/target do not
    match that known structure change."""
    try:
        from ..filters.bank import BankState
    except Exception:  # pragma: no cover - filters always importable
        return None
    if not isinstance(like, BankState) or len(host_leaves) != 5:
        return None
    targets, origins, mul, dec, w = host_leaves
    want = jax.tree.leaves(like)
    old = [targets, origins, mul, dec, w]
    if any(np.asarray(g).shape != np.asarray(wnt).shape
           for g, wnt in zip(old, want[:5])):
        return None
    return old + [np.zeros_like(targets), np.zeros_like(origins)]


def _tail_signs(F: int, meta: dict | None) -> np.ndarray | None:
    """Shift-theorem sign vector for a tail spectral leaf with ``F`` bins,
    layout inferred from the bin count (std F is odd: n/2 + 1 with n a
    power of two; perm F is even: n/2 + r)."""
    from ..convolve import fft

    if F % 2:  # standard layout
        n = 2 * (F - 1)
        if n & (n - 1):
            return None
        return (1.0 - 2.0 * (np.arange(F) % 2)).astype(np.float32)
    for r in _candidate_radices(meta):
        n = _perm_n_from_bins(F, r)
        if (n and n & (n - 1) == 0 and n > fft._MAX_DIRECT
                and n % (2 * r) == 0 and (n // r) % 2 == 0
                and n // r <= 2048):
            sec = n // r // 2
            tail = r * sec
            f = np.arange(F)
            exp = np.where(f < tail, f // sec, f - tail)
            return (1.0 - 2.0 * (exp % 2)).astype(np.float32)
    return None


def _convert_tail_windows_to_xt(tail, meta: dict | None):
    """Format <= 3 -> 4: invert the tail queue's assembled windows back to
    raw half-window spectra (exact; see the _FORMAT note)."""
    W = np.asarray(tail.queue)
    prev = np.asarray(tail.prev)
    step = int(np.asarray(tail.step))
    _, Pt, _, F = W.shape
    s = _tail_signs(F, meta)
    if s is None:
        import warnings

        warnings.warn(
            f"cannot infer the spectral layout of a [.., {F}]-bin tail "
            "queue; leaving the leaf unconverted — re-save from a current "
            "build", RuntimeWarning, stacklevel=3)
        return tail
    order = (step + np.arange(Pt)) % Pt
    Wc = W[:, order]                       # chronological windows
    tc = [None] * Pt                       # tc[i] = t(step - Pt + i)
    tc[Pt - 1] = prev.astype(np.float64)
    for i in range(Pt - 1, 0, -1):
        tc[i - 1] = Wc[:, i].astype(np.float64) - s * tc[i]
    new_q = np.empty_like(W)
    for i in range(Pt):
        new_q[:, (step + i) % Pt] = tc[i].astype(W.dtype)
    return tail._replace(queue=jax.numpy.asarray(new_q))


def _migrate_nonuniform_v3(tree, meta: dict | None):
    """Walk a restored pytree converting every NonUniformState tail from
    the window-queue to the xt-slot layout (format <= 3 blobs)."""
    try:
        from ..convolve.nonuniform import NonUniformState
    except Exception:  # pragma: no cover - convolve always importable
        return tree

    def walk(node):
        if isinstance(node, NonUniformState):
            return node._replace(
                tail=_convert_tail_windows_to_xt(node.tail, meta))
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[walk(x) for x in node])
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(tree)


def load_state(path: str, like=None, migrate_layout: bool = True):
    """Restore a state pytree saved with :func:`save_state`.

    If ``like`` is given, its treedef is used (robust against pickle-ing of
    treedefs across versions) and leaf dtypes/shapes are validated.  When
    ``migrate_layout`` (default), spectral leaves whose bin count differs
    from the target because writer and reader resolve different half-window
    spectral layouts are converted automatically (see module docstring).
    """
    with open(path, "rb") as fp:
        blob = pickle.load(fp)
    meta = blob.get("meta")
    host_leaves = [np.asarray(leaf) for leaf in blob["leaves"]]
    if like is not None:
        ref_leaves, treedef = jax.tree.flatten(like)
        if len(ref_leaves) != len(host_leaves):
            migrated = _try_bankstate_migration(host_leaves, like)
            if migrated is None:
                raise ValueError(
                    f"checkpoint has {len(host_leaves)} leaves, expected "
                    f"{len(ref_leaves)} — the state structure changed since "
                    "this checkpoint was written (see the portability note "
                    "in utils/checkpoint.py)"
                )
            host_leaves = migrated
        out = []
        for got, want in zip(host_leaves, ref_leaves):
            want_np = np.asarray(want)
            if got.shape != want_np.shape:
                conv = (_try_layout_migration(got, want_np, meta)
                        if migrate_layout else None)
                if conv is None:
                    raise ValueError(
                        f"leaf shape mismatch: {got.shape} vs "
                        f"{want_np.shape} (not a spectral-layout "
                        "difference; re-save from the target backend)"
                    )
                got = conv
            elif migrate_layout:
                conv = _maybe_reorder_legacy_perm(got, meta)
                if conv is not None:
                    got = conv
            out.append(jax.numpy.asarray(got))
        tree = jax.tree.unflatten(treedef, out)
        if migrate_layout and (meta or {}).get("format", 1) < 4:
            tree = _migrate_nonuniform_v3(tree, meta)
        return tree
    tree = jax.tree.unflatten(
        blob["treedef"], [jax.numpy.asarray(x) for x in host_leaves]
    )
    if migrate_layout and (meta or {}).get("format", 1) < 4:
        tree = _migrate_nonuniform_v3(tree, meta)
    return tree
