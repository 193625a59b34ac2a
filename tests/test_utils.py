"""Checkpoint/resume + profiling utilities."""

import numpy as np
import jax.numpy as jnp

from bbcat_dsp_tpu.convolve import BlockConvolver
from bbcat_dsp_tpu.utils import Timer, load_state, save_state


def test_checkpoint_resume_convolver(tmp_path, rng):
    """Saving mid-stream and resuming in a NEW convolver continues the
    stream bit-exactly (SURVEY.md §5 checkpoint)."""
    B, N, T = 64, 256, 64 * 8
    ir = rng.standard_normal(N) * 0.3
    x = rng.standard_normal((1, T)).astype(np.float32)

    ref = BlockConvolver(ir, block=B)
    y_ref = [np.asarray(ref.process_block(jnp.asarray(x[:, i*B:(i+1)*B])))
             for i in range(8)]

    a = BlockConvolver(ir, block=B)
    for i in range(4):
        a.process_block(jnp.asarray(x[:, i*B:(i+1)*B]))
    p = str(tmp_path / "conv.ckpt")
    save_state(p, a.state)

    b = BlockConvolver(ir, block=B)
    b.state = load_state(p, like=b.state)
    for i in range(4, 8):
        y = np.asarray(b.process_block(jnp.asarray(x[:, i*B:(i+1)*B])))
        np.testing.assert_array_equal(y, y_ref[i])


def test_timer():
    t = Timer()
    out, per = t.time(lambda v: v * 2, jnp.ones(16), iters=3)
    assert per >= 0.0 and np.asarray(out).shape == (16,)


def test_checkpoint_format4_tail_xt_migration(tmp_path, rng):
    """Format <= 3 NonUniformState checkpoints (tail queue = assembled
    WINDOW spectra) auto-convert to the format-4 xt-slot layout on load,
    exactly, and the restored stream continues bit-identically."""
    import pickle

    from bbcat_dsp_tpu.convolve import NonUniformConvolver
    from bbcat_dsp_tpu.convolve.fft import half_window_signs

    C, B, ratio = 4, 32, 2
    B2 = B * ratio
    N = 2 * ratio * B + 3 * B2
    ir = rng.standard_normal((C, N)) * 0.3
    T = 7 * B2
    x = rng.standard_normal((C, T)).astype(np.float32)

    # run a non-group-aligned number of supers so step % Pt != 0
    a = NonUniformConvolver(ir, block=B, ratio=ratio)
    for i in range(7):
        a.process_block(jnp.asarray(x[:, i * B2:(i + 1) * B2]))
    st = a.state
    Pt = a.tail_parts
    step = int(np.asarray(st.tail.step))
    assert step % Pt != 0

    # hand-build the OLD-format blob: re-encode the xt-slot queue as the
    # assembled-window queue formats <= 3 stored.  The oldest window needs
    # t(step-Pt-1), which the new state no longer holds — any value works
    # (the migration recursion never reads the oldest window), zeros here.
    s = np.asarray(half_window_signs(2 * B2, spec=a.spec_tail))
    q_xt = np.asarray(st.tail.queue)
    order = (step + np.arange(Pt)) % Pt
    tc = q_xt[:, order]                          # chronological halves
    tseq = np.concatenate([np.zeros_like(tc[:, :1]), tc], axis=1)
    Wc = tseq[:, :-1] + s * tseq[:, 1:]          # W(step-Pt) .. W(step-1)
    W_slots = np.empty_like(q_xt)
    W_slots[:, order] = Wc
    old_leaves = [np.asarray(leaf) for leaf in
                  __import__("jax").tree.leaves(st)]
    # replace the tail queue leaf (index: find by shape identity)
    replaced = False
    for i, leaf in enumerate(old_leaves):
        if leaf.shape == q_xt.shape and np.array_equal(leaf, q_xt):
            old_leaves[i] = W_slots
            replaced = True
            break
    assert replaced
    p = str(tmp_path / "old_nonuniform.ckpt")
    import jax

    with open(p, "wb") as fp:
        pickle.dump({"treedef": jax.tree.flatten(st)[1],
                     "leaves": old_leaves,
                     "meta": {"format": 3, "perm_order": 2}}, fp)

    b = NonUniformConvolver(ir, block=B, ratio=ratio)
    b.state = load_state(p, like=b.state)
    b._tail_steps = a._tail_steps
    # queue recovered up to f32 rounding of the +-1 sign arithmetic
    np.testing.assert_allclose(np.asarray(b.state.tail.queue), q_xt,
                               atol=1e-5)
    # stream continues identically to the uninterrupted engine
    for i in range(7, 9):
        xa = jnp.asarray(rng.standard_normal((C, B2)).astype(np.float32))
        ya = np.asarray(a.process_block(xa))
        yb = np.asarray(b.process_block(xa))
        np.testing.assert_allclose(yb, ya, atol=1e-5)


def test_checkpoint_format4_perm_tail_migration(tmp_path, rng):
    """The format-4 window->xt migration must also invert PERM-layout
    tails (sign inference from the even bin count: F = n/2 + r)."""
    import pickle

    import jax

    from bbcat_dsp_tpu.convolve import NonUniformConvolver
    from bbcat_dsp_tpu.convolve.fft import (
        half_window_signs,
        resolve_spectral_spec,
    )

    C, B, ratio = 4, 256, 8
    B2 = B * ratio                       # 2*B2 = 4096 -> perm under dftmm
    sh = resolve_spectral_spec(2 * B, backend="dftmm", probe=False)
    st = resolve_spectral_spec(2 * B2, backend="dftmm", probe=False,
                               layout="perm")
    assert st.layout == "perm"
    N = 2 * ratio * B + 2 * B2
    ir = rng.standard_normal((C, N)) * 0.3
    a = NonUniformConvolver(ir, block=B, ratio=ratio, spectral=(sh, st))
    x = rng.standard_normal((C, 3 * B2)).astype(np.float32)
    for i in range(3):
        a.process_block(jnp.asarray(x[:, i * B2:(i + 1) * B2]))
    stt = a.state
    Pt = a.tail_parts
    step = int(np.asarray(stt.tail.step))

    s = np.asarray(half_window_signs(2 * B2, spec=st))
    q_xt = np.asarray(stt.tail.queue)
    assert q_xt.shape[-1] % 2 == 0       # perm layout: even bin count
    order = (step + np.arange(Pt)) % Pt
    tc = q_xt[:, order]
    tseq = np.concatenate([np.zeros_like(tc[:, :1]), tc], axis=1)
    Wc = tseq[:, :-1] + s * tseq[:, 1:]
    W_slots = np.empty_like(q_xt)
    W_slots[:, order] = Wc
    leaves = [np.asarray(leaf) for leaf in jax.tree.leaves(stt)]
    for i, leaf in enumerate(leaves):
        if leaf.shape == q_xt.shape and np.array_equal(leaf, q_xt):
            leaves[i] = W_slots
            break
    p = str(tmp_path / "old_perm_nonuniform.ckpt")
    with open(p, "wb") as fp:
        pickle.dump({"treedef": jax.tree.flatten(stt)[1],
                     "leaves": leaves,
                     "meta": {"format": 3, "perm_order": 2,
                              "perm_radix_env": str(st.radix)}}, fp)

    b = NonUniformConvolver(ir, block=B, ratio=ratio, spectral=(sh, st))
    b.state = load_state(p, like=b.state)
    np.testing.assert_allclose(np.asarray(b.state.tail.queue), q_xt,
                               rtol=0, atol=1e-4)


def test_checkpoint_layout_migration_roundtrip(tmp_path, rng):
    """A checkpoint written under the PERMUTED spectral
    layout (dftmm at large block sizes) restores onto a STANDARD
    layout engine — and vice versa — with the spectral queues converted
    automatically; the resumed stream stays correct (>=90 dB vs scipy)."""
    import jax
    from scipy.signal import fftconvolve

    import bbcat_dsp_tpu.convolve.fft as fftmod

    def snr_db(ref, got):
        ref = np.asarray(ref, np.float64)
        err = np.sum((ref - np.asarray(got, np.float64)) ** 2)
        return np.inf if err == 0 else 10 * np.log10(np.sum(ref**2) / err)

    B = 2048  # 2*B = 4096 -> perm layout under dftmm
    ir = (rng.standard_normal(3 * B) * 0.3).astype(np.float64)
    x = rng.standard_normal(8 * B).astype(np.float32)
    exp = fftconvolve(x.astype(np.float64), ir)[: 8 * B]

    orig = fftmod.default_backend
    p1 = str(tmp_path / "perm.ckpt")
    p2 = str(tmp_path / "std.ckpt")

    # --- write under perm (forced dftmm), first half of the stream ---
    fftmod.default_backend = lambda: "dftmm"
    jax.clear_caches()
    try:
        a = BlockConvolver(ir, block=B)
        assert a.state.queue.shape[-1] == fftmod.spectral_nbins(2 * B)
        y1 = np.concatenate(
            [np.asarray(a.process_block(jnp.asarray(x[k*B:(k+1)*B])))
             for k in range(4)])
        save_state(p1, a.state)
    finally:
        fftmod.default_backend = orig
        jax.clear_caches()

    # --- restore onto a std-layout engine (xla on CPU), second half ---
    b = BlockConvolver(ir, block=B)
    assert b.state.queue.shape[-1] == 2 * B // 2 + 1
    b.state = load_state(p1, like=b.state)
    y2 = np.concatenate(
        [np.asarray(b.process_block(jnp.asarray(x[k*B:(k+1)*B])))
         for k in range(4, 6)])
    assert snr_db(exp[: 6 * B], np.concatenate([y1, y2])) > 90.0

    # --- and back: std checkpoint onto a perm engine, final quarter ---
    save_state(p2, b.state)
    fftmod.default_backend = lambda: "dftmm"
    jax.clear_caches()
    try:
        c = BlockConvolver(ir, block=B)
        c.state = load_state(p2, like=c.state)
        assert c.state.queue.shape[-1] == fftmod.spectral_nbins(2 * B)
        y3 = np.concatenate(
            [np.asarray(c.process_block(jnp.asarray(x[k*B:(k+1)*B])))
             for k in range(6, 8)])
    finally:
        fftmod.default_backend = orig
        jax.clear_caches()
    got = np.concatenate([y1, y2, y3])
    assert snr_db(exp, got) > 90.0


def test_checkpoint_non_spectral_mismatch_still_fails(tmp_path, rng):
    """Shape mismatches that are NOT a layout difference still fail loudly."""
    import pytest

    from bbcat_dsp_tpu.buffers.ring import ring_init

    a = ring_init((2,), 8)
    p = str(tmp_path / "ring.ckpt")
    save_state(p, a)
    b = ring_init((2,), 16)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_state(p, like=b)


def test_checkpoint_bankstate_zero_fill_migration(tmp_path, rng):
    """A hand-built pre-round-2 BankState checkpoint (5
    leaves — no targets_lo/origins_lo residual planes) restores via
    load_state(like=...) with the lo planes zero-filled, and the restored
    bank continues processing identically to one whose residuals are
    explicitly zero."""
    import pickle

    import jax

    from bbcat_dsp_tpu.filters import FilterType, biquad_coeffs
    from bbcat_dsp_tpu.filters.bank import (
        BankState,
        bank_init,
        bank_process,
        bank_set_stage,
    )

    S, C = 2, 4
    state = bank_init(S, C)
    state = bank_set_stage(state, 0,
                           biquad_coeffs(FilterType.LPF12, 2000.0, 48000.0),
                           interp_samples=64)
    state = bank_set_stage(state, 1,
                           biquad_coeffs(FilterType.PEQ, 500.0, 48000.0, 3.0))
    x = rng.standard_normal((C, 128)).astype(np.float32)
    state, y0 = bank_process(state, x)

    # hand-build the OLD-format blob: the same state WITHOUT the lo planes
    # (any state the old format could represent has them exactly zero)
    state = state._replace(targets_lo=jnp.zeros_like(state.targets_lo),
                           origins_lo=jnp.zeros_like(state.origins_lo))
    old_leaves = [np.asarray(a) for a in
                  (state.targets, state.origins, state.mul, state.dec,
                   state.w)]
    p = str(tmp_path / "bank_old.ckpt")
    with open(p, "wb") as fp:
        pickle.dump({"treedef": jax.tree.structure(tuple(old_leaves)),
                     "leaves": old_leaves,
                     "meta": {"format": 1}}, fp)

    restored = load_state(p, like=bank_init(S, C))
    assert isinstance(restored, BankState)
    np.testing.assert_array_equal(np.asarray(restored.targets_lo), 0.0)
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    # continuation identical
    x2 = rng.standard_normal((C, 128)).astype(np.float32)
    _, y_ref = bank_process(state, x2)
    _, y_got = bank_process(restored, x2)
    np.testing.assert_array_equal(np.asarray(y_ref), np.asarray(y_got))

    # an UNRELATED structure change still fails loudly
    with open(p, "rb") as fp:
        blob = pickle.load(fp)
    blob["leaves"] = blob["leaves"][:4]
    p2 = str(tmp_path / "bank_bad.ckpt")
    with open(p2, "wb") as fp:
        pickle.dump(blob, fp)
    try:
        load_state(p2, like=bank_init(S, C))
        raise AssertionError("4-leaf blob restored silently")
    except ValueError as e:
        assert "structure changed" in str(e)


def test_legacy_perm_reorder_leaves_small_nonspectral_leaves_alone():
    """Code-review r4: a [2, C, F] NON-spectral leaf whose bin count
    happens to solve F = n/2 + r at a small power-of-two n (perm never
    existed at n <= 2048) must restore bit-identical, not be 'reordered'."""
    import numpy as np

    from bbcat_dsp_tpu.utils.checkpoint import _maybe_reorder_legacy_perm

    # F=264 -> n=512 (r=8); F=16 -> n=16 (r=8): both below _MAX_DIRECT
    for shape in ((2, 4, 264), (2, 3, 16)):
        leaf = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        assert _maybe_reorder_legacy_perm(leaf, {"perm_order": 1}) is None
    # a REAL legacy perm spectral shape still reorders (n=8192, radix 16:
    # F = 16 * (512/2 + 1) = 4112)
    leaf = np.random.default_rng(0).standard_normal(
        (2, 4, 4112)).astype(np.float32)
    out = _maybe_reorder_legacy_perm(leaf, {"perm_order": 1})
    assert out is not None and out.shape == leaf.shape
