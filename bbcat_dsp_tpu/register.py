"""Library registration / version observability.

Batched-array equivalent of the reference's L4 lifecycle layer
(ref: src/register.cpp:10-28, src/register.h:8): an idempotent ``register()``
that records this library's version in a process-wide registry, chaining to
dependency registration (here: jax/numpy versions).  The reference used a
static-initialisation trick to defeat linker dead-stripping; in Python the
equivalent is simply calling ``register()`` at package import.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_versions: dict[str, str] = {}
_registered = False


def loaded_versions() -> dict[str, str]:
    """Return the registry of loaded component versions.

    Equivalent of bbcat-base's ``LoadedVersions`` singleton that the reference
    registers into (ref: src/register.cpp:21).
    """
    with _lock:
        return dict(_versions)


def register() -> bool:
    """Idempotently register this library and its dependencies.

    Returns True (matching the reference's signature, src/register.h:8).
    """
    global _registered
    with _lock:
        if _registered:
            return True
        from . import __version__

        _versions["bbcat_dsp_tpu"] = __version__
        try:
            import jax

            _versions["jax"] = jax.__version__
        except Exception:  # pragma: no cover
            pass
        try:
            import numpy

            _versions["numpy"] = numpy.__version__
        except Exception:  # pragma: no cover
            pass
        _registered = True
        return True
