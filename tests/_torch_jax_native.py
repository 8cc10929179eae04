"""The JAX package's native codec (``cylon_tpu.native``) in the port's test
processes: the reference that the port's CSV reader and writer, its pool,
its string hash and its dictionary merge are held against byte for byte.

In a fresh checkout the library is not built yet, and the JAX loader builds
it into one shared ``<library>.tmp`` path: pytest-xdist workers that build
at the same time can move one another's half-written file, and a loser's
``os.replace`` then raises ``FileNotFoundError``, which the loader latches
as "no library" for the life of the process (its pure-Python routes are
not the reference). Every port test module that compares with the codec
calls :func:`load_jax_native` at import, so each worker loads the library
before its first test, one first build at a time; a test calls
:func:`require_jax_native` before it compares, and fails with the cause
when the reference is missing, never as a byte mismatch.
"""
from __future__ import annotations

import os
from pathlib import Path

#: why the JAX reference's native codec is missing in this process, or None
#: while it loads (set by :func:`load_jax_native`)
JAX_NATIVE_WHY: list = []


def load_jax_native() -> bool:
    """Load the JAX package's native codec (``cylon_tpu.native``) once per
    test process, under an exclusive ``flock`` on ``build/jax_native.lock``
    in the repository, so the first builds of several pytest-xdist workers
    in a fresh checkout run one after another and never share the
    loader's one ``.tmp`` output path. The loader latches a failure for the
    life of the process (``_load_failed``): when it reports no library,
    the cause is read from ``_so_path()`` and a direct ``_build()``, the
    latch is reset in this process's imported module, and the load is tried
    once more under the lock. Returns whether the library is loaded; the
    reason it is not stays in :data:`JAX_NATIVE_WHY`. Only the test
    processes call this (the ranks never import the JAX package)."""
    import fcntl

    from cylon_tpu import native as jnative

    if jnative.get_lib_if_loaded() is not None:
        return True
    lock_dir = Path(__file__).resolve().parent.parent / "build"
    lock_dir.mkdir(exist_ok=True)
    with open(lock_dir / "jax_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if jnative.get_lib() is not None:
            return True
        why = []
        try:
            so = jnative._so_path()
            why.append(f"library {so} exists={os.path.exists(so)}")
            if not os.path.exists(so):
                why.append(f"direct build returned {jnative._build(so)}")
        except Exception as e:  # noqa: BLE001 - the diagnosis is the point
            why.append(f"{type(e).__name__}: {e}")
        jnative._load_failed = False  # the retry: this process's latch only
        if jnative.get_lib() is not None:
            return True
        JAX_NATIVE_WHY[:] = why
        return False


def require_jax_native() -> None:
    """Fail a test that compares the port with the JAX package's native
    reader or writer when that codec is not loaded: without it the JAX
    package takes its pure-Python routes, which are not the reference."""
    from cylon_tpu import native as jnative

    assert jnative.available(), (
        "the JAX reference's native codec (cylon_tpu.native) is unavailable in this "
        f"process, so there is no reference to compare with: {JAX_NATIVE_WHY or 'not loaded'}")
