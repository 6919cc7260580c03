"""Concurrency debug helpers backing the ``# guarded by:`` comments
(the port's own copy of `deeplearning4j_tpu/util/concurrency.py`).

`assert_owned` is the runtime half of those comments: ``*_locked``
methods and externally synchronized classes, where the CALLER promises
to hold the lock, call it at the top. Under tests (or with
``DL4J_TPU_CONCURRENCY_ASSERTS=1``) a broken promise raises instead of
corrupting state silently. In production the check is a no-op.
"""
from __future__ import annotations

import os

__all__ = ["assert_owned", "asserts_enabled"]


def asserts_enabled() -> bool:
    """True when ownership assertions should run: under pytest (it
    exports ``PYTEST_CURRENT_TEST`` per test) or when explicitly armed
    via ``DL4J_TPU_CONCURRENCY_ASSERTS``."""
    return ("PYTEST_CURRENT_TEST" in os.environ
            or bool(os.environ.get("DL4J_TPU_CONCURRENCY_ASSERTS")))


def assert_owned(lock, what: str = "shared state") -> None:
    """Assert the calling thread holds `lock`.

    No-op when `lock` is None (an externally-synchronized object whose
    guard was never bound) or when assertions are disabled. Uses the
    lock's ``_is_owned()`` when available (Condition/RLock — a true
    per-thread ownership check); plain ``threading.Lock`` only exposes
    ``locked()``, a weaker held-by-somebody check, which still catches
    the common bug of calling a ``*_locked`` method with no lock held
    at all.
    """
    if lock is None or not asserts_enabled():
        return
    is_owned = getattr(lock, "_is_owned", None)
    if callable(is_owned):
        held = is_owned()
    else:
        locked = getattr(lock, "locked", None)
        held = locked() if callable(locked) else True
    if not held:
        raise AssertionError(
            f"{what} requires holding {lock!r}, but the calling thread "
            f"does not own it (see the `# guarded by:` comment)")
