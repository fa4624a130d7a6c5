"""Numerical-determinism guards (SURVEY.md §5 determinism row).

The reference's only runtime diagnostics are bool returns + a TLS
error string (misc.c:75-93); the analogue for a functional
program is (a) NaN/Inf guards on the float paths and (b) same-seed
determinism, both checkable without breaking jit:

  * ``checked(fn)`` wraps a jittable function with jax.experimental
    checkify float_checks so NaN/Inf production inside it raises a
    JaxRuntimeError with the offending primitive's location.  Used by
    tests and available in production behind DETEX_DEBUG_NANS=1.
  * ``assert_all_finite(tree, name)`` — an eager post-hoc guard for
    host-side call sites (training loops between steps).

The integer decode kernels need no guards: they are closed over
int32/uint32 ops and produce validity masks instead of exceptions
(texture.c:90-93 semantics).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import checkify


def debug_nans_enabled() -> bool:
    return os.environ.get("DETEX_DEBUG_NANS", "") not in ("", "0")


def checked(fn):
    """Wrap a jittable float computation with checkify float checks;
    the wrapper raises on NaN/Inf instead of propagating silently.
    Adds guard overhead — use in tests / DETEX_DEBUG_NANS runs."""
    cfn = checkify.checkify(fn, errors=checkify.float_checks)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        checkify.check_error(err)
        return out

    return wrapper


def maybe_checked(fn):
    """`checked(fn)` when DETEX_DEBUG_NANS=1, else `fn` untouched —
    zero overhead in production."""
    return checked(fn) if debug_nans_enabled() else fn


def assert_all_finite(tree, name: str = "value") -> None:
    """Host-side guard: raise if any float leaf holds NaN/Inf."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) and \
                not np.all(np.isfinite(arr)):
            raise FloatingPointError(
                f"non-finite values in {name}{jax.tree_util.keystr(path)}")


def tree_equal(a, b) -> bool:
    """Bitwise pytree equality (determinism checks: same seed ->
    identical results, across runs and across process layouts)."""
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    if ta != tb or len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        xa, ya = np.asarray(x), np.asarray(y)
        if xa.dtype != ya.dtype or xa.shape != ya.shape:
            return False
        if not np.array_equal(xa.view(np.uint8), ya.view(np.uint8)):
            return False
    return True
