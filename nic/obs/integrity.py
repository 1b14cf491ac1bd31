"""Opt-in silent-data-corruption (SDC) guards for device results.

XLA executions of the same program on the same data are bit-deterministic,
so two independent executions that disagree point at corruption in
execution, upload or fetch. Large accelerator fleets see such faults; the
countermeasure is to compute critical results redundantly and compare.
Nothing runs these guards by default: ``SDC_GUARD_DECODE=True`` puts CLI
decodes behind :func:`verified_result`, ``SDC_GUARD_TRAIN=True`` adds the
trainer's periodic double-executed step (``tree_equal_fn``).

- :func:`verified_fetch` — D2H transfer integrity: fetch a device array
  twice through independent device buffers; retry on mismatch.
- :func:`verified_result` — end-to-end integrity: run a device evaluation
  twice (independent executions), compare the results on host, retry on
  disagreement and return the stable value.

The reference has no counterpart (single local CUDA device).
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def verified_fetch(x, retries: int = 3, warn: Callable | None = None):
    """Fetch ``x`` (a jax array) to host with transfer verification.

    Fetches through two independent device buffers (``jnp.copy`` forces a
    fresh buffer and therefore a fresh transfer; a plain second
    ``np.asarray`` would reuse the cached host copy). On mismatch, warns
    and retries up to ``retries`` times; returns the first value that is
    reproduced twice. Raises ``RuntimeError`` if no stable value emerges.
    """
    import jax.numpy as jnp

    a = np.asarray(x)
    for attempt in range(retries):
        b = np.asarray(jnp.copy(x))
        if a.shape == b.shape and np.array_equal(a, b, equal_nan=True):
            return a
        if warn is not None:
            warn(
                f"verified_fetch: transfer mismatch (attempt {attempt + 1}/"
                f"{retries}, max|diff|="
                f"{np.max(np.abs(a.astype(np.float64) - b.astype(np.float64)))})"
            )
        a = b
    raise RuntimeError(
        f"verified_fetch: no stable device fetch after {retries} retries"
    )


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [np.asarray(o) for o in out]
    return [np.asarray(out)]


def verified_result(
    fn: Callable[[], np.ndarray],
    retries: int = 3,
    warn: Callable | None = None,
):
    """Run a device evaluation twice and confirm the (host) result.

    ``fn`` must return a numpy array/scalar — or a tuple/list of them —
    and be deterministic: XLA executions of the same program on the same
    data are bit-deterministic, so any disagreement between two
    independent runs is corruption (in execution, upload, or fetch), not
    noise. Returns the first value reproduced twice (arrays converted to
    numpy, container structure preserved); retries on disagreement;
    raises after ``retries`` consecutive mismatches.
    """
    prev = _leaves(fn())
    for attempt in range(retries):
        out = fn()
        cur = _leaves(out)
        if len(prev) == len(cur) and all(
            a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
            for a, b in zip(prev, cur)
        ):
            if isinstance(out, (tuple, list)):
                return type(out)(cur)
            return cur[0]
        if warn is not None:
            ds = [
                float(np.max(np.abs(a.astype(np.float64)
                                    - b.astype(np.float64))))
                if a.shape == b.shape else float("nan")
                for a, b in zip(prev, cur)
            ]
            warn(
                f"verified_result: run-to-run mismatch (attempt "
                f"{attempt + 1}/{retries}, max|diff|={max(ds) if ds else 'shape'}) "
                "— silent data corruption suspected; retrying"
            )
        prev = cur
    raise RuntimeError(
        f"verified_result: no stable result after {retries} retries"
    )


class SDCError(RuntimeError):
    """Persistent silent-data-corruption detected (two independent device
    executions of the same program on the same data keep disagreeing)."""


def tree_equal_fn():
    """A jitted device-side bit-comparison for pytrees: returns a scalar
    bool (one byte to host instead of multi-MB optimizer states). NaNs
    compare equal so a diverged-but-deterministic run does not trip the
    guard."""
    import jax
    import jax.numpy as jnp

    def leaf_eq(a, b):
        eq = a == b
        if jnp.issubdtype(a.dtype, jnp.floating):
            eq = eq | (jnp.isnan(a) & jnp.isnan(b))
        return jnp.all(eq)

    @jax.jit
    def equal(ta, tb):
        leaves = jax.tree.map(leaf_eq, ta, tb)
        return jnp.all(jnp.stack(jax.tree.leaves(leaves)))

    return equal
