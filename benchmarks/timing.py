"""Shared device-timing estimator for bench.py and benchmarks/suite.py.

True on-device per-iteration time via two-point subtraction.  Every
dispatch and host sync adds a fixed cost K, so a single T/n reading
floors small bodies.  Chaining the body inside one jitted
lax.fori_loop at two lengths gives T(n) = K + n*c  ->
c = (T(2n) - T(n)) / n, independent of K.

Dispatch *jitter* is not cancelled by the subtraction, so the chain
must be long enough that n*c dwarfs it: the chain grows geometrically
until the measured delta T(2n)-T(n) = n*c itself exceeds ``target_s``
(fori_loop compile cost is length-independent, so longer chains are
nearly free).  Sizing from the *delta* rather than a pilot estimate of
c matters for microsecond bodies: one noisy pilot reading can
overestimate c many times over and leave the chain jitter-dominated.
The stopping delta is CONFIRMED by a second reading (min of the two
must clear the target), so a single upward jitter spike cannot freeze
the chain short.

The returned value is the MEDIAN of ``reps`` independent two-point
measurements (over the POSITIVE readings only: with negative outliers
in the sample, the plain median can land on a band extreme), plus the
(min, max) seconds-per-iteration band for the caller's artifact row.
"""

from __future__ import annotations

import functools
import math
import time

_PROBE = None


def sync(x) -> float:
    """Fetch one scalar to synchronise (first leaf of a pytree carry);
    the probe jit is cached (a fresh lambda per call would re-trace
    and compile each time)."""
    global _PROBE
    import jax

    if _PROBE is None:
        _PROBE = jax.jit(lambda a: a.reshape(-1)[0])
    return float(jax.device_get(_PROBE(jax.tree_util.tree_leaves(x)[0])))


def time_fori(step, x0, iters=8, reps=5, target_s=0.08, max_iters=1 << 20):
    """Median seconds-per-iteration of ``step`` (see module docstring).

    Returns ``(c, band)`` where ``band`` is the (min, max)
    seconds-per-iteration tuple over the positive readings, or None
    when the body sits below the dispatch jitter floor even at
    ``max_iters`` (then ``c`` is the conservative T/(2n) reading).
    """
    import jax

    @functools.lru_cache(maxsize=None)
    def many(n):
        @jax.jit
        def f(x):
            return jax.lax.fori_loop(0, n, lambda i, v: step(v), x)

        return f

    f1, f2 = many(iters), many(2 * iters)
    sync(f1(x0))  # warm/compile both lengths
    sync(f2(x0))

    def once(fn):
        t0 = time.perf_counter()
        sync(fn(x0))
        return time.perf_counter() - t0

    # grow the chain until the two-point delta (= n*c) itself exceeds
    # target_s, so the delta is body-dominated
    n = iters
    while n < max_iters:
        d = once(f2) - once(f1)
        if d >= target_s:
            # confirm: one spiked dispatch must not stop the growth
            d = min(d, once(f2) - once(f1))
            if d >= target_s:
                break
        if d > 0:
            # jump toward target from the measured per-iter estimate;
            # an overestimate of c just overshoots (safe), an
            # underestimate keeps the loop growing
            n = min(max_iters, max(2 * n, math.ceil(target_s / (d / n))))
        else:
            n = min(max_iters, 4 * n)
        f1, f2 = many(n), many(2 * n)
        sync(f1(x0))
        sync(f2(x0))

    cs = sorted((once(f2) - once(f1)) / n for _ in range(reps))
    pos = [v for v in cs if v > 0]
    if len(pos) < 3:
        # noise floor: the body is below the dispatch jitter;
        # publish the conservative T/(2n) reading with no band
        return once(f2) / (2 * n), None
    return pos[len(pos) // 2], (min(pos), max(pos))


def time_host(fn, reps=3):
    """min-of-N host baseline timing (the host is shared and noisy;
    do not run anything else on it during a capture)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best
