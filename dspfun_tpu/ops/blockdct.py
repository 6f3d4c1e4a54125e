"""Kronecker-folded blockwise transforms — the fast path for small blocks.

For a separable N-D DCT over a small block (volume V = bd*bh*bw up to a
few thousand), the transform is the Kronecker product of the per-axis
basis matrices: a single [V, V] matmul per block, batched over the
block grid as [NB, V] @ [V, V] — one large matmul
(contrast the reference's per-block FFTW plans, motion/motion.c:518-557).

Better still, when the whole coefficient chain is *linear* (bandpass
boost/damp, uniform renorm, any fixed mask — the BASELINE.json motion
benchmark config), forward transform, filter and inverse fold into ONE
precomputed [V, V] operator:

    A = K_inv @ diag(filter) @ K_fwd / (2^n * V)

and the entire pipeline is a single matmul with one device-memory read and
one write per block — the "north star" fused blockwise
transform+filter+inverse.
"""

from __future__ import annotations

import functools

import jax
import numpy as np

from dspfun_tpu.core import basis as basis_mod
from dspfun_tpu.core.precision import Precision
from dspfun_tpu.core.transforms import AxisPlan, apply_plan, plan_matrix

__all__ = [
    "kron_dct_matrix",
    "folded_operator",
    "apply_block_operator",
    "bdiag_axis_plan",
    "blocks_from_array",
    "blocks_to_array",
]


@functools.lru_cache(maxsize=32)
def _kron_cached(dims: tuple[int, ...], kind: str) -> np.ndarray:
    mk = basis_mod.dct2_matrix if kind == "dct2" else basis_mod.dct3_matrix
    m = np.array([[1.0]])
    for n in dims:
        m = np.kron(m, mk(n))
    m.setflags(write=False)  # cached: in-place edits would corrupt it
    return m


def kron_dct_matrix(dims: tuple[int, ...], kind: str = "dct2") -> np.ndarray:
    """[V, V] separable DCT over a block of shape ``dims`` acting on the
    row-major flattened block (V = prod(dims))."""
    return _kron_cached(tuple(int(d) for d in dims), kind)


def folded_operator(
    dims: tuple[int, ...],
    coeff_filter: np.ndarray,
    precision: Precision | None = None,
) -> AxisPlan:
    """One [V, V] operator = IDCT @ diag(filter) @ DCT / (2^n V).

    ``coeff_filter`` is the per-coefficient multiplier (block shape),
    e.g. a bandpass boost/damp mask.  The result applied to a flat
    block reproduces fused transform->filter->inverse exactly.
    """
    v = int(np.prod(dims))
    fwd = kron_dct_matrix(dims, "dct2")
    inv = kron_dct_matrix(dims, "dct3")
    f = np.asarray(coeff_filter, dtype=np.float64).reshape(v)
    a = (inv * f[None, :]) @ fwd / (2.0 ** len(dims) * v)
    return plan_matrix(a, precision)


def apply_block_operator(
    blocks: jax.Array, op: AxisPlan, precision: Precision | None = None
) -> jax.Array:
    """[NB, V] blocks through the folded [V, V] operator with the full
    precision-policy dispatch (f32/hilo/exact/i8/f64) — delegates to
    core.transforms.apply_plan so digit plans built by
    :func:`folded_operator` under exact/i8 policies actually engage."""
    return apply_plan(blocks, op, 1, precision)


def bdiag_axis_plan(
    size: int,
    block_matrix: np.ndarray,
    precision: Precision | None = None,
) -> AxisPlan:
    """Block-diagonal [size, size] plan ``I_{size//n} (x) block_matrix``.

    Applies an independent per-block [n, n] transform along a
    full-length axis as ONE dense matmul — no block gather, no
    reshape/transpose, and a K=size contraction instead of K=n — a
    better matmul shape for blockwise chains whose axis length is a
    multiple of the block size.  Fold any
    separable per-coefficient diagonal (e.g. spec's sqrt(2) grid) and
    scalar gains into ``block_matrix`` before calling.
    """
    m = np.asarray(block_matrix, dtype=np.float64)
    n = m.shape[0]
    if m.ndim != 2 or m.shape[1] != n:
        raise ValueError(f"block_matrix must be square, got {m.shape}")
    if size % n:
        raise ValueError(f"axis length {size} not a multiple of block {n}")
    return plan_matrix(np.kron(np.eye(size // n), m), precision)


def blocks_from_array(x: jax.Array, dims: tuple[int, int]) -> jax.Array:
    """[H, W, C] -> [nbh*nbw*C, bh*bw] flat blocks (row-major within
    block), truncating ragged edges."""
    bh, bw = dims
    h, w, c = x.shape
    nbh, nbw = h // bh, w // bw
    a = x[: nbh * bh, : nbw * bw]
    a = a.reshape(nbh, bh, nbw, bw, c).transpose(0, 2, 4, 1, 3)
    return a.reshape(nbh * nbw * c, bh * bw)


def blocks_to_array(
    blocks: jax.Array, dims: tuple[int, int], h: int, w: int, c: int
) -> jax.Array:
    bh, bw = dims
    nbh, nbw = h // bh, w // bw
    a = blocks.reshape(nbh, nbw, c, bh, bw).transpose(0, 3, 1, 4, 2)
    return a.reshape(nbh * bh, nbw * bw, c)
