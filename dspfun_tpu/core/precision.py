"""Runtime precision policy.

The reference selects two float precisions at *compile* time — "coeff"
(storage/FFTW buffers) and "intermediate" (math) — via the
COEFF_PRECISION / INTERMEDIATE_PRECISION macros in
reference include/precision.h:26-57, with per-tool defaults
(spec/zoom: coeff=double, intermediate=long double; motion/scan:
coeff=float — reference motion/Makefile:1-2, scan/Makefile:1-2).

Here this becomes a *runtime* policy object:

* ``coeff``: dtype of stored arrays and transform outputs
  (f32 default; bf16 for bandwidth-bound paths; f64 on CPU oracles).
* ``intermediate``: how matmul contractions accumulate:
    - "f32"   : plain f32 matmuls at HIGHEST precision
      (preferred_element_type=f32)
    - "hilo"  : double-float compensated matmuls — the basis matrix is
      split into hi+lo f32 parts and two matmuls are summed, bounding
      the basis representation error at ~2^-48.  Accumulation still
      rounds in f32, so whole-image (K >= ~256) chains drift;
      small-block paths (motion) are exact enough.
    - "exact" : correctly-rounded f32 contraction via error-free bf16
      digit splitting (core/exact.py, Ozaki scheme): every partial
      product and accumulation is exact; the only rounding is the
      final f32 store.  The analogue of the reference's "intermediate
      = long double" convention (include/precision.h:50-57) and what
      lets whole-image transforms match double-precision FFTW to
      <=1e-5 (BASELINE.md).  Whole-image spec/ispec auto-upgrade
      hilo->exact at >=256 px.
    - "i8"    : int8 Ozaki digit contraction with exact int32 sums
      (ops/int8mm.py).
    - "f64"   : true float64 (CPU / x64-enabled only).

Tools take an optional Precision; the module-level default matches the
reference defaults in spirit (accurate math, f32 storage).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

_VALID_INTERMEDIATE = ("f32", "hilo", "exact", "f64", "i8")

# Mapping of the reference's single-letter precision flags (F/D/L,
# reference include/precision.h:26-35) onto runtime policies.
_LETTER_COEFF = {"F": "float32", "D": "float32", "L": "float32", "B": "bfloat16"}
_LETTER_INTER = {"F": "f32", "D": "hilo", "L": "hilo"}


@dataclasses.dataclass(frozen=True)
class Precision:
    """Dtype policy: storage dtype + contraction accumulation mode.

    ``tol`` is an optional accuracy *budget* (target max relative error
    of a transform chain).  When set it relaxes the accuracy-critical
    paths to exactly what the budget needs, which is much faster:

    * ``intermediate="exact"``: the error-free digit contraction sizes
      its operand digit counts and digit-pair cutoff from ``tol``
      instead of carrying a full f64-class tail (core/exact.py).
    * ``intermediate="f32"/"hilo"`` fused chains: contractions run as
      3-pass bf16 (``Precision.HIGH``) matmuls over a rank-1-split
      operand (the dominant DC/mean component is applied analytically,
      see core/transforms.apply_plan ``split=``), instead of 6-pass
      HIGHEST over the raw operand.

    ``intermediate="i8"`` runs planned contractions as int8 Ozaki digit
    products with exact int32 accumulation (ops/int8mm.py): ~9e-8
    relative with 4 digits; unplanned contractions fall back to
    HIGHEST f32.

    ``tol=None`` keeps the maximum-accuracy behaviour of each mode.
    """

    coeff: Any = jnp.float32
    intermediate: str = "hilo"
    tol: float | None = None

    def __post_init__(self):
        if self.intermediate not in _VALID_INTERMEDIATE:
            raise ValueError(
                f"intermediate must be one of {_VALID_INTERMEDIATE}, "
                f"got {self.intermediate!r}"
            )
        if self.tol is not None and not (0.0 < self.tol < 1.0):
            raise ValueError(f"tol must be in (0, 1), got {self.tol!r}")

    @property
    def coeff_dtype(self):
        return jnp.dtype(self.coeff)

    @property
    def basis_dtype(self):
        """Dtype basis matrices are materialised in."""
        if self.intermediate == "f64":
            return jnp.dtype(jnp.float64)
        return jnp.dtype(jnp.float32)

    @classmethod
    def from_letters(cls, coeff: str = "D", intermediate: str = "L") -> "Precision":
        """Map the reference's F/D/L compile-time letters to a policy."""
        return cls(
            coeff=_LETTER_COEFF[coeff.upper()],
            intermediate=_LETTER_INTER.get(intermediate.upper(), "hilo"),
        )

    @classmethod
    def parse(cls, spec: str) -> "Precision":
        """Parse the ``[coeff:]intermediate[@tol]`` policy syntax — the
        DSPFUN_PRECISION env-var language, usable programmatically.
        Examples: "f32", "hilo", "bf16:f32", "f64:f64", "exact@1e-5",
        "i8@1e-5"."""
        if not spec:
            return cls()
        spec, _, tol_s = spec.partition("@")
        coeff, _, inter = spec.partition(":")
        if not inter:
            coeff, inter = "float32", coeff
        coeff = {"f32": "float32", "bf16": "bfloat16",
                 "f64": "float64"}.get(coeff, coeff)
        return cls(coeff=coeff, intermediate=inter,
                   tol=float(tol_s) if tol_s else None)


def _from_env() -> Precision:
    """DSPFUN_PRECISION=[coeff:]intermediate[@tol] — the runtime
    replacement for the reference's COEFF_PRECISION/
    INTERMEDIATE_PRECISION compile flags (include/precision.h:26-57)."""
    import os  # noqa: PLC0415

    return Precision.parse(os.environ.get("DSPFUN_PRECISION", ""))


_default = _from_env()
# whether the policy was chosen explicitly (env var or set_precision);
# per-tool defaults only apply when it was not
_explicit = bool(__import__("os").environ.get("DSPFUN_PRECISION"))


def get_precision() -> Precision:
    return _default


def set_precision(p: Precision) -> None:
    global _default, _explicit
    _default = p
    _explicit = True


def _on_accelerator() -> bool:
    """True when JAX's default backend is not the CPU."""
    import jax  # noqa: PLC0415

    return jax.default_backend() != "cpu"


def tool_default(tool: str) -> Precision:
    """Per-tool default policy, mirroring the reference's per-tool
    compile-time defaults (motion/scan: COEFF=F INTERMEDIATE=L —
    reference motion/Makefile:1-2, scan/Makefile:1-2; spec/zoom/
    applybasis: COEFF=D INTERMEDIATE=L — include/precision.h:50-57):

    * motion/scan/rotate/transcode: f32 storage + hilo contraction
      (the F/L analogue; block-local transforms stay <=1e-5 there).
    * spec/ispec: hilo, auto-upgraded to the error-free exact
      contraction at >=256 px (models/spec_pipeline) — the D/L
      whole-image accuracy class.
    * zoom on an accelerator: the deep (4-digit) i8 contraction
      (~1e-7 relative with exact accumulation — the D/L class); on the
      CPU, where int8 products buy nothing, hilo.
    * applybasis/genbasis/draw: hilo (small closed-form bases; HIGHEST
      einsums already sit at the f32 rounding floor).
    """
    if tool == "zoom" and _on_accelerator():
        return Precision(coeff="float32", intermediate="i8")
    return Precision()


def apply_tool_default(tool: str) -> None:
    """Install the per-tool default policy unless the user already
    chose one (DSPFUN_PRECISION or set_precision).  Called at each
    tool's main() entry."""
    global _default
    if not _explicit:
        _default = tool_default(tool)
