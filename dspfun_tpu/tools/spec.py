"""spec — generate invertible frequency spectrums for viewing and editing.

CLI-compatible rebuild of reference spec/spec.c on the device pipeline in
dspfun_tpu.models.spec_pipeline.
"""

from __future__ import annotations

import getopt
import sys

import jax
import numpy as np

from dspfun_tpu.io import images
from dspfun_tpu.models.spec_pipeline import spec_forward, whole_plans
from dspfun_tpu.ops.int8mm import ceil_to
from dspfun_tpu.tools._speccli import SPEC_HELP, SpecOpts, resolve_io, spec_opt_proc

USAGE = "Usage: spec -h -g -c csp -t (abs|shift|flat|sign|copy) -R (one|dc|dcs) -T (linear|log) -S (abs|shift|saturate|retain) -G (native|reference|custom(float)) -M mesh <infile> <outfile>"


def main(argv: list[str] | None = None) -> int:
    from dspfun_tpu.core.precision import apply_tool_default  # noqa: PLC0415

    apply_tool_default("spec")
    argv = sys.argv[1:] if argv is None else argv
    opts = SpecOpts()
    mesh_spec = None
    try:
        flags, args = getopt.getopt(argv, "hgc:t:s:T:S:G:R:M:")
    except getopt.GetoptError as e:
        print(USAGE, file=sys.stderr)
        return 1
    for flag, arg in flags:
        if flag == "-h":
            print("Usage: spec [options] <infile> <outfile>\noptions:\n  -h  This help text.\n  -M  Device mesh for huge images (auto|N|space=N).\n")
            print(SPEC_HELP)
            return 0
        if flag == "-M":
            mesh_spec = arg
        elif not spec_opt_proc(opts, flag, arg):
            print(USAGE, file=sys.stderr)
            return 1
    if not resolve_io(args, opts):
        print(USAGE, file=sys.stderr)
        return 1

    try:
        img = images.read_image(opts.input, channels=opts.csp, linear=opts.gamma)
    except Exception as e:  # noqa: BLE001
        print(e, file=sys.stderr)
        return 1

    x = np.asarray(img.pixels)
    mesh = _resolve_mesh(mesh_spec)
    if mesh is not None:
        from dspfun_tpu.parallel import spec_sharded as ss  # noqa: PLC0415

        h0, w0 = x.shape[:2]
        ns = mesh.shape["space"]
        hp, wp = ceil_to(h0, ns), ceil_to(w0, ns)
        xp = np.asarray(x, np.float32)
        if (hp, wp) != (h0, w0):  # zero-pad; the padded basis rows/cols
            xp = np.pad(xp, ((0, hp - h0), (0, wp - w0), (0, 0)))  # are zero
        xs = jax.device_put(xp, ss.image_sharding(mesh))
        f, dc = ss.spec_forward_sharded(xs, opts.params, mesh,
                                        true_shape=(h0, w0))
        f = np.asarray(f)[:h0, :w0]
    else:
        fwd = jax.jit(spec_forward, static_argnums=(1,))
        plans = jax.device_put(whole_plans(x.shape, "dct2"))
        f, dc = fwd(x, opts.params, plans=plans)
    f = np.asarray(f)
    dc = np.asarray(jax.device_get(dc), dtype=np.float64)

    props = {"DC": images.encode_dc_property(dc)}
    # PNG spectra are written at 16 bits like the reference's MagickWand
    # Q16 default (spec/spec.c:141-155) — the depth that makes
    # `spec -t flat | edit | ispec` editing workflows invertible
    depth = 16 if _png_target(opts.output) else 8
    try:
        images.write_image(opts.output, f, channels=opts.csp,
                           properties=props, depth=depth)
    except Exception as e:  # noqa: BLE001
        print(e, file=sys.stderr)
        return 1
    return 0


def _resolve_mesh(mesh_spec):
    """-M/--mesh (or the DSPFUN_MESH env var when the flag is absent,
    matching motion): shard the whole-image transform over the mesh
    'space' axis (any size — rows pad internally)."""
    from dspfun_tpu.parallel.mesh import mesh_from_spec  # noqa: PLC0415

    try:
        mesh = mesh_from_spec(mesh_spec)
    except ValueError as e:
        print(f"mesh unavailable ({e}); running single-device",
              file=sys.stderr)
        return None
    if mesh is None:
        return None
    if mesh.shape.get("time", 1) != 1:
        print("spec mesh uses the space axis only; pass -M N", file=sys.stderr)
        return None
    return mesh


def _png_target(spec: str | None) -> bool:
    if spec is None:
        return not sys.stdout.isatty()
    fmt, path = images._split_spec(spec)
    if fmt:
        return fmt == "png"
    if path == "-":
        return True
    ext = path.rsplit(".", 1)[-1].lower() if "." in path else "png"
    return ext == "png"


if __name__ == "__main__":
    from dspfun_tpu.tools import run_main

    run_main(main)
