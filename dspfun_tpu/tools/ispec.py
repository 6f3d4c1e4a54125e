"""ispec — invert spectrums generated by spec.

CLI-compatible rebuild of reference spec/ispec.c.
"""

from __future__ import annotations

import getopt
import sys

import jax
import numpy as np

from dspfun_tpu.io import images
from dspfun_tpu.models.spec_pipeline import spec_inverse, whole_plans
from dspfun_tpu.ops.int8mm import ceil_to
from dspfun_tpu.tools._speccli import SPEC_HELP, SpecOpts, resolve_io, spec_opt_proc

USAGE = "Usage: ispec -h -p -m <signmap> -M mesh [spec options] <infile> <outfile>"


def main(argv: list[str] | None = None) -> int:
    from dspfun_tpu.core.precision import apply_tool_default  # noqa: PLC0415

    apply_tool_default("ispec")
    argv = sys.argv[1:] if argv is None else argv
    opts = SpecOpts()
    preserve_dc = False
    signmap_path = None
    mesh_spec = None
    try:
        flags, args = getopt.getopt(argv, "hgc:t:s:T:S:G:R:pm:M:")
    except getopt.GetoptError:
        print(USAGE, file=sys.stderr)
        return 1
    for flag, arg in flags:
        if flag == "-M":
            mesh_spec = arg
        elif flag == "-h":
            print(
                "Usage: ispec [options] <infile> <outfile>\noptions:\n"
                "  -h            This help text.\n"
                "  -p            Apply the DC coefficient from the original image if available.\n"
                "  -m <signmap>  Path to a file generated with `spec -t sign`\n"
                "  -M <mesh>     Device mesh for huge images (auto|N|space=N).\n"
            )
            print(SPEC_HELP)
            return 0
        elif flag == "-p":
            preserve_dc = True
        elif flag == "-m":
            signmap_path = arg
        elif not spec_opt_proc(opts, flag, arg):
            print(USAGE, file=sys.stderr)
            return 1
    if not resolve_io(args, opts):
        print(USAGE, file=sys.stderr)
        return 1

    try:
        img = images.read_image(opts.input, channels=opts.csp)
    except Exception as e:  # noqa: BLE001
        print(e, file=sys.stderr)
        return 1

    d = len(opts.csp)
    signmap_usable = (signmap_path is not None
                      and opts.params.signtype == "abs")
    if signmap_path is not None and not signmap_usable:
        print("warning: -m signmap is only used with -S abs; ignoring",
              file=sys.stderr)
    dc = None
    if "DC" in img.properties:
        dc = images.decode_dc_property(img.properties["DC"], d)
    elif not signmap_usable and (
        preserve_dc or opts.params.rangetype in ("dc", "dcs")
    ):
        print("DC not found in header", file=sys.stderr)
        return 1

    signmap = None
    if signmap_usable:
        sm = images.read_image(signmap_path, channels=opts.csp)
        signmap = np.asarray(sm.pixels)

    from dspfun_tpu.tools.spec import _resolve_mesh  # noqa: PLC0415

    mesh = _resolve_mesh(mesh_spec)
    if mesh is not None:
        from dspfun_tpu.parallel import spec_sharded as ss  # noqa: PLC0415

        f = np.asarray(img.pixels, np.float32)
        if signmap is not None and opts.params.signtype == "abs":
            # sign restoration is a one-shot host pre-pass (shared
            # implementation: models/spec_pipeline.signmap_restore)
            from dspfun_tpu.models.spec_pipeline import (  # noqa: PLC0415
                signmap_restore,
            )

            f, dc = signmap_restore(f, signmap, np)
        h0, w0 = f.shape[:2]
        ns = mesh.shape["space"]
        hp, wp = ceil_to(h0, ns), ceil_to(w0, ns)
        if (hp, wp) != (h0, w0):
            f = np.pad(f, ((0, hp - h0), (0, wp - w0), (0, 0)))
        fs = jax.device_put(f, ss.spectrum_sharding(mesh))
        y = ss.spec_inverse_sharded(fs, opts.params, mesh, dc=dc,
                                    preserve_dc=preserve_dc,
                                    true_shape=(h0, w0))
        y = np.asarray(y)[:h0, :w0]
    else:
        inv = jax.jit(spec_inverse, static_argnames=("params", "preserve_dc"))
        y = inv(
            np.asarray(img.pixels),
            params=opts.params,
            dc=dc,
            signmap=signmap,
            preserve_dc=preserve_dc,
            plans=jax.device_put(whole_plans(img.pixels.shape, "dct3")),
        )
    y = np.asarray(y)

    try:
        # mirror the input spectrum's depth for PNG targets (the
        # reference writes at the wand's depth, ispec.c:170-182)
        from dspfun_tpu.tools.spec import _png_target  # noqa: PLC0415

        depth = img.depth if _png_target(opts.output) else 8
        images.write_image(opts.output, y, channels=opts.csp,
                           to_srgb=opts.gamma, depth=depth)
    except Exception as e:  # noqa: BLE001
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    from dspfun_tpu.tools import run_main

    run_main(main)
