"""motion — apply 2- or 3-dimensional frequency-domain operations to an
image or video.

CLI-compatible rebuild of reference motion/motion.c on the batched
block pipeline in dspfun_tpu.models.motion_pipeline.  The FFTW plan
machinery (planning rigor, wisdom files, threads) maps onto XLA's
compilation cache, so those flags are accepted for CLI parity and the
planning knobs become no-ops.
"""

from __future__ import annotations

import getopt
import math
import os
import sys
import time
from fractions import Fraction

import numpy as np

from dspfun_tpu.core.expr import parse_expr
from dspfun_tpu.io import video
from dspfun_tpu.models import motion_pipeline as mp

# device-plan cache across main() invocations (see its use site)
_PLAN_CACHE: dict = {}

# jitted payload concat per arity: a slab batch's packed payloads merge
# on device so the batch crosses D2H as ONE transfer (each transfer
# pays a fixed cost on top of the wire time)
_CONCAT_CACHE: dict = {}


def _concat_payloads(pays):
    import jax  # noqa: PLC0415

    fn = _CONCAT_CACHE.get(len(pays))
    if fn is None:
        fn = jax.jit(lambda *ps: jax.numpy.concatenate(ps, axis=0))
        _CONCAT_CACHE[len(pays)] = fn
    return fn(*pays)

SHORT = "b:s:p:B:D:c:q:r:dQh"
LONG = [
    "size=", "blocksize=", "offset=", "frames=", "framerate=", "keep-rate",
    "samesize-chroma", "spectrogram=", "ispectrogram=", "bandpass=", "boost=",
    "damp=", "quant=", "dither", "csp=", "format=", "codec=", "encopts=",
    "iformat=", "decopts=", "loglevel=", "preserve-dc=", "eval=",
    "fftw-planning-method=", "fftw-wisdom-file=", "fftw-threads=", "quiet",
    "help", "threshold=", "coeff-limit=", "linear", "resume-file=", "mesh=",
    "coordinator=", "nprocs=", "proc-id=", "slab-batch=",
]

# getopt has no optional-argument long options; bare forms of these are
# rewritten to "--opt=" before parsing (empty value selects the default)
_OPTIONAL_ARG = ("--spectrogram", "--ispectrogram", "--preserve-dc")

USAGE = """Usage: motion [options] <infile> [outfile]
[-s|--size WxHxD] [-b|--blocksize WxHxD] [-p|--bandpass X1xY1xZ1-X2xY2xZ2]
[-B|--boost float] [-D|--damp float]  [--spectrogram=type] [--ispectrogram=type] [-q|--quant quant] [--threshold] [--coeff-limit limit] [-d|--dither] [--preserve-dc=type] [--eval expression]
[-r|--framerate] [--keep-rate] [--samesize-chroma] [--frames lim] [--offset pos] [--csp|c colorspace options] [--iformat|--format fmt] [--codec codec] [--encopts|--decopts opts] [--loglevel int]
[--mesh auto|N|space=N[,time=M]] [--slab-batch N|auto] [--coordinator host:port --nprocs N --proc-id I] [-Q|--quiet]"""

EXPR_NAMES = ("c", "x", "y", "z", "i", "width", "height", "depth",
              "components", "bx", "by", "bz", "bwidth", "bheight", "bdepth")


def _parse_dims(arg: str, current: mp.Dims = mp.Dims(0, 0, 0)) -> mp.Dims:
    """sscanf-style: unmatched trailing fields keep their prior values
    (so `-b 8x8` keeps the default depth 1, while `-b 8x8x0` explicitly
    requests whole-clip depth — reference motion.c:227,motion/README.md)."""
    vals = [current.w, current.h, current.d]
    for i, p in enumerate(arg.split("x")[:3]):
        if p != "":
            vals[i] = int(p)
    return mp.Dims(*vals)


def _parse_multi(arg: str, default: float) -> list[float]:
    """N[:N:N:N] per-plane values; missing entries repeat the last
    (reference motion.c:235-236)."""
    vals = [float(t) for t in arg.split(":") if t != ""]
    out = []
    for i in range(4):
        if i < len(vals):
            out.append(vals[i])
        else:
            out.append(out[-1] if out else default)
    return out


def main(argv: list[str] | None = None) -> int:
    from dspfun_tpu.core.precision import apply_tool_default  # noqa: PLC0415

    apply_tool_default("motion")
    argv = sys.argv[1:] if argv is None else argv
    argv = [a + "=" if a in _OPTIONAL_ARG else a for a in argv]
    try:
        flags, args = getopt.gnu_getopt(argv, SHORT, LONG)
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        print(USAGE, file=sys.stderr)
        return 1

    block = mp.Dims(0, 0, 1)
    scaled = mp.Dims()
    bp_begin = mp.Dims()
    bp_end = mp.Dims()
    boost = [1.0] * 4
    damp = [0.0] * 4
    quant = 0.0
    threshold_min = threshold_max = 0.0
    coeff_limit = 0
    spec = ispec = preserve_dc = None
    exprstr = None
    dither = linear = samerate = samesize = quiet = False
    offset = 0
    maxframes = 0
    out_rate = None
    csp = iformat = oformat = None
    codec = encopts = decopts = None
    resume_file = None
    mesh_spec = None
    slab_batch = "auto"
    coordinator = None
    nprocs = 1
    proc_id = 0
    for flag, arg in flags:
        if flag in ("-h", "--help"):
            print(USAGE)
            return 0
        elif flag in ("-b", "--blocksize"):
            block = _parse_dims(arg, block)
        elif flag in ("-s", "--size"):
            scaled = _parse_dims(arg)
        elif flag in ("-p", "--bandpass"):
            lo, _, hi = arg.partition("-")
            bp_begin = _parse_dims(lo)
            bp_end = _parse_dims(hi) if hi else mp.Dims()
        elif flag in ("-B", "--boost"):
            boost = _parse_multi(arg, 1.0)
        elif flag in ("-D", "--damp"):
            damp = _parse_multi(arg, 0.0)
        elif flag in ("-c", "--csp"):
            csp = arg
        elif flag in ("-r", "--framerate"):
            out_rate = video.parse_rate(arg)
        elif flag == "--offset":
            offset = int(arg)
        elif flag == "--frames":
            maxframes = int(arg)
        elif flag == "--keep-rate":
            samerate = True
        elif flag == "--samesize-chroma":
            samesize = True
        elif flag == "--spectrogram":
            spec = arg or "abs"
            if spec not in mp.SPECTYPES:
                print(f"invalid spectrogram type '{spec}', use one of: "
                      f"{' '.join(mp.SPECTYPES)}", file=sys.stderr)
                return 1
        elif flag == "--ispectrogram":
            ispec = arg or "shift"
            if ispec not in mp.ISPECTYPES:
                print(f"invalid ispectrogram type '{ispec}', use one of: "
                      f"{' '.join(mp.ISPECTYPES)}", file=sys.stderr)
                return 1
        elif flag == "--preserve-dc":
            preserve_dc = arg or "dc"
            if preserve_dc not in mp.PRESERVE_DCTYPES:
                print(f"invalid preserve-dc type '{preserve_dc}', use one "
                      f"of: {' '.join(mp.PRESERVE_DCTYPES)}", file=sys.stderr)
                return 1
        elif flag in ("-q", "--quant"):
            quant = float(arg)
        elif flag == "--threshold":
            lo, _, hi = arg.partition("-")
            threshold_min = float(lo or 0)
            threshold_max = float(hi or 0)
        elif flag == "--coeff-limit":
            coeff_limit = int(arg)
        elif flag in ("-d", "--dither"):
            dither = True
        elif flag == "--eval":
            exprstr = arg
        elif flag == "--linear":
            linear = True
        elif flag == "--format":
            oformat = arg
        elif flag == "--iformat":
            iformat = arg
        elif flag == "--fftw-wisdom-file":
            # FFTW wisdom -> XLA persistent compilation cache (beside
            # the file, unless JAX_COMPILATION_CACHE_DIR is set)
            from dspfun_tpu.utils.cache import enable_compilation_cache  # noqa: PLC0415

            enable_compilation_cache(arg)
        elif flag == "--resume-file":
            resume_file = arg
        elif flag == "--mesh":
            mesh_spec = arg
        elif flag == "--slab-batch":
            slab_batch = arg  # int | "auto"; resolved after mesh setup
        elif flag == "--coordinator":
            coordinator = arg
        elif flag == "--nprocs":
            nprocs = int(arg)
        elif flag == "--proc-id":
            proc_id = int(arg)
        elif flag == "--codec":
            codec = arg  # passed to the ffmpeg bridge for real containers
        elif flag == "--encopts":
            encopts = arg
        elif flag == "--decopts":
            decopts = arg  # passed to the ffmpeg bridge demuxer
        elif flag in ("--loglevel",
                      "--fftw-planning-method", "--fftw-threads"):
            pass  # CLI parity; XLA handles planning/threading
        elif flag in ("-Q", "--quiet"):
            quiet = True

    if not args:
        print(USAGE, file=sys.stderr)
        return 1
    infile = args[0]
    outfile = args[1] if len(args) > 1 else None

    # --coordinator/--nprocs/--proc-id: join the multi-process runtime
    # (jax.distributed over DCN) BEFORE any jax backend use; each
    # process reads the input and owns a time-contiguous slab of the
    # whole-clip volume path (parallel/multihost.py).  Non-zero
    # processes write to the null device in the same negotiated
    # container so the processing format matches process 0 exactly.
    multi = nprocs > 1 or coordinator is not None
    if multi:
        from dspfun_tpu.parallel import multihost  # noqa: PLC0415

        multihost.initialize(coordinator, nprocs, proc_id)
        if proc_id:
            from dspfun_tpu.io.video import _sniff_format  # noqa: PLC0415

            ofmt = _sniff_format(outfile or "-", oformat, for_output=True)
            if ofmt in ("ffmpeg", "image2"):
                print("multi-process motion needs a y4m or fvid output",
                      file=sys.stderr)
                return 1
            oformat = "y4m" if ofmt == "pipe" else ofmt
            outfile = os.devnull
            quiet = True

    expr = None
    if exprstr:
        try:
            expr = parse_expr(exprstr, EXPR_NAMES)
        except ValueError as e:
            print(f"Bad expression: {e}", file=sys.stderr)
            return 1

    try:
        reader = video.open_input(infile, format=iformat, options=decopts)
    except Exception as e:  # noqa: BLE001
        print(f'Error opening "{infile}": {e}', file=sys.stderr)
        return 1

    # processing pixel format: --csp request > spec constraints > input
    proc_fmt = reader.pix_fmt
    try:
        csp_props = video.parse_color_props(csp)
    except ValueError as e:
        print(f"Bad --csp: {e}", file=sys.stderr)
        reader.close()
        return 1
    if csp_props.pix_fmt:
        proc_fmt = video.PIXEL_FORMATS[csp_props.pix_fmt]
    elif (spec or linear) and not (proc_fmt.is_rgb or proc_fmt.ncomp == 1):
        # spectrogram / linear processing wants RGB or gray
        # (reference motion.c:313-325)
        proc_fmt = video.PIXEL_FORMATS["gbrpf32le"]
    # --csp overrides every color property for processing/output, not
    # just pixel_format (reference ffapi.c:94-114 applied at open);
    # range/matrix changes require conversion through RGB like the
    # reference's swscale setup (ffapi.c:283-326)
    proc_props = reader.props.copy()
    csp_override = False
    for field in ("color_range", "color_primaries", "color_trc",
                  "color_space", "chroma_location"):
        want = getattr(csp_props, field)
        if want is not None:
            if want != getattr(reader.props, field):
                csp_override = True
            setattr(proc_props, field, want)
    convert = proc_fmt.name != reader.pix_fmt.name or csp_override
    float_pixels = proc_fmt.is_float

    if reader.frames is None and not maxframes:
        print("Input frame count unknown (unseekable pipe); specify "
              "--frames", file=sys.stderr)
        reader.close()
        return 1
    nframes_in = reader.frames or 0
    source_d = nframes_in or maxframes
    if maxframes:
        # clamp --frames/--offset against the *known* input length only
        # (a pipe with --frames must not treat the request as the
        # stream length and silently zero the offset)
        if nframes_in and maxframes + offset > nframes_in:
            if maxframes > nframes_in:
                maxframes = nframes_in
            if offset >= nframes_in:
                offset = nframes_in - maxframes
            else:
                maxframes = nframes_in - offset
        source_d = maxframes
    elif source_d:
        if offset >= source_d:
            offset = source_d - 1
        source_d -= offset

    if not quiet:
        print(f"  source: {reader.width} x {reader.height} x {source_d}",
              file=sys.stderr)
    if not outfile:
        reader.close()
        return 0

    sx, sy = proc_fmt.chroma_shift
    geoms = mp.plan_geometry(
        reader.width, reader.height, source_d, proc_fmt.ncomp,
        log2_chroma_w=sx, log2_chroma_h=sy,
        block=block, scaled=scaled, bp_begin=bp_begin, bp_end=bp_end,
        samesize_chroma=samesize,
    )
    g0 = geoms[0]
    if not quiet and (reader.width % g0.block.w or reader.height % g0.block.h
                      or source_d % g0.block.d):
        print("Warning: Blocks not evenly divisible, truncating dimensions",
              file=sys.stderr)

    if out_rate is None:
        rate = reader.rate
        if not samerate:
            rate = rate * Fraction(g0.scaled.d, g0.block.d)
    else:
        rate = out_rate

    # checkpoint/resume: restart from the recorded slab index
    start_slab = 0
    if resume_file:
        from dspfun_tpu.utils.checkpoint import load_state  # noqa: PLC0415

        st = load_state(resume_file)
        fingerprint = repr((geoms, boost, damp, quant, threshold_min,
                            threshold_max, coeff_limit, spec, ispec,
                            preserve_dc, exprstr, dither, linear,
                            proc_fmt.name))
        if (st.get("newres") == [g0.newres.w, g0.newres.h, g0.newres.d]
                and st.get("fingerprint", fingerprint) == fingerprint):
            start_slab = int(st.get("slab", 0))
            if not quiet and start_slab:
                print(f"resuming at slab {start_slab}", file=sys.stderr)

    props = proc_props.copy()
    props.pix_fmt = proc_fmt.name
    if spec:
        props.color_range = "jpeg"
    try:
        writer = video.open_output(
            outfile, g0.newres.w, g0.newres.h, rate, props, format=oformat,
            codec=codec, options=encopts, append=start_slab > 0,
        )
    except Exception as e:  # noqa: BLE001
        print(f"Output setup failed for '{outfile}': {e}", file=sys.stderr)
        reader.close()
        return 1

    if not quiet:
        for gi, g in enumerate(geoms):
            print(f"plane {gi}: block {g.block} scaled {g.scaled} "
                  f"nblocks {g.nblocks} newres {g.newres}", file=sys.stderr)

    # the container may negotiate a different pixel format than the
    # processing format (e.g. float RGB spectrograms into y4m ->
    # yuv444p, the reference's swscale output conversion,
    # ffapi.c:497-527); convert through RGB on write when they differ
    out_convert = writer.pix_fmt.name != proc_fmt.name

    if dither and (spec or float_pixels):
        print("Warning: dithering cannot be used with spectrogram or float "
              "output, disabling.", file=sys.stderr)
        dither = False

    if offset or start_slab:
        reader.seek_frame(offset + start_slab * g0.block.d)

    import jax.numpy as jnp  # noqa: PLC0415

    params = [
        mp.MotionParams(
            spec=spec, ispec=ispec, preserve_dc=preserve_dc,
            boost=boost[i], damp=damp[i], quant=quant,
            threshold_min=threshold_min, threshold_max=threshold_max,
            coeff_limit=coeff_limit, expr=expr, dither=dither,
            linear=linear, float_pixels=float_pixels,
        )
        for i in range(proc_fmt.ncomp)
    ]
    import jax  # noqa: PLC0415

    # --mesh / DSPFUN_MESH: distribute the work over a (space, time)
    # device mesh — block batches data-parallel over 'space'; the
    # whole-clip single-block case (-b ..x..x0 with full-frame blocks)
    # Ulysses-sharded over both axes (SURVEY.md sections 2.8/5).
    if expr is not None and expr.stateful and (mesh_spec or multi):
        # random()/while()/root()/taylor()/time() evaluate per
        # coefficient in sequence on the host (reference
        # motion.c:670-681 is a host loop too) — a sharded evaluation
        # order would diverge from the reference
        print("--eval with stateful av_expr forms (random/randomi/"
              "while/root/taylor/time) is sequential; run without "
              "--mesh/--coordinator", file=sys.stderr)
        writer.close()
        reader.close()
        return 1
    mesh = None
    use_volume = [False] * proc_fmt.ncomp
    try:
        if multi:
            from dspfun_tpu.parallel import multihost  # noqa: PLC0415

            space_n = time_n = None
            for part in (mesh_spec or "auto").split(","):
                part = part.strip().lower()
                if part in ("", "auto"):
                    continue
                k, _, v = part.partition("=")
                if k == "space":
                    space_n = int(v)
                elif k == "time":
                    time_n = int(v)
                else:
                    raise ValueError(f"multi-process mesh spec {part!r}")
            mesh = multihost.global_mesh(space=space_n, time=time_n)
        else:
            from dspfun_tpu.parallel.mesh import mesh_from_spec  # noqa: PLC0415

            mesh = mesh_from_spec(mesh_spec)
    except ValueError as e:
        print(f"Bad --mesh: {e}", file=sys.stderr)
        writer.close()
        reader.close()
        return 1
    if mesh is not None:
        from dspfun_tpu.parallel import motion_sharded as msh  # noqa: PLC0415
        from dspfun_tpu.parallel import sharded as psh  # noqa: PLC0415

        for i, g in enumerate(geoms):
            use_volume[i] = (
                g.nblocks == mp.Dims(1, 1, 1)
                and g.block == g.scaled
                and msh.supports_volume_params(params[i])
                and msh.volume_mesh_compatible(
                    (g.block.d, g.block.h, g.block.w), mesh
                )
            )
        if multi and not all(use_volume):
            print("multi-process motion runs the whole-clip volume path "
                  "only: use -b 0x0x0 (or a geometry where every plane "
                  "is one whole-clip block) with a compatible mesh",
                  file=sys.stderr)
            writer.close()
            reader.close()
            return 1
        if not quiet:
            strategies = ", ".join(
                f"plane {i}: {'volume' if v else 'blocks'}"
                for i, v in enumerate(use_volume)
            )
            print(f"mesh: space={mesh.shape['space']} "
                  f"time={mesh.shape['time']} ({strategies})", file=sys.stderr)
    elif multi:
        print("multi-process motion requires --mesh", file=sys.stderr)
        writer.close()
        reader.close()
        return 1

    # device-resident transform plans (re-uploading basis matrices per
    # slab would waste host->device bandwidth); pruned i8 Kronecker
    # plans ride along for fused fast-path geometries with sparse
    # bandpass supports (mp.maybe_kron_plans).  Cached across
    # invocations in-process: repeat runs with the same geometry (the
    # benchmark suite's warm+timed pair, batch jobs over many clips)
    # skip the host basis build AND the plan upload
    # value-based keys: MotionParams._key() hashes the expr by SOURCE —
    # repr(p) would embed the Expr object's memory address and miss the
    # cache on every --eval run (round-5 review finding)
    # the active Precision is part of the key: make_plans() sizes its
    # digit splits from get_precision(), so a second in-process run
    # under a different DSPFUN_PRECISION must not reuse these plans
    from dspfun_tpu.core.precision import get_precision  # noqa: PLC0415

    pkey = (jax.default_backend(), get_precision(),
            tuple(repr(g) for g in geoms), tuple(p._key() for p in params))
    plans = _PLAN_CACHE.get(pkey)
    if plans is None:
        plans = jax.device_put([
            (*mp.make_plans(g), mp.maybe_kron_plans(g, params[i]))
            for i, g in enumerate(geoms)
        ])
        while len(_PLAN_CACHE) >= 4:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        _PLAN_CACHE[pkey] = plans
    bcoords = []
    for g in geoms:
        nb = g.nblocks.w * g.nblocks.h
        bidx = np.arange(nb, dtype=np.int32)
        bcoords.append((jnp.asarray(bidx % g.nblocks.w),
                        jnp.asarray(bidx // g.nblocks.w)))

    def read_proc_planes():
        """One frame in processing format, stored pel units (8-bit:
        0..255 in the *processing* color range; float formats: x255)."""
        if convert:
            rgb = reader.read_frame_rgb()
            if rgb is None:
                return None
            planes = video.rgb_to_planes(rgb, proc_fmt, props)
            if float_pixels:
                return [p * 255.0 for p in planes]
            return [video.plane_to_pel(p, proc_fmt, i, props.color_range)
                    for i, p in enumerate(planes)]
        planes = reader.read_frame(raw=not float_pixels)
        if planes is None:
            return None
        if float_pixels:
            return [p * 255.0 for p in planes]
        return planes

    coded = 0
    # single-device paths defer the coded-count fetch: syncing the
    # count per plane per slab costs a blocking device round-trip each
    # AND serialises the slab pipeline (the overlap of
    # slab N's download with slab N+1's compute needs the dispatch
    # stream to run ahead); device scalars accumulate here and one
    # fetch at EOF settles the total
    coded_dev: list = []
    written = start_slab * g0.scaled.d
    read_count = start_slab * g0.block.d
    ret = 0
    padb = int(math.log10(max(source_d, 1))) + 1
    pads = int(math.log10(max(g0.newres.d, 1))) + 1
    # per-stage wall-time accounting for the slab loop (DSPFUN_TIMINGS):
    # read = container decode + de-block on the host, stage = H2D +
    # dispatch, sync = deferred device fetches, write = D2H + host mux
    stage_s = {"read": 0.0, "stage+dispatch": 0.0, "write": 0.0}

    def _acct(key, t0):
        stage_s[key] += time.perf_counter() - t0

    # one-slab lookahead for the packed emission path: slab N's
    # device->host download overlaps slab N+1's read+compute (same
    # pattern as models/scan_pipeline.scan_chunks / tools/zoom.py)
    pending_pack = None

    def flush_pack():
        nonlocal written, pending_pack
        t0 = time.perf_counter()
        payload_dev, nfr, pbz = pending_pack
        pending_pack = None
        payload = np.asarray(payload_dev)
        for z in range(nfr):
            writer.write_frame_payload(payload[z].tobytes())
            written += 1
            if not quiet:
                print(f"\rread: {read_count:>{padb}} wrote: "
                      f"{written:>{pads}}", end="", file=sys.stderr)
        _acct("write", t0)
        if resume_file:
            from dspfun_tpu.utils.checkpoint import save_state  # noqa: PLC0415

            save_state(resume_file, {
                "slab": pbz + 1,
                "newres": [g0.newres.w, g0.newres.h, g0.newres.d],
                "fingerprint": fingerprint,
            })

    # --slab-batch: how many consecutive slabs' blocks run as ONE
    # filter_blocks dispatch per plane (single-device block path only;
    # mesh/multi keep their per-slab collectives and staging).  Exact:
    # blocks are independent across slabs and bz rides per-block into
    # the --eval environment.  Batching amortises the per-dispatch cost
    # and fills the matmuls' block (M) dimension on the kron fast paths.
    if slab_batch == "auto":
        # auto = 2 when any plane carries kron plans, else per-slab (a
        # choice not yet measured on the GPU); N is always available
        # explicitly.
        slab_b = 2 if any(p[-1] is not None for p in plans) else 1
    else:
        slab_b = max(1, int(slab_batch))
    if mesh is not None or multi:
        slab_b = 1
    if slab_b > 1 and expr is not None and expr.stateful:
        # batched slabs evaluate the host expression plane-major across
        # the batch, which would consume random()/st() state in a
        # different order than the reference's per-slab loop — keep the
        # coefficient-visit order exact instead (the stateful host
        # round-trip dominates the runtime here anyway)
        if slab_batch != "auto" and not quiet:
            print("note: --slab-batch ignored (stateful --eval keeps "
                  "the per-slab evaluation order)", file=sys.stderr)
        slab_b = 1

    def read_slab():
        """block.d frames in processing form, or None at EOF."""
        nonlocal read_count
        t0 = time.perf_counter()
        slab = []
        for _z in range(g0.block.d):
            planes = read_proc_planes()
            if planes is None:
                _acct("read", t0)
                return None
            slab.append(planes)
            read_count += 1
            if not quiet:
                print(f"\rread: {read_count:>{padb}} wrote: "
                      f"{written:>{pads}}", end="", file=sys.stderr)
        _acct("read", t0)
        return slab

    _bc_tiled: dict = {}

    def compute_block_slabs(slabs, bz0):
        """Per-slab out_planes lists for S consecutive slabs starting at
        bz0 — the single-device block path, batched per plane."""
        t0 = time.perf_counter()
        S = len(slabs)
        outs = [[] for _ in range(S)]
        for i, g in enumerate(geoms):
            per = []
            for slab in slabs:
                frames = np.stack([slab[z][i] for z in range(g.block.d)])
                blocks = mp.frames_to_blocks(frames, g)
                if blocks.dtype.kind not in "ui":
                    # float pels stage as f32; integer pels keep their
                    # native dtype across H2D and cast on device
                    blocks = blocks.astype(np.float32, copy=False)
                per.append(blocks)
            nb = per[0].shape[0]
            if S > 1:
                big = np.concatenate(per)
                key = (i, S)
                if key not in _bc_tiled:
                    bxs, bys = bcoords[i]
                    _bc_tiled[key] = (jnp.tile(bxs, S), jnp.tile(bys, S))
                bc = _bc_tiled[key]
                bzv = jnp.asarray(np.repeat(
                    np.arange(bz0, bz0 + S, dtype=np.int32), nb))
            else:
                big, bc, bzv = per[0], bcoords[i], jnp.asarray(bz0)
            out, c = mp.filter_blocks(
                jnp.asarray(big), plans[i], bc, bzv, geom=g,
                params=params[i], plane_index=i, nplanes=proc_fmt.ncomp,
            )
            coded_dev.append(c)  # deferred fetch (see coded_dev above)
            # blocks_to_frames is pure reshape/transpose: applied to the
            # device array it stays on device for the packed emission
            for s in range(S):
                outs[s].append(
                    mp.blocks_to_frames(out[s * nb:(s + 1) * nb], g))
        _acct("stage+dispatch", t0)
        return outs

    out_queue: list = []
    eof = False
    # payloads of the current batch awaiting one merged D2H: each
    # transfer carries a fixed cost on top of the wire time, so the
    # packed path downloads a batch's slabs as ONE device-concatenated
    # payload instead of one fetch per slab
    batch_pays: list = []
    batch_n = 1
    try:
        for bz in range(start_slab, g0.nblocks.d):
            if out_queue:
                out_planes = out_queue.pop(0)
            elif mesh is None:
                staged = []
                if not eof:
                    for _s in range(min(slab_b, g0.nblocks.d - bz)):
                        s_ = read_slab()
                        if s_ is None:
                            eof = True
                            break
                        staged.append(s_)
                if not staged:
                    if pending_pack is not None:
                        flush_pack()  # the previous slab completed
                    print("Error reading frame: end of stream", file=sys.stderr)
                    ret = 1
                    return ret
                out_queue.extend(compute_block_slabs(staged, bz))
                batch_n = len(staged)
                out_planes = out_queue.pop(0)
            else:
                slab = read_slab()
                if slab is None:
                    if pending_pack is not None:
                        flush_pack()  # the previous slab completed
                    print("Error reading frame: end of stream", file=sys.stderr)
                    ret = 1
                    return ret
                out_planes = []
                for i, g in enumerate(geoms):
                    frames = np.stack([slab[z][i] for z in range(g.block.d)])
                    if use_volume[i]:
                        # integer pels stage in their native dtype (4x
                        # less H2D for u8 sources; the jitted chain
                        # casts on device), float pels as f32
                        vol_np = np.ascontiguousarray(
                            frames[: g.block.d, : g.truncated.h,
                                   : g.truncated.w])
                        if vol_np.dtype.kind not in "ui":
                            vol_np = vol_np.astype(np.float32, copy=False)
                        if multi:
                            # every process read the whole clip; stage
                            # only this host's time-contiguous slab (the
                            # DCN exchange happens inside make_array_
                            # from_process_local_data / the Ulysses
                            # all_to_alls)
                            tl = g.block.d // jax.process_count()
                            pid = jax.process_index()
                            vol = jax.make_array_from_process_local_data(
                                msh.volume_sharding(mesh),
                                vol_np[pid * tl : (pid + 1) * tl],
                            )
                        else:
                            vol = jax.device_put(jnp.asarray(vol_np),
                                                 msh.volume_sharding(mesh))
                        out, c = msh.motion_filter_volume_sharded(
                            vol, mesh, geom=g, params=params[i],
                            plane_index=i, nplanes=proc_fmt.ncomp, bz=bz,
                        )
                        if multi:
                            import jax.experimental.multihost_utils as mhu  # noqa: PLC0415

                            out = mhu.process_allgather(out, tiled=True)
                        coded += msh.coded_count(c)
                        out_planes.append(np.asarray(out))
                        continue
                    blocks = mp.frames_to_blocks(frames, g)
                    if blocks.dtype.kind not in "ui":
                        # float pels stage as f32; integer pels keep
                        # their native dtype across H2D, cast on device
                        blocks = blocks.astype(np.float32, copy=False)
                    out, c = psh.shard_blocks_filter(
                        jnp.asarray(blocks), plans[i],
                        bcoords[i], jnp.asarray(bz), mesh,
                        geom=g, params=params[i],
                        plane_index=i, nplanes=proc_fmt.ncomp,
                    )
                    coded_dev.append(c)  # deferred fetch (coded_dev)
                    # blocks_to_frames is pure reshape/transpose: on the
                    # device array it stays on device for packed emission
                    out_planes.append(mp.blocks_to_frames(out, g))
            # indivisible block grids truncate a plane's processed
            # region (reference warns and leaves the surplus rows of
            # its frame buffer stale, motion.c:437-439); pad emitted
            # planes to the container's plane dims with zeros — the
            # deterministic analogue
            tdims = proc_fmt.plane_dims(g0.newres.w, g0.newres.h)
            for i, p in enumerate(out_planes):
                tw, th = tdims[i] if i < len(tdims) else tdims[-1]
                ph, pw = p.shape[1], p.shape[2]
                if (ph, pw) != (th, tw):
                    xp = np if isinstance(p, np.ndarray) else jnp
                    out_planes[i] = xp.pad(
                        p, ((0, 0), (0, max(th - ph, 0)),
                            (0, max(tw - pw, 0))))[:, :th, :tw]
            # pane-free single-device runs pack the slab's frames to
            # container payload bytes ON DEVICE (io/device_pack):
            # emission crosses D2H already quantised and the host only
            # writes bytes (the motion analogue of scan/zoom's round-4
            # packed paths; per-plane geometry, no RGB conversion)
            if (not out_convert and not multi and mesh is None
                    and writer.supports_payload()):
                from dspfun_tpu.io.device_pack import (  # noqa: PLC0415
                    pack_motion_planes,
                )

                payload_dev = pack_motion_planes(
                    out_planes, writer.pix_fmt, writer.props.color_range,
                    float_pixels, g0.scaled.d)
                batch_pays.append(payload_dev)
                if len(batch_pays) < batch_n:
                    continue  # wait for the rest of the batch
                if len(batch_pays) == 1:
                    pay = batch_pays[0]
                else:
                    pay = _concat_payloads(batch_pays)
                nfr_total = g0.scaled.d * len(batch_pays)
                batch_pays = []
                try:
                    pay.copy_to_host_async()
                except AttributeError:
                    pass
                if pending_pack is not None:
                    flush_pack()
                pending_pack = (pay, nfr_total, bz)
                continue
            out_planes = [np.asarray(p) for p in out_planes]
            for z in range(g0.scaled.d):
                frame = []
                for i, g in enumerate(geoms):
                    zz = min(z, g.scaled.d - 1)
                    p = out_planes[i][zz]
                    frame.append(p / 255.0 if float_pixels else p)
                if out_convert:
                    unit = [
                        f if float_pixels
                        else video.plane_from_pel(f, proc_fmt, i,
                                                  props.color_range)
                        for i, f in enumerate(frame)
                    ]
                    rgb = video.planes_to_rgb(unit, proc_fmt, props,
                                              g0.newres.w, g0.newres.h)
                    writer.write_frame_rgb(rgb)
                else:
                    writer.write_frame(frame, raw=not float_pixels)
                written += 1
                if not quiet:
                    print(f"\rread: {read_count:>{padb}} wrote: "
                          f"{written:>{pads}}", end="", file=sys.stderr)
            if resume_file:
                from dspfun_tpu.utils.checkpoint import save_state  # noqa: PLC0415

                save_state(resume_file, {
                    "slab": bz + 1,
                    "newres": [g0.newres.w, g0.newres.h, g0.newres.d],
                    "fingerprint": fingerprint,
                })
        if pending_pack is not None:
            flush_pack()
    finally:
        if not quiet:
            print(file=sys.stderr)
        writer.close()
        reader.close()
    if coded_dev:
        coded += int(sum(int(np.asarray(c).sum()) for c in coded_dev))
        coded_dev.clear()
    # programmatic access for the benchmark suite's CLI breakdown
    globals()["LAST_STAGE_TIMES"] = dict(stage_s)
    from dspfun_tpu.utils.profiling import timings_enabled  # noqa: PLC0415

    if timings_enabled():
        total = sum(stage_s.values())
        parts = ", ".join(f"{k} {v:.3f}s" for k, v in stage_s.items())
        print(f"[dspfun] motion slab loop: {parts} "
              f"(accounted {total:.3f}s; read = container decode + "
              "de-block, stage+dispatch = H2D + jit dispatch, write = "
              "D2H fetch + host mux)", file=sys.stderr)

    if quant and not quiet:
        total = sum(g.newres.volume() for g in geoms)
        print(f"coeffs: {coded} / {total} ({coded * 100.0 / total:2.0f}%)\n"
              f"zeroes: {total - coded} / {total} "
              f"({(total - coded) * 100.0 / total:2.0f}%)", file=sys.stderr)
    return ret


if __name__ == "__main__":
    from dspfun_tpu.tools import run_main

    run_main(main)
