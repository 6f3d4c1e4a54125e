"""Command-line tools mirroring the reference binaries' flag surfaces.

Each module exposes ``main(argv) -> int`` and is runnable via
``python -m dspfun_tpu.tools.<name>`` or the ``dspfun`` dispatcher.
"""

import os
import sys


def run_main(main) -> None:
    """CLI entry wrapper: profiling hook + flush + exit without
    interpreter teardown.

    DSPFUN_PROFILE=<dir> captures a jax.profiler trace around the run;
    DSPFUN_TIMINGS=1 prints the total wall time.  Outputs are already
    flushed to disk by ``main``, so the process exits without
    interpreter teardown.
    """
    from dspfun_tpu.utils.profiling import maybe_profile, stage

    with maybe_profile(), stage("total"):
        code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def parse_pair(arg: str, conv=int):
    """Parse the WxH pair syntax shared by applybasis/genbasis/draw."""
    w, _, h = arg.partition("x")
    if not w or not h:
        raise ValueError(f"expected WxH, got {arg!r}")
    return conv(w), conv(h)
