"""Demo: the embedded-stream property as an animation, the port of
``examples/progressive_gif.py``.

Encodes once at the max bitrate, then decodes byte PREFIXES at many bpp
levels (the reference's make_gif.py flow) — no re-encoding, pure stream
truncation — and writes a GIF. Equivalent one-liner:

    python -m spiht_tpu_torch.cli progressive IMAGE OUT.gif --frames 40

    python -m spiht_tpu_torch.examples.progressive_gif IMAGE [OUT.gif] [--device DEV]
"""

from __future__ import annotations

import argparse
import os
import tempfile

from .. import cli


def main(argv=None) -> int:
    """Returns the command line's exit code."""
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0].replace("\n", " "))
    p.add_argument("image")
    p.add_argument("out", nargs="?",
                   default=os.path.join(tempfile.gettempdir(),
                                        "progressive.gif"))
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    dev = [] if args.device is None else ["--device", args.device]
    return cli.main(["progressive", args.image, args.out, "--frames", "40",
                     "--bpp", "2.0"] + dev)


if __name__ == "__main__":
    raise SystemExit(main())
