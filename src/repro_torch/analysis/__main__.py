"""Module entrypoint: ``python -m repro_torch.analysis``. Unlike the
reference's it forces no device count: the pipelined probe's mesh is a
set of stream slots on one device."""

import sys

from repro_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
