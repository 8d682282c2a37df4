"""Console output for the launch CLIs (port of
``repro/launch/console.py``).

Library code under ``repro_torch`` does not ``print``: stray stdout from
an imported module corrupts machine-read output.  The launch entry
points are the one place meant to talk to a terminal, and they do it
through :func:`emit` so the intent is explicit at every call site.
"""
from __future__ import annotations

import sys


def emit(*parts, sep: str = " ") -> None:
    """Write one line to stdout (the CLI reporting channel)."""
    sys.stdout.write(sep.join(str(p) for p in parts) + "\n")
