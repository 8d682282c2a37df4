#!/usr/bin/env python3
"""Run a checkout's ``chip_smoke.py`` with each phase's seconds printed,
for a checkout whose script does not print them itself (to compare two
checkouts phase by phase on one host).

    python3 tools/smoke_phase_times.py DIR

Imports ``DIR/chip_smoke.py``, wraps each of its ``phase_*`` functions in
a wall clock (a phase called inside another counts in the outer one
only), runs its ``main()``, prints ``[phase_NAME] wall: S s`` after each
outermost phase and ``[phases] total: S s`` at the end, and exits with
``main()``'s code.
"""
from __future__ import annotations

import os
import pathlib
import sys
import time


def main() -> int:
    tree = pathlib.Path(sys.argv[1]).resolve()
    os.chdir(tree)
    sys.path.insert(0, str(tree))
    sys.argv = [str(tree / "chip_smoke.py")]
    import chip_smoke as cs
    depth, total = [0], [0.0]

    def clocked(name, fn):
        def phase(*args, **kwargs):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    spent = time.perf_counter() - t0
                    total[0] += spent
                    print(f"[{name}] wall: {spent:.2f} s", flush=True)
        return phase

    for name in [n for n in vars(cs) if n.startswith("phase_")]:
        setattr(cs, name, clocked(name, getattr(cs, name)))
    rc = cs.main()
    print(f"[phases] total: {total[0]:.2f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
