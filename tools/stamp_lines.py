#!/usr/bin/env python3
"""Prefixes each line of standard input with the seconds since this
script started (lines cut to 160 characters), to read where a long run
spends its time, e.g.

    set -o pipefail; python3 chip_smoke.py 2>&1 | python3 tools/stamp_lines.py
"""

import sys
import time


def main() -> None:
    t0 = time.time()
    for line in sys.stdin:
        text = line.rstrip("\n")
        sys.stdout.write(f"{time.time() - t0:8.1f} {text[:160]}\n")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
