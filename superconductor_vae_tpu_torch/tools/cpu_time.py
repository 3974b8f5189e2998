#!/usr/bin/env python3
"""Runs one command and prints its wall seconds and the CPU seconds (user
and system) of it and every process it waited for, as ``/usr/bin/time``
reports them, for boxes that lack that tool:

    python3 superconductor_vae_tpu_torch/tools/cpu_time.py -- \\
        python -m pytest tests/test_torch_port_*.py -q -p xdist -n 6 --dist loadfile

The command's own output passes through; the last line is one JSON object
``{"wall_s", "user_s", "sys_s", "cpu_s", "max_rss_mib", "rc"}``.  Exits
with the command's code.
"""

from __future__ import annotations

import json
import resource
import subprocess
import sys
import time


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ['--']:
        argv = argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    rc = subprocess.call(argv)
    wall = time.perf_counter() - t0
    ru = resource.getrusage(resource.RUSAGE_CHILDREN)
    print(json.dumps({'wall_s': round(wall, 1), 'user_s': round(ru.ru_utime, 1),
                      'sys_s': round(ru.ru_stime, 1),
                      'cpu_s': round(ru.ru_utime + ru.ru_stime, 1),
                      'max_rss_mib': round(ru.ru_maxrss / 1024, 1), 'rc': rc}))
    return rc


if __name__ == '__main__':
    sys.exit(main())
