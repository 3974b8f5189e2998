"""Caps torch's intra-op threads for the port's tests: every
tests/test_torch_port_*.py imports this module first.

The port's tests run tiny models, which gain little from more threads,
and the suite runs in several processes at once (pytest-xdist), where
torch's default of one thread a core in each process oversubscribes the
cores: the threads spin waiting for each other and starve the processes
beside them.  One thread a process does the same work in less CPU time.
"""

import torch

THREADS = 1

torch.set_num_threads(THREADS)
