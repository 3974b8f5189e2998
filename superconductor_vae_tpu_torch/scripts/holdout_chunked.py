"""Chunked holdout-campaign driver (port of scripts/holdout_chunked.py):

    python -m superconductor_vae_tpu_torch.scripts.holdout_chunked \\
        --checkpoint <dir> --stream outputs/holdout_stream.jsonl --chunk 5 \\
        [--pallas-decode] [-- <more holdout_search flags>]

Runs the campaign as a sequence of short subprocesses of the holdout
search CLI: before each it rereads the stream and runs the first
contiguous run of missing targets, at most ``--chunk`` of them
(``next_chunk``), so that a chunk cut short heals itself on the next
pass; each subprocess appends its finished targets to the same stream.
It stops when every target is streamed, or with exit code 1 after
``--max-retries`` chunks in a row that streamed nothing.  The weights'
sources, ``--cpu`` and ``--pallas-decode`` pass to every subprocess, and
the arguments after ``--`` verbatim.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def done_indices(stream: Path) -> set:
    idx = set()
    if stream.exists():
        for line in stream.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                idx.add(int(json.loads(line)['index']))
            except (ValueError, KeyError):
                continue
    return idx


def next_chunk(done: set, n_total: int, chunk: int):
    """The first contiguous run of missing target indices, capped at
    ``chunk``: ``(offset, n)``, or None when the campaign is complete."""
    missing = [i for i in range(n_total) if i not in done]
    if not missing:
        return None
    lo = missing[0]
    n = 1
    while n < chunk and lo + n < n_total and lo + n not in done:
        n += 1
    return lo, n


def main(argv=None) -> int:
    from superconductor_vae_tpu_torch.scripts.holdout_campaign import run_search, source_argv
    from superconductor_vae_tpu_torch.scripts.holdout_search import add_source_args
    p = argparse.ArgumentParser()
    add_source_args(p)
    p.add_argument('--stream', required=True)
    p.add_argument('--n-total', type=int, default=45, help='total holdout targets')
    p.add_argument('--chunk', type=int, default=5, help='targets per subprocess')
    p.add_argument('--max-retries', type=int, default=3,
                   help='stop if this many chunks in a row make no stream progress')
    args, fwd = p.parse_known_args(argv)
    if args.params and not args.meta:
        p.error('--params needs --meta')
    if fwd and fwd[0] == '--':
        fwd = fwd[1:]

    stream = Path(args.stream)
    stalls = 0
    while True:
        done = done_indices(stream)
        nxt = next_chunk(done, args.n_total, args.chunk)
        if nxt is None:
            print(f'[chunked] campaign complete: {args.n_total} targets')
            return 0
        lo, n = nxt
        print(f'[chunked] {len(done)}/{args.n_total} done; launching offset={lo} n={n}',
              flush=True)
        rc = run_search(source_argv(args) + [
            '--target-offset', str(lo), '--n-targets', str(n), '--stream', str(stream),
            '--out', str(stream.parent / f'holdout_chunk{lo}.json'), *fwd])
        if len(done_indices(stream)) == len(done):
            stalls += 1
            print(f'[chunked] chunk rc={rc} made no progress ({stalls}/{args.max_retries})',
                  flush=True)
            if stalls >= args.max_retries:
                print('[chunked] aborting: repeated no-progress chunks')
                return 1
        else:
            stalls = 0


if __name__ == '__main__':
    sys.exit(main())
