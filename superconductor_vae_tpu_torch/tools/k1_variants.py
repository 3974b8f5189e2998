#!/usr/bin/env python3
"""Builds variants of K1, the decode-step attention (csrc/decode_attention.cu),
checks each against the plain version and times each, in one process on one
NVIDIA GPU:

    python3 superconductor_vae_tpu_torch/tools/k1_variants.py

A variant is the source with one or more lines replaced (each replacement
must match, or the script stops), built by nvcc into build/k1_variants/
with the port's flags:
  - kept:           128 threads a block (4 warps, each 8 slots of a 32-slot
                    tile), two work units in flight a warp, as many blocks
                    as fit on the card, each working through every
                    gridDim-th (b, h); the compiler asked for 4 resident
                    blocks an SM (<= 128 registers);
  - stages3:        three work units in flight a warp;
  - row_per_block:  one block per group of rows (the grid is B*H at T=30);
  - no_split:       four warps a row at every position (kept: 1, 2 or 4,
                    the fewest whose 8 slots a warp cover pos + 1);
  - threads64:      64 threads a block (16-slot tiles);
  - threads256:     256 threads a block (64-slot tiles);
  - blocks1, blocks6: 1 or 6 resident blocks asked for;
  - no_min_blocks:  no count of resident blocks asked for;
  - flat_fetch:     each lane fetches every 32nd chunk of the warp's slice
                    in order (a division by the row length a chunk), where
                    kept has lanes own a row's chunks and walk the rows;
  - fetch_only:     diagnostic, not checked: the fetches and nothing else;
  - empty:          diagnostic, not checked: every block returns at once;
  - no_writes:      diagnostic, not checked: no output and no cache row
                    written (the results kept alive by a test);
  - no_barriers:    diagnostic, not checked: the combine without its two
                    block barriers (a race: the output is not right).
Prints each variant's ptxas registers/spills and SASS counts (the DHP 72
float32 instances), its largest error against the plain version over T {1,
30, 38, 257} x Dh {64, 72, 128, 256, 66} at the last position and on
both sides of a tile edge (tolerance chip_smoke.K1_TOL; a variant that
cannot launch at some shape is reported and not timed), and its device
time, L2-cold, at H=8, Dh=72: float32 B=256 and 1024 at T=30, position
29; bfloat16 B=256 at the same; float32 B=64 at T=257, position 256; and
float32 B=64, 128 and 512 at T=30, position 29; float32 B=256 at
positions 3 and 12; bfloat16 at bench.py's probe (B=512, T=38, position
19); in two rounds over all
variants, with the card's name and power limit.  About a minute on the
card.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / 'superconductor_vae_tpu_torch' / 'csrc' / 'decode_attention.cu'
OUT = ROOT / 'build' / 'k1_variants'

THREADS = 'constexpr int kThreads = 128;'
STAGES = 'constexpr int kStages = 2;'
BLOCKS = 'constexpr int kMinBlocks = 4;'
BOUNDS = '__launch_bounds__(kThreads, kMinBlocks)'
GRID = 'const int grid = static_cast<int>(groups < fill ? groups : fill);'
SPLIT = 'const bool full = Split<false>(pos).shift == kLogWarps;'
WAIT = '    __syncwarp();                      // and the warp\'s\n'
ROWWISE = """#pragma unroll
    for (int r = 0; r < kWarpSlots; ++r) {   // lanes over a row's chunks
      if (r < rows) {
        const bool is_new = t0 + r == pos;
        const Raw* krow = is_new ? reinterpret_cast<const Raw*>(k_new) + bh * nv : kc + r * nv;
        const Raw* vrow = is_new ? reinterpret_cast<const Raw*>(v_new) + bh * nv : vc + r * nv;
#pragma unroll
        for (int j = 0; j < C::kLaneChunks; ++j) {
          const int c = lane + 32 * j;
          if (c < nv) {
            fetch(ks + r * C::kKPitch + c, krow + c);
            fetch(vs + r * NVP + c, vrow + c);
          }
        }
      }
    }
"""
FLAT = """#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {         // lanes over the slice's chunks in order
      Raw* dst = kv ? vs : ks;
      const int pitch = kv ? NVP : C::kKPitch;
      const Raw* cache = kv ? vc : kc;
      const Raw* row_new = reinterpret_cast<const Raw*>(kv ? v_new : k_new) + bh * nv;
#pragma unroll 8
      for (int k = 0; k < (kWarpSlots * NVP + 31) / 32; ++k) {
        const int i = lane + 32 * k, r = i / NVP, c = i % NVP;
        if (r < rows && c < nv)
          fetch(dst + r * pitch + c, t0 + r == pos ? row_new + c : cache + r * nv + c);
      }
    }
"""
STORE = '            orow[c] = pack<T, E, Raw>(o);'
IN_PLACE = '      if (rows > 0 && (warp & ((1 << sp.shift) - 1)) == r_pos / kWarpSlots) {'
FIRST = '  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n'
VARIANTS = {
    'kept': [],
    'stages3': [(STAGES, 'constexpr int kStages = 3;')],
    'row_per_block': [(GRID, 'const int grid = groups + 0 * fill;')],
    'no_split': [(SPLIT, 'const bool full = pos >= 0;')],
    'threads64': [(THREADS, 'constexpr int kThreads = 64;')],
    'threads256': [(THREADS, 'constexpr int kThreads = 256;')],
    'blocks1': [(BLOCKS, 'constexpr int kMinBlocks = 1;')],
    'blocks6': [(BLOCKS, 'constexpr int kMinBlocks = 6;')],
    'no_min_blocks': [(BOUNDS, '__launch_bounds__(kThreads)')],
    'flat_fetch': [(ROWWISE, FLAT)],
    # diagnostics, timed but not checked: the fetches alone, and a kernel
    # that returns at once (launch and block scheduling)
    'fetch_only': [(WAIT, WAIT + '    continue;\n')],
    'empty': [(FIRST, '  if (pos >= 0) return;\n' + FIRST)],
    'no_writes': [(STORE, '            if (o[0] == 1234.5f)\n  ' + STORE),
                  (IN_PLACE, IN_PLACE.replace(') {', ' && pos < 0) {'))],
    'no_barriers': [('      __syncthreads();\n      // warp j', '      // warp j'),
                    ('      __syncthreads();                 // the combine space is free again\n',
                     '')],
}
UNCHECKED = ('fetch_only', 'empty', 'no_writes', 'no_barriers')
CHECK_T = (1, 30, 38, 257)
CHECK_DH = (64, 72, 128, 256, 66)
# (dtype, B, T, position) at H=8, Dh=72
TIMED = [('float32', 256, 30, 29), ('float32', 1024, 30, 29), ('bfloat16', 256, 30, 29),
         ('float32', 64, 257, 256), ('float32', 64, 30, 29), ('float32', 128, 30, 29),
         ('float32', 512, 30, 29), ('float32', 256, 30, 3), ('float32', 256, 30, 12),
         ('bfloat16', 512, 38, 19)]


def sources():
    """{name: source} of every variant; stops if a replacement does not match."""
    out = {}
    for name, subs in VARIANTS.items():
        src = SRC.read_text()
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f'variant {name}: {old!r} is not in {SRC.name}')
            src = src.replace(old, new)
        out[name] = src
    return out


def build(nvcc, flags):
    """One nvcc per variant, all started together -> {name: library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources().items():
        cu, so = OUT / f'{name}.cu', OUT / f'{name}.so'
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen([nvcc, *flags, '-o', str(so), str(cu)],
                                            stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        so.with_name(so.name + '.log').write_text(log)
        if proc.returncode:
            raise RuntimeError(f'variant {name}: nvcc failed:\n{log}')
        libs[name] = so
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('k1_variants: needs a CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    import chip_smoke as cs
    from superconductor_vae_tpu_torch.ops import _build
    from superconductor_vae_tpu_torch.ops import decode_attention as da

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip())
    nvcc = _build.nvcc()
    libs = build(nvcc, _build.NVCC_FLAGS)
    fns = {}
    for name, so in libs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                cs.build_report({'decode_attention': so}, nvcc)
            except RuntimeError as e:      # a spill is reported, not fatal, here
                print(f'build_report: {e}')
        for line in buf.getvalue().splitlines():
            if 'decode_attention_kernel<float, 4, 18,' in line or 'build_report' in line:
                print(f'{name}: {line}')
        fns[name] = da.bind(ctypes.CDLL(str(so)))

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {'float32': torch.float32, 'bfloat16': torch.bfloat16}

    def inputs(b, t, dh, dtype):
        return ([torch.randn(b, 8, dh, generator=gen, device=dev).to(dtype) for _ in range(3)]
                + [torch.randn(b, 8, t, dh, generator=gen, device=dev).to(dtype)
                   for _ in range(2)])

    def use(name):
        da._launchers = lambda: fns[name]

    def held(name):
        """Largest error of variant ``name`` against the plain version, per
        dtype; None if it cannot launch at some shape (too much shared
        memory, say)."""
        use(name)
        worst = dict.fromkeys(dtypes, 0.0)
        for dname, dtype in dtypes.items():
            for t in CHECK_T:
                for dh in CHECK_DH:
                    for position in sorted({t - 1, min(t - 1, 32), min(t - 1, 64)}):
                        q, kn, vn, kc, vc = inputs(3, t, dh, dtype)
                        kr, vr = kc.clone(), vc.clone()
                        try:
                            out = da.decode_step_attention(q, kn, vn, kc, vc, position)
                        except RuntimeError as e:
                            print(f'check {name}: {dname} T={t} Dh={dh}: {e}')
                            return None
                        ref = da.decode_step_attention_ref(q, kn, vn, kr, vr, position)
                        cs.check(torch.allclose(out.float(), ref.float(), **cs.K1_TOL[dname])
                                 and torch.equal(kc, kr) and torch.equal(vc, vr),
                                 f'variant {name} disagrees at {dname} T={t} Dh={dh} '
                                 f'pos={position}')
                        worst[dname] = max(worst[dname],
                                           (out.float() - ref.float()).abs().max().item())
        return worst

    failed = set()
    for name in libs:
        if name not in UNCHECKED:
            worst = held(name)
            if worst is None:
                failed.add(name)
            else:
                print(f'check {name}: max_abs_err {worst}')

    for dname, b, t, position in TIMED:
        dtype = dtypes[dname]
        per_set = 2 * b * 8 * t * 72 * torch.empty((), dtype=dtype).element_size()
        sets = [inputs(b, t, 72, dtype) for _ in range(max(2, -(-int(cs.L2_COLD_BYTES) // per_set)))]
        nbytes, _ = cs.k1_bytes_ops(b, 8, 72, position, sets[0][0].element_size())
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        times = {}
        for _ in range(2):
            for name in libs:
                if name in failed:
                    continue
                use(name)
                try:
                    ms = cs.device_ms(
                        torch, lambda *a: da.decode_step_attention(*a, position), sets)[0]
                except RuntimeError:      # the host fell behind the device: no time
                    ms = float('nan')
                times.setdefault(name, []).append(ms)
        print(f'time {dname} B={b} T={t} pos={position} (bound {bound * 1e3:.2f} us): ' + ', '.join(
            f'{name} {" / ".join(f"{x * 1e3:.2f}" for x in ms)} us' for name, ms in times.items()))
        del sets
    return 0


if __name__ == '__main__':
    sys.exit(main())
