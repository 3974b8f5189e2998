#!/usr/bin/env python3
"""Builds variants of K2's float32 instance (csrc/flash_attention.cu), checks
each against the plain version and times each beside torch's float32
scaled_dot_product_attention, in one process on one NVIDIA GPU:

    python3 superconductor_vae_tpu_torch/tools/k2_f32_variants.py

A variant is the source with one or two lines replaced (each replacement
must match, or the script stops), built by nvcc into build/k2_variants/
with the port's flags:
  - kept:       the source as it is;
  - cvt:        hi and lo both rounded with cvt.rna.tf32.f32;
  - trunc:      hi truncated to TF32 (one AND), lo = x - hi;
  - keys32:     32-key tiles at DHP 72, two blocks an SM;
  - keys32x3:   32-key tiles at DHP 72, three blocks an SM (168 registers).
Prints each variant's ptxas registers/spills and SASS counts, its largest
error over Dh {64, 72, 80, 96, 128, 200, 256, 66, 70} x T {1, 17, 64, 65,
100, 129, 256} x (B, H) {(1, 1), (2, 3)} (tolerance chip_smoke.K2_TOL), and
its device time at B=64, H=8, Dh=72, T in {128, 256}, in two rounds over
all variants, with the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / 'superconductor_vae_tpu_torch' / 'csrc' / 'flash_attention.cu'
OUT = ROOT / 'build' / 'k2_variants'

SPLIT = '''  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));'''
KEYS = ('static constexpr int kKeys = DHP <= 72 ? 64 : 32;',
        'static constexpr int kKeys = 32;')
VARIANTS = {
    'kept': [],
    'cvt': [(SPLIT, '''  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));''')],
    'trunc': [(SPLIT, '''  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));''')],
    'keys32': [KEYS],
    'keys32x3': [KEYS, ('kMinBlocks = DHP <= 128 ? 2 : 1;',
                        'kMinBlocks = DHP <= 72 ? 3 : DHP <= 128 ? 2 : 1;')],
}
CHECK_DH = (64, 72, 80, 96, 128, 200, 256, 66, 70)
CHECK_T = (1, 17, 64, 65, 100, 129, 256)
CHECK_BH = ((1, 1), (2, 3))


def build(nvcc, flags):
    """One nvcc per variant, all started together -> {name: library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        src = SRC.read_text()
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f'variant {name}: {old!r} is not in {SRC.name}')
            src = src.replace(old, new)
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
        print('k2_f32_variants: needs a CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    import chip_smoke as cs
    from superconductor_vae_tpu_torch.ops import _build
    from superconductor_vae_tpu_torch.ops import fused_attention as fa

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip())
    nvcc = _build.nvcc()
    libs = build(nvcc, _build.NVCC_FLAGS)
    fns = {}
    for name, so in libs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cs.build_report({name: so}, nvcc)
        for line in buf.getvalue().splitlines():
            if 'f32_kernel' in line and 'stack frame' not in line:
                print(line)
        fns[name] = fa.bind(ctypes.CDLL(str(so)))

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, t, h, dh):
        return [torch.randn(b, t, h, dh, generator=gen, device=dev) for _ in range(3)]

    def use(name):
        fa._launchers = lambda: fns[name]

    tol = cs.K2_TOL['float32']
    with torch.no_grad():
        for name in libs:
            use(name)
            worst = 0.0
            for dh in CHECK_DH:
                for t in CHECK_T:
                    for b, h in CHECK_BH:
                        q, k, v = inputs(b, t, h, dh)
                        out = fa.flash_attention(q, k, v)
                        ref = fa.flash_attention_ref(q, k, v)
                        cs.check(torch.allclose(out, ref, **tol),
                                 f'variant {name} disagrees at Dh={dh}, T={t}')
                        worst = max(worst, (out - ref).abs().max().item())
            print(f'check {name}: max_abs_err {worst:.3e} (tol {tol})')

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True)
        for t in (128, 256):
            sets = [inputs(64, t, 8, 72) for _ in range(4)]     # > 50 MB L2
            times = {'sdpa': []}
            for _ in range(2):
                times['sdpa'].append(cs.device_ms(torch, sdpa, sets, iters=20)[0])
                for name in libs:
                    use(name)
                    times.setdefault(name, []).append(
                        cs.device_ms(torch, fa.flash_attention, sets)[0])
            print(f'time B=64 T={t} H=8 Dh=72: ' + ', '.join(
                f'{name} {" / ".join(f"{x * 1e3:.2f}" for x in ms)} us'
                for name, ms in times.items()))
    return 0


if __name__ == '__main__':
    sys.exit(main())
