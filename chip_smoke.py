#!/usr/bin/env python3
"""Runs the PyTorch port (superconductor_vae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA kernel of the port with nvcc (ops/_build.py).
3. Kernel phase: K1, the decode-step attention, against its plain PyTorch
   version at the main path's shapes (B=256, H=8, T=30, Dh=72) at
   positions 0, 14 and 29 in float32 and bfloat16: output and both caches.
   Times the kernel, the plain version and, as a yardstick the port never
   calls, torch's scaled_dot_product_attention over the same masked cache.
4. End-to-end phase: the main path of true-AR evaluation at run4's widths
   (results/run4/ckpt_snapshot/meta.json: 12 layers, d_model 576,
   magpie_dim 78) with weights from a seed, float32: 1,024 real rows of
   data/processed/jarvis_merged.csv.gz in 4 batches of 256 through
   training/evaluate.py eval_batch (encoder, memory, greedy KV-cache
   generation with run4's eval gates and early exit, TF forward), once
   through K1 and once through the plain attention path.  The two token
   streams must agree except where the top two logits were within 1e-4;
   8 rows also run on the CPU and must agree with the card.
5. Prints the kernels' JSON line, then as its last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed check raises, and the script exits non-zero without the last
line.  It refuses to run without CUDA.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSV = ROOT / 'data' / 'processed' / 'jarvis_merged.csv.gz'
META = ROOT / 'results' / 'run4' / 'ckpt_snapshot' / 'meta.json'
SEED = 0
BATCH, N_BATCHES = 256, 4
N_CPU_ROWS = 8
TIE = 1e-4                        # top-two logit gap under which argmax may flip

# H100 SXM (NVIDIA data sheet): HBM rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


# -- timing -------------------------------------------------------------------

def device_ms(torch, fn, arg_sets, iters=60):
    """(device ms, host ms) per call of ``fn`` over ``arg_sets`` in turn.

    The stream is held by a sleep kernel while the host enqueues all the
    calls, so they run back to back and the events time the device, not
    the Python launch path.  Rotating over several argument sets larger
    than the 50 MB L2 cache makes each call find its data cold, as each
    layer's cache is on the main path."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    # calibrate the sleep kernel, then hold the stream for a multiple of
    # the enqueue time; a host stall (shared cores) can outlast the hold,
    # so a measurement whose enqueue did not finish first is taken again
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    torch.cuda._sleep(1_000_000)
    e1.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / max(e0.elapsed_time(e1), 1e-3)
    for factor in (4, 8, 16):
        held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        held.record()
        torch.cuda._sleep(int(cycles_per_ms * factor * host_ms))
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if enqueue_ms < held.elapsed_time(start):
            break
    check(enqueue_ms < held.elapsed_time(start),
          'the host did not enqueue ahead of the device; timing invalid')
    return start.elapsed_time(end) / iters, enqueue_ms / iters


# -- kernel phase -------------------------------------------------------------

def k1_bytes_ops(b, h, dh, position, itemsize):
    """K1's least traffic and work: q, k_new, v_new read, the output and
    the two cache rows written, K and V slots 0..position-1 read once; a
    q.k and a p.v product over position+1 slots."""
    rows = b * h * dh * itemsize
    nbytes = 6 * rows + 2 * position * rows
    ops = 4 * b * h * (position + 1) * dh
    return nbytes, ops


def kernel_phase(torch, dev):
    import torch.nn.functional as F
    from superconductor_vae_tpu_torch.ops.decode_attention import (
        decode_step_attention, decode_step_attention_ref)

    b, h, t, dh = BATCH, 8, 30, 72
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(dtype):
        rows = [torch.randn(b, h, dh, generator=gen, device=dev).to(dtype) for _ in range(3)]
        caches = [torch.randn(b, h, t, dh, generator=gen, device=dev).to(dtype) for _ in range(2)]
        return rows + caches

    tols = {torch.float32: dict(rtol=1e-5, atol=1e-5),        # summation order
            torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}    # one bf16 ulp
    max_err = {}
    for dtype, tol in tols.items():
        for position in (0, 14, 29):
            q, kn, vn, kc, vc = inputs(dtype)
            kc_ref, vc_ref = kc.clone(), vc.clone()
            out = decode_step_attention(q, kn, vn, kc, vc, position)
            ref = decode_step_attention_ref(q, kn, vn, kc_ref, vc_ref, position)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), **tol)
            same = torch.equal(kc, kc_ref) and torch.equal(vc, vc_ref)
            print(f'K1 check {str(dtype):15s} pos={position:2d}: max_abs_err={err:.3e} '
                  f'(tol {tol}) caches_equal={same}')
            check(ok, f'K1 output disagrees with the plain version ({dtype}, pos {position})')
            check(same, f'K1 cache rows disagree ({dtype}, pos {position})')
            max_err[dtype] = max(max_err.get(dtype, 0.0), err)

    n_sets = 4                    # 4 x 35 MB of f32 caches > 50 MB L2
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        sets = [inputs(dtype) for _ in range(n_sets)]
        for position in (14, 29):
            kern, kern_host = device_ms(
                torch, lambda *a: decode_step_attention(*a, position), sets)
            plain, plain_host = device_ms(
                torch, lambda *a: decode_step_attention_ref(*a, position), sets)
            keep = (torch.arange(t, device=dev) <= position)[None, :]   # [Lq=1, T]

            def sdpa(q, kn, vn, kc, vc):
                return F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                                      attn_mask=keep)
            lib, lib_host = device_ms(torch, sdpa, sets)
            nbytes, ops = k1_bytes_ops(b, h, dh, position, torch.empty((), dtype=dtype).element_size())
            bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S) * 1e3
            by = 'bytes' if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOP_PER_S else 'operations'
            print(f'K1 time {str(dtype):15s} pos={position:2d}: kernel {kern * 1e3:.2f} us, '
                  f'plain {plain * 1e3:.2f} us, sdpa {lib * 1e3:.2f} us, bound {bound * 1e3:.2f} us '
                  f'({by}: {nbytes / 1e6:.1f} MB, {ops / 1e6:.1f} MFLOP); host per call: '
                  f'kernel {kern_host * 1e3:.1f} us, plain {plain_host * 1e3:.1f} us, '
                  f'sdpa {lib_host * 1e3:.1f} us')
            rows[(dtype, position)] = dict(ms=kern, plain_ms=plain, bound_ms=bound,
                                           bound_by=by, library_ms=lib)
        del sets
    torch.cuda.empty_cache()
    return rows[(torch.float32, 29)], max_err[torch.float32]


# -- end-to-end phase ---------------------------------------------------------

def make_batches(torch, rows, tok, magpie_dim, dev):
    """Eval batches from CSV rows.  Tc: log1p, z-scored over the
    superconductors among the rows; Magpie: NaN -> column mean, z-scored
    over the same rows.  Stand-ins for the training corpus's statistics,
    which come with the data slice (weights here are random anyway)."""
    import numpy as np
    from superconductor_vae_tpu_torch.data import composition_slots

    check(rows['magpie'].shape[1] == magpie_dim,
          f'{rows["magpie"].shape[1]} feature columns, model wants {magpie_dim}')
    tc = np.log1p(rows['tc'])
    ref = tc[rows['is_sc'] == 1] if (rows['is_sc'] == 1).any() else tc
    tc = ((tc - ref.mean()) / (ref.std() + 1e-8)).astype(np.float32)
    mg = rows['magpie'].astype(np.float64)
    mg = np.where(np.isnan(mg), np.nan_to_num(np.nanmean(mg, axis=0))[None], mg)
    mg = ((mg - mg.mean(0)) / (mg.std(0) + 1e-8)).astype(np.float32)
    idx, frac, mask = composition_slots(rows['formula'])
    tokens = tok.encode_batch(rows['formula'])
    full = {'element_indices': idx.astype(np.int64), 'element_fractions': frac,
            'element_mask': mask, 'magpie': mg, 'tc': tc,
            'tokens': tokens.astype(np.int64)}
    n = len(rows['formula'])
    return [{k: torch.as_tensor(v[i:i + BATCH]).to(dev) for k, v in full.items()}
            for i in range(0, n, BATCH)]


def steps_run(generated, eos_id):
    """Decode steps an early-exit rollout took: up to the last row's EOS."""
    is_eos = generated == eos_id
    if not bool(is_eos.any(dim=1).all()):
        return generated.shape[1]
    return int(is_eos.int().argmax(dim=1).max()) + 1


def compare_streams(got, want, eos_id, what):
    """Token streams up to each row's EOS must agree; a row may diverge
    only where the two largest logits were within TIE in either run."""
    from superconductor_vae_tpu_torch.generation import sequence_mask
    mask = sequence_mask(want['generated']).bool()
    diff = (got['generated'] != want['generated']) & mask
    ties = 0
    for r in diff.any(dim=1).nonzero()[:, 0].tolist():
        s = int(diff[r].int().argmax())
        gap = min(float(got['margin'][r, s]), float(want['margin'][r, s]))
        print(f'{what}: row {r} diverges at step {s}, top-two gap {gap:.3e}')
        check(gap < TIE, f'{what}: row {r} diverges at step {s} with top-two gap {gap:.3e}')
        ties += 1
    return ties


def trace_batch(torch, fn):
    """One eval batch under torch.profiler: the device's busy share of the
    wall time (kernel time summed over the batch) and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        print('trace: the profiler recorded no device time; busy share not measured')
        return
    print(f'trace: one batch of {BATCH} under the profiler: wall {wall_us / 1e3:.1f} ms, '
          f'device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), '
          f'{sum(e.count for e in kernels)} kernel launches')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f'trace:   {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x  {e.key[:90]}')


def e2e_phase(torch, dev):
    import numpy as np
    from superconductor_vae_tpu_torch.data import read_csv_rows
    from superconductor_vae_tpu_torch.models import (
        FormulaDecoder, MaterialsEncoder, config_from_meta, init_params)
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.tokenizer import EOS_ID, default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        build_luts, eval_batch, eval_generation_config)

    meta = json.loads(META.read_text())
    cfg = config_from_meta(meta['model_config'], pallas_decode=True)
    gcfg = eval_generation_config(cfg.max_len, meta['eval_gating'])
    print(f'e2e: run4 widths {dataclasses.asdict(cfg)}')
    print(f'e2e: {gcfg}')

    gen = torch.Generator().manual_seed(SEED)
    encoder = init_params(MaterialsEncoder(cfg, device=dev), gen).eval()
    decoder = init_params(FormulaDecoder(cfg, device=dev), gen).eval()
    with torch.no_grad():
        # Random heads end every rollout at its first step (hard stop or a
        # predicted EOS type).  A constant stop probability of 0.018 and a
        # type head that never predicts EOS make every rollout run all
        # max_len - 1 steps instead: the decode's worst case, and K1 at
        # every position (a trained model stops after 15-22 steps).
        decoder.stop_d2.weight.zero_()
        decoder.stop_d2.bias.fill_(-4.0)
        decoder.type_d3.bias[4] = -30.0
    plain_cfg = dataclasses.replace(cfg, pallas_decode=False)
    decoder_plain = FormulaDecoder(plain_cfg, device=dev).eval()
    decoder_plain.load_state_dict(decoder.state_dict())
    n_params = sum(p.numel() for m in (encoder, decoder) for p in m.parameters())
    print(f'e2e: {n_params / 1e6:.1f}M parameters from seed {SEED}, float32')

    tok = default_tokenizer(max_len=cfg.max_len)
    type_masks = build_luts(tok, device=dev)['type_masks']
    rows = read_csv_rows(CSV, BATCH * N_BATCHES)
    check(len(rows['formula']) == BATCH * N_BATCHES, 'too few CSV rows')
    batches = make_batches(torch, rows, tok, cfg.magpie_dim, dev)

    def run(dec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [eval_batch(encoder, dec, bt, gcfg, type_masks=type_masks) for bt in batches]
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    run(decoder)                                    # warm-up (cuBLAS, allocator)
    run(decoder_plain)
    plain_outs, plain_wall = run(decoder_plain)
    # the main path, through K1
    decode_step_attention.launches = 0
    outs, wall = run(decoder)
    launches = decode_step_attention.launches
    # once more each, in turns (plain, K1, K1, plain), to see the spread
    walls = [wall, run(decoder)[1]]
    plain_walls = [plain_wall, run(decoder_plain)[1]]

    steps = [steps_run(o['generated'], EOS_ID) for o in outs]
    print(f'e2e: decode steps per batch {steps}; K1 launches {launches}')
    check(launches > 0, 'K1 was not launched on the main path')
    check(launches == cfg.num_layers * sum(steps),
          f'K1 launches {launches} != layers x steps {cfg.num_layers * sum(steps)}')

    ties = 0
    for i, (o, p) in enumerate(zip(outs, plain_outs)):
        check(o['generated'].shape == (BATCH, cfg.max_len - 1), 'generated shape')
        check(o['tf_pred'].shape == (BATCH, cfg.max_len - 1), 'tf_pred shape')
        check(bool(((o['generated'] >= 0) & (o['generated'] < cfg.vocab_size)).all()),
              'token ids out of range')
        for key in ('tc_pred', 'sc_pred', 'z_norm'):
            check(o[key].shape == (BATCH,) and bool(torch.isfinite(o[key]).all()),
                  f'{key} not finite or misshapen')
        ties += compare_streams(o, p, EOS_ID, f'batch {i} K1 vs plain')

    # the same weights on the CPU, plain path, for a few rows
    enc_cpu = MaterialsEncoder(cfg, device='cpu').eval()
    enc_cpu.load_state_dict(encoder.state_dict())
    dec_cpu = FormulaDecoder(plain_cfg, device='cpu').eval()
    dec_cpu.load_state_dict(decoder.state_dict())
    small = {k: v[:N_CPU_ROWS].cpu() for k, v in batches[0].items()}
    cpu_out = eval_batch(enc_cpu, dec_cpu, small, gcfg, type_masks=type_masks.cpu())
    card = {k: v[:N_CPU_ROWS].cpu() for k, v in outs[0].items()}
    ties += compare_streams(card, cpu_out, EOS_ID, 'card vs CPU')
    for key in ('tc_pred', 'sc_pred', 'z_norm'):
        err = (card[key] - cpu_out[key]).abs().max().item()
        print(f'e2e: card vs CPU {key} max_abs_err {err:.3e}')
        check(torch.allclose(card[key], cpu_out[key], rtol=1e-4, atol=1e-4),
              f'card and CPU disagree on {key}')

    trace_batch(torch, lambda: eval_batch(encoder, decoder, batches[0], gcfg,
                                          type_masks=type_masks))

    gen_all = torch.cat([o['generated'] for o in outs]).cpu().numpy()
    tgt = np.concatenate([bt['tokens'][:, 1:].cpu().numpy() for bt in batches])
    from superconductor_vae_tpu_torch.training.evaluate import _exact_match
    exact = float(_exact_match(gen_all, tgt).mean())
    n = BATCH * N_BATCHES
    print(f'e2e: {n} formulas in {wall:.3f} s through K1 = {n / wall:.1f} formulas/s '
          f'(runs in turn: plain {plain_walls[0]:.3f} s, K1 {walls[0]:.3f} s, '
          f'K1 {walls[1]:.3f} s, plain {plain_walls[1]:.3f} s); '
          f'near-tie divergences {ties}; true-AR exact (random weights) {exact:.4f}')
    for r in range(3):
        print(f'e2e: {rows["formula"][r]!r} -> {tok.decode(gen_all[r])!r}')
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this script runs on a GPU only',
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from superconductor_vae_tpu_torch.ops import _build

    t_start = time.perf_counter()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout
    print(smi.strip().splitlines()[0])
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}')
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 matmuls in full float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')

    t0 = time.perf_counter()
    libs = _build.build('decode_attention')
    print(f'build: {time.perf_counter() - t0:.1f} s')
    for name, path in libs.items():
        log = path.with_name(path.name + '.log')
        for line in (log.read_text().splitlines() if log.exists() else []):
            if 'registers' in line or 'spill' in line:
                print(f'build {name}: {line.strip()}')

    k1, k1_err = kernel_phase(torch, dev)
    launches = e2e_phase(torch, dev)

    print(f'total: {time.perf_counter() - t_start:.1f} s')
    print(f'kernels: ["K1 decode_step_attention"] launches: {{"K1 decode_step_attention": {launches}}}')
    print(json.dumps({'kernels': [{
        'name': 'K1 decode_step_attention', 'route': 'cuda',
        'source': 'superconductor_vae_tpu_torch/csrc/decode_attention.cu',
        'replaces': 'superconductor_vae_tpu/ops/pallas_decode.py:80',
        'launches': launches, 'max_abs_err': k1_err,
        **k1,
    }]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
