"""The port's benchmark: bench.py's probes on the PyTorch port.

    python -m superconductor_vae_tpu_torch.bench               # on the GPU
    python -m superconductor_vae_tpu_torch.bench --quick       # on the CPU

By default it builds what bench.py builds: ``ModelConfig()`` (magpie_dim
145, d_model 576, 12 layers, 8 heads, max_len 30) computing in bf16 on
float32 parameters, ``TrainConfig(batch_size=512, max_formula_len=30,
use_physics_z=True)`` (so with the set decoder and the A5 round-trip
loss, whose greedy rollout of 51 rows runs in every train and RL step),
``synthetic_dataset(n=512)``, with the decode step's
self-attention through the decode-step kernel (``pallas_decode``), and
runs three probes on one train state:

- train: one warm-up step, then ``--steps`` timed steps of the batch;
- RL: chunks of 8 ``make_train_step(..., rl_enabled=True)`` steps (SCST,
  ``rl.max_len`` = max_len, ``rl_w`` 1) over one batch of
  ``--rl-batch-size`` rows on the device; one warm chunk, 3 timed;
- gen: greedy ``generate_with_kv_cache`` with early exit and bench.py's
  gates from random z, one warm call, 5 timed.

Each timed span ends in a synchronise.  ``--rl`` times the train step with
the rollouts in it instead, ``--gen`` greedy generation alone (all
max_len - 1 steps), ``--pallas-decode`` the decode-step kernel against its
plain version at B = batch, T = max_len + 8, position T // 2.

``--spec`` times speculative decoding (generation/speculative.py, k = 4)
against the plain greedy scan (no gates, all max_len - 1 steps) from the
same random z over ``--steps`` calls each, after one warm call: the draft
is built from the model's own greedy stream, without the grammar
constraint, as bench.py builds it.  The plain scan runs on the state's
decoder, so through the decode-step kernel as the gen probe does; the
speculative chunk forward needs the plain cache layout, so it runs on a
twin decoder built with ``pallas_decode=False`` that holds the same
parameters (``models/decoder.py`` ``plain_layout``), and its attention is
plain PyTorch.
``--quick`` runs the tiny config (latent 2048) in float32 at batch 32 on
the CPU, where the decode step takes the kernel's plain version.

It prints one JSON line with bench.py's keys (``vs_baseline`` against the
reference's RTX 4060 Laptop figures: 19.2 train samples/s and 57.6
forward passes/s) and beside them the compute dtype, the decode route, the
decode steps each rollout ran (random heads may stop a rollout within a
step or two, so formulas/s means little without them), the peak memory
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .data import synthetic_dataset
from .generation import GenerationConfig, generate_with_kv_cache
from .generation.speculative import _as_draft_tables, speculative_generate
from .models import ModelConfig, tiny_test_config
from .models.decoder import plain_layout
from .models.draft import build_ngram_draft
from .ops import rl, round_trip
from .ops.decode_attention import decode_step_attention, decode_step_attention_ref
from .tokenizer import BOS_ID, EOS_ID, default_tokenizer
from .training import (TrainConfig, build_luts, create_train_state, default_dyn,
                       make_train_step)
from .training.evaluate import _to_device

BASELINE_SAMPLES_PER_S = 19.2       # reference train samples/s (BASELINE.md)
BASELINE_FORMULAS_PER_S = 57.6      # reference forward passes/s (BASELINE.md)
RL_CHUNK = 8                        # bench.py's k_chunk


@dataclasses.dataclass
class Setup:
    """One train state and the data the probes run on."""
    mcfg: ModelConfig
    tcfg: TrainConfig
    state: object
    luts: Dict[str, torch.Tensor]
    batch: Dict[str, torch.Tensor]
    device: torch.device
    dtype: torch.dtype
    seed: int = 0


def build(quick: bool = False, batch_size: Optional[int] = None, rl: bool = False,
          device=None) -> Setup:
    """bench.py's configuration: ``ModelConfig()`` with ``pallas_decode``,
    bf16 compute, batch 512, on CUDA; with ``quick`` the tiny config with a
    2048-wide latent, float32, batch 32, on the CPU."""
    if quick:
        mcfg = dataclasses.replace(tiny_test_config(), latent_dim=2048)
        batch_size, dtype_name = batch_size or 32, 'float32'
        device = device or 'cpu'
    else:
        mcfg = ModelConfig()
        batch_size, dtype_name = batch_size or 512, 'bfloat16'
        device = device or 'cuda'
    mcfg = dataclasses.replace(mcfg, pallas_decode=True)
    tcfg = TrainConfig(batch_size=batch_size, max_formula_len=mcfg.max_len,
                       use_physics_z=mcfg.latent_dim >= 2048, compute_dtype=dtype_name)
    if rl:
        tcfg.rl = dataclasses.replace(tcfg.rl, max_len=mcfg.max_len)
    device = torch.device(device)
    state = create_train_state(mcfg, tcfg, seed=0, device=device)
    ds = synthetic_dataset(n=batch_size, max_len=mcfg.max_len, magpie_dim=mcfg.magpie_dim)
    return Setup(mcfg, tcfg, state,
                 build_luts(default_tokenizer(max_len=mcfg.max_len), device=device),
                 _to_device(ds.batch(np.arange(batch_size)), device), device,
                 state.encoder.dtype)


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _peak_gib(device) -> Optional[float]:
    return torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == 'cuda' else None


def _reset_peak(device):
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)


def steps_run(tokens: torch.Tensor) -> int:
    """Decode steps an early-exit rollout took: up to its last row's EOS."""
    is_eos = tokens == EOS_ID
    if not bool(is_eos.any(dim=1).all()):
        return tokens.shape[1]
    return int(is_eos.int().argmax(dim=1).max()) + 1


@contextlib.contextmanager
def recorded_rollouts():
    """While entered, every rollout of ops/rl.py (``_rollout``) and of the
    round-trip loss (ops/round_trip.py) is kept: yields the two lists
    their outputs go into, RL first."""
    saved = (rl._rollout, round_trip.generate_with_kv_cache)
    outputs = ([], [])

    def recorder(fn, out_list):
        def record(*args, **kwargs):
            out = fn(*args, **kwargs)
            out_list.append(out)
            return out
        return record
    rl._rollout = recorder(saved[0], outputs[0])
    round_trip.generate_with_kv_cache = recorder(saved[1], outputs[1])
    try:
        yield outputs
    finally:
        rl._rollout, round_trip.generate_with_kv_cache = saved


def _round_trip_steps(outputs) -> List[int]:
    """Decode steps of each round-trip rollout: all of its stream (no early
    exit)."""
    return [o['tokens'].shape[1] for o in outputs]


def train_probe(s: Setup, steps: int = 20, rl_enabled: bool = False) -> dict:
    """One warm-up step, then ``steps`` timed steps of the batch.
    ``round_trip_decode_steps`` counts the warm-up's rollout too."""
    step = make_train_step(s.tcfg, s.luts, rl_enabled=rl_enabled)
    dyn = default_dyn(s.tcfg)
    with recorded_rollouts() as (rollouts, round_trips):
        s.state, m = step(s.state, s.batch, s.seed + 1, dyn)         # warm-up
        _sync(s.device)
        _reset_peak(s.device)
        n_warm = len(rollouts)
        t0 = time.perf_counter()
        for i in range(steps):
            s.state, m = step(s.state, s.batch, s.seed + 2 + i, dyn)
        _sync(s.device)
        wall = time.perf_counter() - t0
    n = len(s.batch['tokens'])
    return {'samples_per_s': steps * n / wall, 'seconds': wall, 'steps': steps,
            'metrics': {k: v.item() for k, v in m.items()},
            'decode_steps': [steps_run(o['tokens']) for o in rollouts[n_warm:]],
            'round_trip_decode_steps': _round_trip_steps(round_trips),
            'peak_gib': _peak_gib(s.device)}


def rl_probe(s: Setup, rl_batch: int = 512, chunks: int = 3, warm_chunks: int = 1,
             chunk: int = RL_CHUNK) -> dict:
    """bench.py's RL throughput: chunks of ``chunk`` SCST train steps over
    one batch of ``rl_batch`` rows on the device, ``rl.max_len`` = max_len
    and ``rl_w`` 1; ``warm_chunks`` untimed, then ``chunks`` timed.
    ``round_trip_decode_steps`` covers every step, warm ones too."""
    tcfg = dataclasses.replace(s.tcfg, batch_size=rl_batch,
                               rl=dataclasses.replace(s.tcfg.rl, max_len=s.mcfg.max_len))
    step = make_train_step(tcfg, s.luts, rl_enabled=True)
    dyn = dict(default_dyn(tcfg), rl_w=1.0)
    if rl_batch <= len(s.batch['tokens']):
        batch = {k: v[:rl_batch] for k, v in s.batch.items()}
    else:
        ds = synthetic_dataset(n=rl_batch, max_len=s.mcfg.max_len, magpie_dim=s.mcfg.magpie_dim)
        batch = _to_device(ds.batch(np.arange(rl_batch)), s.device)

    def run(n_chunks, seed):
        for i in range(n_chunks * chunk):
            s.state, m = step(s.state, batch, seed + i, dyn)
        return m
    with recorded_rollouts() as (rollouts, round_trips):
        run(warm_chunks, 1000)
        _sync(s.device)
        _reset_peak(s.device)
        t0 = time.perf_counter()
        m = run(chunks, 2000)
        _sync(s.device)
        wall = time.perf_counter() - t0
    steps = [steps_run(o['tokens']) for o in rollouts]
    warm = warm_chunks * chunk
    return {'samples_per_s': chunks * chunk * rl_batch / wall, 'seconds': wall,
            'steps': chunks * chunk, 'rl_batch_size': rl_batch,
            'metrics': {k: v.item() for k, v in m.items()},
            'decode_steps': steps[warm:], 'warm_decode_steps': steps[:warm],
            'round_trip_decode_steps': _round_trip_steps(round_trips),
            'peak_gib': _peak_gib(s.device)}


def gen_config(mcfg: ModelConfig, early_exit: bool = True) -> GenerationConfig:
    """bench.py's greedy generation gates."""
    return GenerationConfig(max_len=mcfg.max_len, temperature=0.0, stop_boost=10.0,
                            hard_stop_threshold=0.8, use_type_masking=True,
                            early_exit=early_exit)


def gen_probe(s: Setup, calls: int = 5, warm_calls: int = 1,
              early_exit: bool = True) -> dict:
    """Greedy generation from random z at the batch size: ``warm_calls``
    untimed, then ``calls`` timed."""
    b = len(s.batch['tokens'])
    g = torch.Generator(device=s.device).manual_seed(s.seed)
    z = torch.randn(b, s.mcfg.latent_dim, generator=g, device=s.device).to(s.dtype)
    stoich = torch.zeros(b, s.mcfg.stoich_input_dim, device=s.device, dtype=s.dtype)
    hv = torch.zeros(b, s.mcfg.heads_input_dim, device=s.device, dtype=s.dtype)
    gcfg = gen_config(s.mcfg, early_exit)
    decoder = s.state.decoder
    was_training = decoder.training
    decoder.eval()
    try:
        warm = [generate_with_kv_cache(decoder, z, stoich, hv, None, gcfg,
                                       type_masks=s.luts['type_masks'])
                for _ in range(warm_calls)]
        _sync(s.device)
        _reset_peak(s.device)
        t0 = time.perf_counter()
        outs = [generate_with_kv_cache(decoder, z, stoich, hv, None, gcfg,
                                       type_masks=s.luts['type_masks']) for _ in range(calls)]
        _sync(s.device)
        wall = time.perf_counter() - t0
    finally:
        decoder.train(was_training)
    return {'formulas_per_s': calls * b / wall, 'seconds': wall, 'calls': calls,
            'decode_steps': [steps_run(o['tokens']) for o in outs],
            'warm_decode_steps': [steps_run(o['tokens']) for o in warm],
            'peak_gib': _peak_gib(s.device)}


def spec_probe(s: Setup, calls: int = 20, k: int = 4) -> dict:
    """bench.py --spec: speculative decoding with a self-consistent draft
    (the model's own greedy stream, grammar constraint off) against the
    plain greedy scan through the state's decoder, from one random z; one
    warm call each, then ``calls`` timed.  ``rows_equal`` is the share of
    rows whose two streams agree up to the first EOS, ``parted_beyond_ties``
    the count of rows that part where the two largest logits lay ``tie``
    or more apart in both runs (1e-4 in float32, 2**-4 in bf16, where the
    two attention paths round differently and near-ties are common)."""
    b = len(s.batch['tokens'])
    g = torch.Generator(device=s.device).manual_seed(s.seed)
    z = torch.randn(b, s.mcfg.latent_dim, generator=g, device=s.device).to(s.dtype)
    stoich = torch.zeros(b, s.mcfg.stoich_input_dim, device=s.device, dtype=s.dtype)
    hv = torch.zeros(b, s.mcfg.heads_input_dim, device=s.device, dtype=s.dtype)
    gcfg = GenerationConfig(max_len=s.mcfg.max_len, temperature=0.0)
    decoder = s.state.decoder
    was_training = decoder.training
    decoder.eval()
    twin = plain_layout(decoder)
    try:
        ref = generate_with_kv_cache(decoder, z, stoich, hv, None, gcfg)
        stream = np.concatenate([np.full((b, 1), BOS_ID, np.int64),
                                 ref['tokens'].cpu().numpy()], axis=1)
        tables = _as_draft_tables(build_ngram_draft(
            stream, default_tokenizer(max_len=s.mcfg.max_len), grammar_constrained=False),
            s.device)

        def timed(fn):
            out = fn()
            _sync(s.device)
            t0 = time.perf_counter()
            for _ in range(calls):
                out = fn()
            _sync(s.device)
            return out, time.perf_counter() - t0
        plain_out, plain_wall = timed(
            lambda: generate_with_kv_cache(decoder, z, stoich, hv, None, gcfg))
        spec_out, spec_wall = timed(
            lambda: speculative_generate(twin, z, stoich, hv, tables, k=k))
    finally:
        decoder.train(was_training)
    mask = ref['mask'].bool()
    diff = (spec_out['tokens'] != plain_out['tokens']) & mask
    parted = diff.any(dim=1)
    first = diff.int().argmax(dim=1, keepdim=True)
    gap = torch.minimum(spec_out['margin'].gather(1, first),
                        plain_out['margin'].gather(1, first))[:, 0]
    tie = 1e-4 if s.dtype == torch.float32 else 2 ** -4
    return {'formulas_per_s': calls * b / spec_wall, 'plain_formulas_per_s': calls * b / plain_wall,
            'seconds': spec_wall, 'plain_seconds': plain_wall, 'calls': calls,
            'acceptance_rate': float(spec_out['acceptance_rate']),
            'n_iterations': spec_out['n_iterations'], 'plain_steps': s.mcfg.max_len - 1,
            'rows_equal': 1.0 - float(parted.float().mean()),
            'parted_beyond_ties': int((parted & (gap >= tie)).sum()), 'tie': tie}


def decode_probe(s: Setup, iters: int = 50) -> dict:
    """bench.py --pallas-decode: the decode-step attention through its
    wrapper (the kernel on a card) against the plain version, µs a call
    over ``iters`` calls, at B = batch, H, T = max_len + 8, position T // 2
    in the compute dtype."""
    b, h, dh = len(s.batch['tokens']), s.mcfg.nhead, s.mcfg.head_dim
    t = s.mcfg.max_len + 8
    g = torch.Generator(device=s.device).manual_seed(s.seed)
    k, v = (torch.randn(b, h, t, dh, generator=g, device=s.device).to(s.dtype)
            for _ in range(2))
    q, kn, vn = (torch.randn(b, h, dh, generator=g, device=s.device).to(s.dtype)
                 for _ in range(3))

    def us(fn):
        fn(q, kn, vn, k, v, t // 2)
        _sync(s.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(q, kn, vn, k, v, t // 2)
        _sync(s.device)
        return (time.perf_counter() - t0) / iters * 1e6
    return {'kernel_us': us(decode_step_attention), 'plain_us': us(decode_step_attention_ref),
            'shape': f'b{b} h{h} t{t} dh{dh}'}


def card(device) -> dict:
    """The card's name (torch) and power limit (nvidia-smi), or nulls on
    the CPU."""
    if device.type != 'cuda':
        return {'card': None, 'power_limit': None}
    limit = subprocess.run(
        ['nvidia-smi', '--query-gpu=power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.splitlines()[0].strip()
    return {'card': torch.cuda.get_device_name(device), 'power_limit': limit}


def decode_route(s: Setup) -> str:
    """Where the decode step's self-attention runs: the decode-step
    kernel on a card, its plain version on the CPU."""
    return 'K1 cuda' if s.device.type == 'cuda' else 'K1 plain version (CPU)'


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--quick', action='store_true',
                   help='tiny model, float32, batch 32, on the CPU')
    p.add_argument('--batch-size', type=int, default=None)
    p.add_argument('--steps', type=int, default=20)
    p.add_argument('--rl', action='store_true', help='include SCST rollouts in the step')
    p.add_argument('--rl-batch-size', type=int, default=None,
                   help='batch of the RL probe (default 512; the batch with --quick)')
    p.add_argument('--gen', action='store_true', help='greedy KV-cache generation alone')
    p.add_argument('--spec', action='store_true',
                   help='speculative decoding against the plain greedy scan')
    p.add_argument('--pallas-decode', action='store_true',
                   help='the decode-step kernel against its plain version')
    args = p.parse_args(argv)

    s = build(quick=args.quick, batch_size=args.batch_size, rl=args.rl)
    b = len(s.batch['tokens'])
    common = {'compute_dtype': str(s.dtype).split('.')[1], 'decode_route': decode_route(s),
              'batch_size': b, 'device': str(s.device), **card(s.device)}

    if args.pallas_decode:
        r = decode_probe(s)
        out = {'metric': 'pallas_decode_step_attention_us', 'value': round(r['kernel_us'], 2),
               'unit': f'us/step {r["shape"]}',
               'vs_baseline': round(r['plain_us'] / r['kernel_us'], 3),
               'plain_us': round(r['plain_us'], 2), **common}
    elif args.spec:
        r = spec_probe(s, calls=args.steps)
        out = {'metric': 'speculative_generation_formulas_per_s_per_chip',
               'value': round(r['formulas_per_s'], 2), 'unit': 'formulas/s/chip',
               'vs_baseline': round(r['formulas_per_s'] / BASELINE_FORMULAS_PER_S, 2),
               'acceptance_rate': round(r['acceptance_rate'], 4),
               'speedup_vs_plain_scan': round(r['plain_seconds'] / r['seconds'], 3),
               'plain_formulas_per_s': round(r['plain_formulas_per_s'], 2),
               'n_iterations': r['n_iterations'], 'plain_steps': r['plain_steps'],
               'rows_equal_to_plain_scan': r['rows_equal'],
               'rows_parted_beyond_ties': r['parted_beyond_ties'], 'tie': r['tie'],
               'spec_route': 'chunk verification, plain attention', **common}
    elif args.gen:
        r = gen_probe(s, calls=args.steps, early_exit=False)
        out = {'metric': 'kv_cache_generation_formulas_per_s_per_chip',
               'value': round(r['formulas_per_s'], 2), 'unit': 'formulas/s/chip',
               'vs_baseline': round(r['formulas_per_s'] / BASELINE_FORMULAS_PER_S, 2),
               'gen_decode_steps': r['decode_steps'], 'peak_gib': r['peak_gib'], **common}
    else:
        r = train_probe(s, steps=args.steps, rl_enabled=args.rl)
        out = {'metric': ('train_samples_per_s_quick' if args.quick
                          else 'train_samples_per_s_per_chip_108M_multitask'),
               'value': round(r['samples_per_s'], 2), 'unit': 'samples/s/chip',
               'vs_baseline': round(r['samples_per_s'] / BASELINE_SAMPLES_PER_S, 2),
               'train_peak_gib': r['peak_gib']}
        if args.rl:
            out['rl_decode_steps'] = r['decode_steps']
        else:
            rr = rl_probe(s, rl_batch=args.rl_batch_size or (b if args.quick else 512))
            g = gen_probe(s)
            out.update({
                'gen_formulas_per_s_per_chip': round(g['formulas_per_s'], 1),
                'gen_vs_baseline': round(g['formulas_per_s'] / BASELINE_FORMULAS_PER_S, 1),
                'rl_samples_per_s_per_chip': round(rr['samples_per_s'], 2),
                'rl_vs_baseline': round(rr['samples_per_s'] / BASELINE_SAMPLES_PER_S, 2),
                'rl_batch_size': rr['rl_batch_size'],
                'gen_decode_steps': g['decode_steps'], 'rl_decode_steps': rr['decode_steps'],
                'rl_peak_gib': rr['peak_gib'], 'gen_peak_gib': g['peak_gib']})
        out.update(common)
    peaks = [v for k, v in out.items() if k.endswith('peak_gib') and v is not None]
    out['peak_gib'] = max(peaks) if peaks else None
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
