#!/usr/bin/env python
"""Benchmark: full 0.6B Qwen3-TTS synthesis on one NVIDIA GPU.

    python bench.py [--quant int8|bf16|q4|q4pure]

Prints the card's name and power limit and the device JAX sees, then ONE
JSON line:
  {"metric": "audio_rtf", "value": <audio_sec/wall_sec>, "unit": ..., ...}

Baseline (BASELINE.md): the reference engine sustains 3.2 codec frames/s on
Apple silicon => audio RTF 3.2 * 1920 / 24000 = 0.256.

Weights are deterministic synthetic at the exact 0.6B configuration — FLOP and
memory-traffic identical to the real checkpoint, so throughput is
representative (no checkpoint files ship with this repository).

Run it alone, one process per card: a JAX process reserves most of the card's
memory when it starts, and two processes that compute at once on one card
spoil each other's times. The script refuses to run without a GPU, and exits
non-zero when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from qwen3tts_tpu.pipeline import enable_compile_cache
from qwen3tts_tpu.utils import device

BASELINE_FRAMES_PER_S = 3.2  # README.md:276-295 (92-frame run, Apple silicon)
N_FRAMES = 256
TTFA_FRAMES = 8   # first streaming chunk: prefill + 8 frames + their vocode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quant", default="int8",
                    choices=["int8", "bf16", "q4", "q4pure"])
    args = ap.parse_args(argv)
    device.require_gpu("bench")
    enable_compile_cache()

    from qwen3tts_tpu.config import PipelineConfig
    from qwen3tts_tpu.models import code_predictor as cp_model
    from qwen3tts_tpu.models import talker as talker_model
    from qwen3tts_tpu.models import vocoder as vocoder_model
    from qwen3tts_tpu.runtime import decode_loop
    from qwen3tts_tpu.runtime.continuous import ContinuousScheduler
    from qwen3tts_tpu.runtime.e2e import generate_and_vocode, start_and_vocode

    card = device.gpu_name_and_power_limit()
    dev = device.describe()
    print(f"nvidia-smi: {card}", file=sys.stderr)
    print(f"device: platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']}  quant: {args.quant}", file=sys.stderr)

    cfg = PipelineConfig()
    tcfg, ccfg, vcfg = cfg.talker, cfg.code_predictor, cfg.vocoder
    spf = vcfg.samples_per_frame

    @jax.jit
    def init_all():
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
        return (talker_model.init_talker_params(k1, tcfg, jnp.bfloat16),
                cp_model.init_code_predictor_params(k2, ccfg, jnp.bfloat16),
                vocoder_model.init_vocoder_params(k3, vcfg, jnp.bfloat16))

    t0 = time.perf_counter()
    tp, cp, vp = jax.block_until_ready(init_all())
    if args.quant != "bf16":
        # mirrors pipeline.py's tiers: int8 = Q8_0-parity; q4 = MIXED
        # attn-int8/ffn-u4 (the 4-bit default); q4pure = all-u4
        from qwen3tts_tpu.ops.quant import (
            quantize_block_params, quantize_talker_blocks)
        tp = tp._replace(blocks=quantize_talker_blocks(tp.blocks, args.quant))
        cp = cp._replace(blocks=quantize_block_params(cp.blocks))
        jax.block_until_ready((tp.blocks, cp.blocks))
    print(f"param init: {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    Tb = 64
    rng = np.random.default_rng(0)
    tokens = np.zeros((Tb,), np.int32)
    tokens[:32] = rng.integers(2, 150000, size=32)
    tok = (jnp.asarray(tokens), jnp.int32(32),
           jnp.zeros((tcfg.hidden_size,), jnp.float32), jnp.int32(2050))
    KV = -(-(10 + N_FRAMES + 8) // 256) * 256
    sampling = dict(temperature=0.9, top_k=50, repetition_penalty=1.05)

    def run_gen(seed):
        return decode_loop.generate_from_tokens(
            tp, cp, *tok, jax.random.PRNGKey(seed), talker_cfg=tcfg,
            cp_cfg=ccfg, max_frames=N_FRAMES, kv_capacity=KV,
            allow_eos=False, **sampling)

    def run_vocoder(codes, n):
        return vocoder_model.vocoder_decode(vp, vcfg, codes, jnp.int32(n))

    def run_e2e(seed):
        # text tokens -> waveform in ONE dispatch (runtime/e2e.py)
        return generate_and_vocode(
            tp, cp, vp, *tok, jax.random.PRNGKey(seed), talker_cfg=tcfg,
            cp_cfg=ccfg, vocoder_cfg=vcfg, max_frames=N_FRAMES,
            kv_capacity=KV, allow_eos=False, **sampling)

    def run_ttfa(seed):
        return start_and_vocode(
            tp, cp, vp, *tok, jax.random.PRNGKey(seed), talker_cfg=tcfg,
            cp_cfg=ccfg, vocoder_cfg=vcfg, chunk_frames=TTFA_FRAMES,
            max_frames=N_FRAMES, kv_capacity=KV, allow_eos=False, **sampling)

    def timed(fn, reps):
        walls = []
        for rep in range(reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(2 + rep))
            walls.append(time.perf_counter() - t0)
        return walls, out

    # --- compile (each program once, reported as set-up) ---
    for name, fn in (("e2e", run_e2e), ("gen", run_gen), ("ttfa", run_ttfa)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(1))
        print(f"{name} compile+run: {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)
    g = run_gen(1)
    t0 = time.perf_counter()
    jax.block_until_ready(run_vocoder(g.codes, N_FRAMES))
    print(f"vocoder compile+run: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    # --- timed ---
    e2es, (audio, g) = timed(run_e2e, 5)
    n_frames = int(g.n_frames)
    assert n_frames == N_FRAMES, n_frames
    audio = np.asarray(audio)
    assert audio.shape == (N_FRAMES * spf,) and np.isfinite(audio).all()
    gens, g = timed(run_gen, 5)
    vocs, _ = timed(lambda _seed: run_vocoder(g.codes, n_frames), 5)
    ttfas, _ = timed(run_ttfa, 15)
    t_e2e, t_gen, t_voc = min(e2es), min(gens), min(vocs)
    audio_sec = n_frames * spf / vcfg.sample_rate

    # --- continuous-batching serving mini-run (runtime/continuous.py) ---
    lanes, C_s, K_s = 16, 512, 32
    rng = np.random.default_rng(5)
    budgets = np.clip(rng.lognormal(np.log(52), 0.4, 48), 24, 96).astype(np.int32)
    reqs = []
    for i in range(48):
        nt = int(rng.integers(10, 32))
        reqs.append((rng.integers(2, 2000, nt).astype(np.int32), nt,
                     int(budgets[i])))
    useful = int(budgets.sum())

    def cont_pass():
        sched = ContinuousScheduler(
            tp, cp, tcfg, ccfg, lanes=lanes, kv_capacity=C_s, text_bucket=32,
            chunk_frames=K_s, refill_slots=8, max_frames=96, temperature=0.9,
            top_k=50, repetition_penalty=1.05, allow_eos=False)
        for i, (tk, nt, bd) in enumerate(reqs):
            sched.submit(tk, nt, np.zeros((tcfg.hidden_size,), np.float32),
                         2050, seed=i, max_frames=bd)
        t0 = time.perf_counter()
        got = sched.run()
        wall = time.perf_counter() - t0
        assert sum(v.shape[0] for v in got.values()) == useful
        return wall, sched

    t0 = time.perf_counter()
    cont_pass()    # compile pass (decode_chunk + refill)
    print(f"continuous compile+run: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    wall, sched = cont_pass()

    rtf = audio_sec / t_e2e
    result = {
        "metric": "audio_rtf",
        "value": rtf,
        "unit": "audio_sec/wall_sec",
        "vs_baseline": rtf / (BASELINE_FRAMES_PER_S * spf / vcfg.sample_rate),
        "frames_per_s": n_frames / t_gen,
        "gen_ms_per_frame": 1e3 * t_gen / n_frames,
        "gen_median_ms_per_frame": 1e3 * float(np.median(gens)) / n_frames,
        "vocoder_ms": 1e3 * t_voc,
        "e2e_ms": 1e3 * t_e2e,
        "e2e_median_ms": 1e3 * float(np.median(e2es)),
        "ttfa_p50_ms": 1e3 * float(np.median(ttfas)),
        "ttfa_chunk_frames": TTFA_FRAMES,
        "n_frames": n_frames,
        "quant": args.quant,
        "continuous": {"aggregate_fps": useful / wall, "lanes": lanes,
                       "useful_frames": useful, "wall_s": wall,
                       "chunks": sched.chunks_run, "sessions": sched.sessions,
                       "compactions": sched.compactions},
        "device": dev,
        "card": card,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
