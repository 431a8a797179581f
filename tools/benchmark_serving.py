#!/usr/bin/env python
"""Serving-oriented benchmarks: batched multi-utterance throughput and
long-form streaming synthesis (BASELINE.json config #5).

    python tools/benchmark_serving.py [--batch 8] [--frames 256] [--long 2048]

Counterpart of the reference's scripts/benchmark_pytorch_vs_cpp.py, measuring
the serving envelope instead of a PyTorch head-to-head: batched frames/s
(dp-style throughput on one card) and long-form chunked vocoder streaming.
Emits one JSON line per scenario.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from qwen3tts_tpu.pipeline import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--long", type=int, default=2048, help="long-form frame count")
    ap.add_argument("--chunk", type=int, default=64, help="streaming vocoder chunk")
    ap.add_argument("--skip-long", action="store_true")
    ap.add_argument("--skip-batch", action="store_true",
                    help="long-form only (talker-kernel A/B sessions)")
    args = ap.parse_args()

    from qwen3tts_tpu.config import PipelineConfig
    from qwen3tts_tpu.models import code_predictor as cp_model
    from qwen3tts_tpu.models import talker as talker_model
    from qwen3tts_tpu.models import vocoder as vocoder_model
    from qwen3tts_tpu.runtime import decode_loop

    cfg = PipelineConfig()
    tcfg, ccfg, vcfg = cfg.talker, cfg.code_predictor, cfg.vocoder
    spf = vcfg.samples_per_frame

    @jax.jit
    def init_all():
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
        return (talker_model.init_talker_params(k1, tcfg, jnp.bfloat16),
                cp_model.init_code_predictor_params(k2, ccfg, jnp.bfloat16),
                vocoder_model.init_vocoder_params(k3, vcfg, jnp.bfloat16))

    tp, cp, vp = jax.block_until_ready(init_all())
    quant = os.environ.get("QWEN3TTS_BENCH_QUANT", "int8")
    if quant in ("int8", "q4", "q4pure"):
        from qwen3tts_tpu.ops.quant import (quantize_block_params,
                                            quantize_talker_blocks)
        tp = tp._replace(blocks=quantize_talker_blocks(tp.blocks, quant))
        cp = cp._replace(blocks=quantize_block_params(cp.blocks))
        jax.block_until_ready((tp.blocks.wqkv.q, cp.blocks.wqkv.q))

    B = args.batch
    Tb = 64
    rng = np.random.default_rng(0)
    tokens = np.zeros((B, Tb), np.int32)
    tokens[:, :32] = rng.integers(2, 150000, size=(B, 32))
    keys = jax.random.split(jax.random.PRNGKey(1), B)

    def run_batched(max_frames):
        return decode_loop.generate_from_tokens_batched(
            tp, cp, jnp.asarray(tokens), jnp.full((B,), 32, jnp.int32),
            jnp.zeros((B, tcfg.hidden_size), jnp.float32),
            jnp.full((B,), 2050, jnp.int32), keys,
            talker_cfg=tcfg, cp_cfg=ccfg,
            max_frames=max_frames,
            kv_capacity=-(-(10 + max_frames + 8) // 256) * 256,
            temperature=0.9, top_k=50, repetition_penalty=1.05,
            allow_eos=False)

    # allow_eos=False: with synthetic weights EOS is a ~1/2049 random draw
    # per frame per lane; masking it makes the aggregate metric stable
    # (every lane emits max_frames).
    g = None if args.skip_batch else run_batched(args.frames)
    _ = None if g is None else np.asarray(g.codes)  # compile
    t = float("inf")
    if not args.skip_batch:
        for rep in range(3):
            t0 = time.perf_counter()
            g = run_batched(args.frames)
            _ = np.asarray(g.codes)
            t = min(t, time.perf_counter() - t0)
        total_frames = int(np.asarray(g.n_frames).sum())
        print(json.dumps({
            "scenario": "batched", "batch": B, "frames_total": total_frames,
            "frames_per_s": round(total_frames / t, 1),
            "audio_rtf": round(total_frames * spf / vcfg.sample_rate / t, 2),
            "wall_s": round(t, 2),
        }))

    # --- batched e2e incl. vocode: generation + batched vocoder dispatches
    # in 16-lane groups ---
    from qwen3tts_tpu.pipeline import vocode_batched

    if not args.skip_batch:
        def run_vocode_batch(codes, n):
            return vocode_batched(vp, vcfg, codes, n)

        a = run_vocode_batch(g.codes, jnp.maximum(g.n_frames, 1))  # compile
        t_e2e = float("inf")
        for rep in range(3):
            t0 = time.perf_counter()
            g = run_batched(args.frames)
            a = run_vocode_batch(g.codes, jnp.maximum(g.n_frames, 1))
            t_e2e = min(t_e2e, time.perf_counter() - t0)
        total_frames = int(np.asarray(g.n_frames).sum())
        print(json.dumps({
            "scenario": "batched_e2e", "batch": B, "frames_total": total_frames,
            "frames_per_s": round(total_frames / t_e2e, 1),
            "audio_rtf": round(total_frames * spf / vcfg.sample_rate / t_e2e, 2),
            "wall_s": round(t_e2e, 2),
        }))

    if not args.skip_long:
        # long-form: single stream, streaming vocoder with chunked decode
        def run_long(max_frames):
            return decode_loop.generate_from_tokens(
                tp, cp, jnp.asarray(tokens[0]), jnp.int32(32),
                jnp.zeros((tcfg.hidden_size,), jnp.float32), jnp.int32(2050),
                jax.random.PRNGKey(2),
                talker_cfg=tcfg, cp_cfg=ccfg,
                max_frames=max_frames,
                kv_capacity=-(-(10 + max_frames + 8) // 256) * 256,
                temperature=0.9, top_k=50, repetition_penalty=1.05,
                allow_eos=False)

        g = run_long(args.long)
        jax.block_until_ready(g.codes)
        Fb = args.chunk + 32

        def run_chunk(codes, n):
            return vocoder_model.vocoder_decode(vp, vcfg, codes, jnp.int32(n))

        pad = np.zeros((Fb, vcfg.n_codebooks), np.int32)
        run_chunk(jnp.asarray(pad), Fb)  # compile

        t0 = time.perf_counter()
        g = run_long(args.long)
        _ = np.asarray(g.codes[:1])
        t_gen = time.perf_counter() - t0
        codes = np.asarray(g.codes)
        t0 = time.perf_counter()
        start = 0
        history = 32
        outs = []
        while start < args.long:
            lo = max(0, start - history)
            hi = min(args.long, start + args.chunk)
            window = np.zeros((Fb, vcfg.n_codebooks), np.int32)
            window[: hi - lo] = codes[lo:hi]
            audio = run_chunk(jnp.asarray(window), hi - lo)
            outs.append(np.asarray(audio)[(start - lo) * spf: (hi - lo) * spf])
            start = hi
        t_voc = time.perf_counter() - t0
        audio_sec = args.long * spf / vcfg.sample_rate
        print(json.dumps({
            "scenario": "long_form_streaming", "frames": args.long,
            "gen_frames_per_s": round(args.long / t_gen, 1),
            "vocoder_xrt": round(audio_sec / t_voc, 1),
            "audio_rtf": round(audio_sec / (t_gen + t_voc), 2),
            "audio_seconds": round(audio_sec, 1),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
