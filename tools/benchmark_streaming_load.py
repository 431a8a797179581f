#!/usr/bin/env python
"""Streaming continuous serving under load: per-request TTFA p50/p99.

synthesize_queue(on_audio=...) under load: this drives a 64-lane lognormal
request mix
through the STREAMING path (every decode chunk vocodes emitting lanes'
windows in one fixed-shape dispatch) and reports, per request:

  ttfa     wall from run start to that request's FIRST audio chunk —
           includes queue wait for requests admitted later (the honest
           "under load" number; the reference's TTFA is its full utterance
           wall, README.md:276-295).
  e2e      wall to the request's final chunk.

plus aggregate useful frames/s. Two passes: the first warms the compiled
programs (decode_chunk + refill + the streaming vocoder bucket); the second
is timed.

    python tools/benchmark_streaming_load.py --lanes 64 --requests 128 \
        [--chunk 8] [--quant int8]

Run alone on the card (one process per card). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

from qwen3tts_tpu.pipeline import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--max-frames", type=int, default=256)
    ap.add_argument("--stream-history", type=int, default=16)
    ap.add_argument("--cadence", type=int, default=32,
                    help="stream_cadence frames per steady emission "
                         "(0 = vocode every decode chunk)")
    ap.add_argument("--kv-capacity", type=int, default=0,
                    help="override the scheduler KV capacity (lanes=128 "
                         "needs C=512: the auto capacity's B x C bf16 cache "
                         "would exceed HBM)")
    ap.add_argument("--admit-per-chunk", type=int, default=0,
                    help="admission pacing: max lanes admitted per decode "
                         "boundary (0 = greedy admission)")
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args()

    from qwen3tts_tpu.config import (PipelineConfig, RuntimeConfig,
                                     SamplingConfig)
    from qwen3tts_tpu.pipeline import Qwen3TTS

    quant = os.environ.get("QWEN3TTS_BENCH_QUANT", "int8")
    tts = Qwen3TTS(PipelineConfig(runtime=RuntimeConfig(quant=quant)))
    assert tts.load_models(None, synthetic=True), tts.error_msg
    print(f"device: {jax.devices()[0]}  quant: {quant}", file=sys.stderr)

    rng = np.random.default_rng(17)
    n = args.requests
    budgets = np.clip(rng.lognormal(np.log(110), 0.45, n), 24,
                      args.max_frames).astype(int).tolist()
    words = ["hello", "there", "how", "are", "you", "today", "friend"]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(3, 9))))
             + "." for _ in range(n)]
    params = SamplingConfig(temperature=0.9, top_k=50,
                            max_audio_tokens=args.max_frames, seed=11)

    result = None
    for p in range(args.passes):
        ttfa: dict[int, float] = {}
        done: dict[int, float] = {}
        t0 = time.perf_counter()

        def on_audio(idx, chunk, finished, _t0=t0, _ttfa=ttfa, _done=done):
            t = time.perf_counter() - _t0
            if len(chunk):
                _ttfa.setdefault(idx, t)
            if finished:
                _done[idx] = t

        results = tts.synthesize_queue(
            texts, params, lanes=args.lanes, chunk_frames=args.chunk,
            kv_capacity=args.kv_capacity or None,
            on_audio=on_audio, stream_history=args.stream_history,
            stream_cadence=args.cadence,
            max_audio_tokens_per_request=budgets,
            admit_per_chunk=args.admit_per_chunk or None)
        wall = time.perf_counter() - t0
        assert all(r.success for r in results), \
            [r.error_msg for r in results if not r.success][:3]
        assert len(ttfa) == n and len(done) == n
        useful = sum(r.n_frames for r in results)
        tt = np.array([ttfa[i] for i in range(n)])
        ee = np.array([done[i] for i in range(n)])
        result = {
            "metric": "streaming_ttfa_under_load",
            "lanes": args.lanes, "requests": n, "chunk_frames": args.chunk,
            "cadence": args.cadence, "admit_per_chunk": args.admit_per_chunk,
            "quant": quant, "wall_s": round(wall, 3),
            "useful_frames": useful,
            "aggregate_fps": round(useful / wall, 1),
            "budget_mean": round(float(np.mean(budgets)), 1),
            "ttfa_ms": {
                "p50": round(float(np.percentile(tt, 50)) * 1e3, 1),
                "p90": round(float(np.percentile(tt, 90)) * 1e3, 1),
                "p99": round(float(np.percentile(tt, 99)) * 1e3, 1),
                "first_admitted_min": round(float(tt.min()) * 1e3, 1),
            },
            "e2e_ms": {
                "p50": round(float(np.percentile(ee, 50)) * 1e3, 1),
                "p99": round(float(np.percentile(ee, 99)) * 1e3, 1),
            },
            "pass": p,
        }
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
