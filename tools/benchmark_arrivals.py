#!/usr/bin/env python
"""Online arrival-process serving benchmark: Poisson arrivals,
latency-first.

The offline A/B (tools/benchmark_continuous.py) structurally understates
continuous batching: with every request present at t=0, static batching
only pays its occupancy tax. Under ARRIVALS the static server also makes
requests wait for the next batch boundary and holds every batch member
until the batch's longest request drains — latency is where continuous
batching actually earns its keep. This tool drives the SAME Poisson trace
through both servers and reports per-request first-codes latency and e2e
latency percentiles (codes-level; the streaming-audio analog is
tools/benchmark_streaming_load.py):

  continuous:  ContinuousScheduler.run(feeder=...) — requests admitted
               mid-flight as they arrive; t_first = first emitted codes
               chunk (arrival -> on_chunk), e2e = final chunk.
  static:      an online batch server: whenever the device is idle, batch
               everything queued (<= lanes) and run it to the batch's max
               budget (64-frame buckets bound the compile count); every
               member's codes land at batch end, so t_first == e2e.

Arrival rate: --rate req/s, or derived as
  rate = utilization * capacity_fps / mean_budget
(defaults: utilization 0.7, capacity_fps 2500 — a placeholder for the
64-lane continuous decode throughput; measure it on the card and pass it).

    python tools/benchmark_arrivals.py --lanes 64 --requests 192 \
        [--utilization 0.7] [--capacity-fps 2500] [--rate R] \
        [--continuous-only|--static-only]

Run alone on the card (one process per card). Prints one JSON line per
side.
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

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmark_continuous import make_requests  # noqa: E402


def _pcts(xs) -> dict:
    a = np.asarray(sorted(xs), np.float64) * 1e3
    return {"p50": round(float(np.percentile(a, 50)), 1),
            "p90": round(float(np.percentile(a, 90)), 1),
            "p99": round(float(np.percentile(a, 99)), 1),
            "mean": round(float(a.mean()), 1)}


def run_continuous_arrivals(tp, cp, tcfg, ccfg, reqs, arrivals, args):
    from qwen3tts_tpu.runtime.continuous import ContinuousScheduler

    H = tcfg.hidden_size
    sched = ContinuousScheduler(
        tp, cp, tcfg, ccfg, lanes=args.lanes, kv_capacity=args.capacity,
        text_bucket=args.text_bucket, chunk_frames=args.chunk,
        refill_slots=args.refill_slots, max_frames=args.max_frames,
        temperature=0.9, top_k=50, repetition_penalty=1.05, allow_eos=False)
    rid_to_idx = {}
    first, done = {}, {}
    state = {"next": 0}
    t0 = time.perf_counter()

    def feeder(idle):
        now = time.perf_counter() - t0
        nxt = state["next"]
        if idle and nxt < len(reqs) and arrivals[nxt] > now:
            time.sleep(arrivals[nxt] - now)
            now = time.perf_counter() - t0
        while state["next"] < len(reqs) and arrivals[state["next"]] <= now:
            i = state["next"]
            r = reqs[i]
            rid = sched.submit(r["tokens"], r["n_tokens"],
                               np.zeros((H,), np.float32),
                               tcfg.english_language_id, seed=r["seed"],
                               max_frames=r["budget"])
            rid_to_idx[rid] = i
            state["next"] += 1
        return state["next"] < len(reqs)

    def on_chunk(events):
        now = time.perf_counter() - t0
        for rid, rows, finished in events:
            i = rid_to_idx[rid]
            if rows.size and i not in first:
                first[i] = now - arrivals[i]
            if finished:
                done[i] = now - arrivals[i]

    results = sched.run(on_chunk=on_chunk, feeder=feeder)
    wall = time.perf_counter() - t0
    useful = sum(v.shape[0] for v in results.values())
    assert useful == sum(r["budget"] for r in reqs)
    assert len(first) == len(done) == len(reqs)
    return {"wall_s": round(wall, 3), "useful_frames": useful,
            "frames_per_s": round(useful / wall, 1),
            "t_first_codes_ms": _pcts(first.values()),
            "e2e_ms": _pcts(done.values()),
            "chunks": sched.chunks_run, "sessions": sched.sessions,
            "overlap_harvest": sched.overlap_harvest}


def _run_static_batch(tp, cp, tcfg, ccfg, args, batch_reqs, mf, seed):
    from qwen3tts_tpu.runtime.decode_loop import generate_from_tokens_batched

    B, Tb, H = args.lanes, args.text_bucket, tcfg.hidden_size
    C_static = -(-(10 + args.max_frames + 8) // 256) * 256
    tokens = np.zeros((B, Tb), np.int32)
    n_tok = np.ones((B,), np.int32)
    budgets = np.ones((B,), np.int32)   # empty lanes stop after 1 frame
    for g, r in enumerate(batch_reqs):
        tokens[g, :r["n_tokens"]] = r["tokens"]
        n_tok[g] = r["n_tokens"]
        budgets[g] = r["budget"]
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    # per-lane budgets emulate EOS: the batch's while_loop exits at
    # max-of-batch BUDGET (not the compiled 64-frame max_frames bucket),
    # exactly like a real EOS-terminated batch
    res = generate_from_tokens_batched(
        tp, cp, jnp.asarray(tokens), jnp.asarray(n_tok),
        jnp.zeros((B, H), tp.codec_embd.dtype),
        jnp.full((B,), tcfg.english_language_id, jnp.int32), keys,
        talker_cfg=tcfg, cp_cfg=ccfg, max_frames=mf,
        kv_capacity=C_static, temperature=0.9, top_k=50,
        repetition_penalty=1.05, allow_eos=False,
        budgets=jnp.asarray(budgets))
    jax.block_until_ready(res.codes)
    np.asarray(res.n_frames)   # the host fetch ends the timed work


def warm_static_buckets(tp, cp, tcfg, ccfg, reqs, args):
    """Compile the static batch program before timing (a compile landing
    mid-benchmark would corrupt the latencies). ONE shape: the
    per-lane budgets exit the while_loop at max-of-batch budget, so a
    single max_frames program serves every batch composition."""
    _run_static_batch(tp, cp, tcfg, ccfg, args, reqs[: args.lanes],
                      args.max_frames, 0)


def run_static_arrivals(tp, cp, tcfg, ccfg, reqs, arrivals, args):
    """Online static batch server on the same trace: batch whatever is
    queued whenever the device goes idle (<= lanes), run it until every
    member hits its budget (EOS emulation — per-lane budgets exit the
    loop at max-of-batch), everyone's codes land at batch end."""
    lat = {}
    batches = 0
    t0 = time.perf_counter()
    i, n = 0, len(reqs)
    while i < n:
        now = time.perf_counter() - t0
        if arrivals[i] > now:
            time.sleep(arrivals[i] - now)
            now = time.perf_counter() - t0
            if arrivals[i] > now:
                continue
        batch = []
        while i < n and arrivals[i] <= now and len(batch) < args.lanes:
            batch.append(i)
            i += 1
        _run_static_batch(tp, cp, tcfg, ccfg, args,
                          [reqs[j] for j in batch], args.max_frames, batches)
        end = time.perf_counter() - t0
        batches += 1
        for j in batch:
            lat[j] = end - arrivals[j]
    wall = time.perf_counter() - t0
    useful = sum(r["budget"] for r in reqs)
    return {"wall_s": round(wall, 3), "useful_frames": useful,
            "frames_per_s": round(useful / wall, 1),
            "t_first_codes_ms": _pcts(lat.values()),   # == e2e: batch end
            "e2e_ms": _pcts(lat.values()), "batches": batches}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--requests", type=int, default=192)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--refill-slots", type=int, default=8)
    ap.add_argument("--max-frames", type=int, default=256)
    ap.add_argument("--text-bucket", type=int, default=32)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate, req/s (0 = derive from "
                         "--utilization * --capacity-fps / mean budget)")
    ap.add_argument("--utilization", type=float, default=0.7)
    ap.add_argument("--capacity-fps", type=float, default=2500.0,
                    help="server decode throughput estimate used to derive "
                         "--rate (measure with benchmark_continuous first)")
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--static-only", action="store_true")
    ap.add_argument("--continuous-only", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config on CPU (harness smoke)")
    args = ap.parse_args()

    if args.tiny:
        jax.config.update("jax_platforms", "cpu")

    from qwen3tts_tpu.config import PipelineConfig, tiny_pipeline_config
    from qwen3tts_tpu.models import code_predictor as cp_model
    from qwen3tts_tpu.models import talker as talker_model
    from qwen3tts_tpu.ops.quant import quantize_block_params

    cfg = tiny_pipeline_config() if args.tiny else PipelineConfig()
    tcfg, ccfg = cfg.talker, cfg.code_predictor
    quant = os.environ.get("QWEN3TTS_BENCH_QUANT", "int8")
    print(f"device: {jax.devices()[0]}  quant: {quant}", file=sys.stderr)

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    tp = talker_model.init_talker_params(k1, tcfg, jnp.bfloat16)
    cp = cp_model.init_code_predictor_params(k2, ccfg, jnp.bfloat16)
    if quant in ("int8", "q4", "q4pure") and not args.tiny:
        from qwen3tts_tpu.ops.quant import quantize_talker_blocks
        tp = tp._replace(blocks=quantize_talker_blocks(tp.blocks, quant))
        cp = cp._replace(blocks=quantize_block_params(cp.blocks))
    jax.block_until_ready(tp.codec_embd)

    rng = np.random.default_rng(args.seed)
    reqs = make_requests(args.requests, rng, tb=args.text_bucket,
                         max_frames=args.max_frames)
    mean_budget = float(np.mean([r["budget"] for r in reqs]))
    rate = args.rate or (args.utilization * args.capacity_fps / mean_budget)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, args.requests))
    arrivals[0] = 0.0   # clock starts at the first arrival

    out = {"metric": "poisson_arrival_latency",
           "lanes": args.lanes, "requests": args.requests,
           "chunk": args.chunk, "quant": quant,
           "rate_req_s": round(rate, 3),
           "offered_load_fps": round(rate * mean_budget, 1),
           "budget_mean": round(mean_budget, 1),
           "trace_span_s": round(float(arrivals[-1]), 1)}

    # warm pass: all-at-once short trace compiles every program
    # (continuous decode/refill; static's 64-frame buckets)
    warm_n = min(args.requests, 2 * args.lanes)
    warm_reqs = reqs[:warm_n]
    warm_arr = np.zeros(warm_n)
    if not args.static_only:
        print("warm continuous...", file=sys.stderr)
        run_continuous_arrivals(tp, cp, tcfg, ccfg, warm_reqs, warm_arr, args)
        print("continuous (timed)...", file=sys.stderr)
        out["continuous"] = run_continuous_arrivals(
            tp, cp, tcfg, ccfg, reqs, arrivals, args)
    if not args.continuous_only:
        print("warm static buckets...", file=sys.stderr)
        warm_static_buckets(tp, cp, tcfg, ccfg, reqs, args)
        print("static (timed)...", file=sys.stderr)
        out["static"] = run_static_arrivals(
            tp, cp, tcfg, ccfg, reqs, arrivals, args)
    if "continuous" in out and "static" in out:
        out["e2e_p50_speedup"] = round(
            out["static"]["e2e_ms"]["p50"]
            / max(out["continuous"]["e2e_ms"]["p50"], 1e-9), 2)
        out["first_codes_p50_speedup"] = round(
            out["static"]["t_first_codes_ms"]["p50"]
            / max(out["continuous"]["t_first_codes_ms"]["p50"], 1e-9), 2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
