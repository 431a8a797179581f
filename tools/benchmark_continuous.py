#!/usr/bin/env python
"""Continuous-batching serving benchmark: aggregate useful frames/s on a
variable-length request mix, vs the static batched loop on the same mix.

Static batching's cost on unequal lengths is structural: a batch runs until
its LONGEST request finishes, so useful occupancy ~= mean/max of the length
distribution (~60% for a typical TTS mix). The continuous scheduler
(runtime/continuous.py) refills finished lanes mid-flight and only pays a
small per-session drain + per-chunk refill cost.

Lengths here are per-request frame budgets (synthetic weights never emit
EOS, so budgets emulate the EOS-driven length spread of real serving; the
static baseline runs each batch to the batch's max budget, exactly like
real EOS behavior, and both sides are credited only sum(budgets) useful
frames).

    python tools/benchmark_continuous.py --lanes 64 --requests 192 \
        [--capacity 1024] [--chunk 32] [--quant int8|bf16] [--static-only|--continuous-only]

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

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def make_requests(n, rng, *, tb, max_frames):
    """Budgets from a clipped lognormal — a TTS-like length mix with
    mean/max ~0.55 (the static loop's structural occupancy ceiling)."""
    budgets = np.clip(rng.lognormal(np.log(110), 0.45, n), 24,
                      max_frames).astype(np.int32)
    reqs = []
    for i in range(n):
        ntok = int(rng.integers(10, tb))
        tokens = rng.integers(2, 2000, size=ntok).astype(np.int32)
        reqs.append(dict(tokens=tokens, n_tokens=ntok,
                         budget=int(budgets[i]), seed=1000 + i))
    return reqs


def run_continuous(tp, cp, tcfg, ccfg, reqs, args):
    from qwen3tts_tpu.runtime.continuous import ContinuousScheduler

    H = tcfg.hidden_size
    useful = sum(r["budget"] for r in reqs)

    def one_pass():
        sched = ContinuousScheduler(
            tp, cp, tcfg, ccfg, lanes=args.lanes, kv_capacity=args.capacity,
            text_bucket=args.text_bucket, chunk_frames=args.chunk,
            refill_slots=args.refill_slots, max_frames=args.max_frames,
            temperature=0.9, top_k=50, repetition_penalty=1.05,
            allow_eos=False, compact_threshold=args.compact_threshold,
            compact_policy=args.compact_policy, timing=args.timing)
        for r in reqs:
            sched.submit(r["tokens"], r["n_tokens"],
                         np.zeros((H,), np.float32),
                         tcfg.english_language_id, seed=r["seed"],
                         max_frames=r["budget"])
        t0 = time.perf_counter()
        results = sched.run()
        wall = time.perf_counter() - t0
        got = sum(v.shape[0] for v in results.values())
        assert got == useful, (got, useful)
        return wall, sched

    for _ in range(args.passes - 1):   # warm the two compiled programs
        one_pass()
    wall, sched = one_pass()
    res = dict(wall_s=round(wall, 3),
               useful_frames=useful,
               frames_per_s=round(useful / wall, 1),
               chunks=sched.chunks_run, sessions=sched.sessions,
               compactions=sched.compactions, refills=sched.refills,
               occupancy=round(
                   useful / (sched.chunks_run * args.chunk * args.lanes), 3))
    if args.timing:
        res["phases"] = {k: round(v, 3) for k, v in sched.stats.items()}
        # residual = host scheduling + anything blocking OUTSIDE the four
        # device phases (this is how the per-request PRNGKey round trips
        # were found: 5.1 s of "other" in a 12 s run)
        res["phases"]["other"] = round(wall - sum(sched.stats.values()), 3)
        res["decode_ms_per_frame_set"] = round(
            1e3 * sched.stats["decode_s"] / (sched.chunks_run * args.chunk), 2)
    return res


def _static_batches(reqs, B, order="sorted"):
    """Static batches, each run EXACTLY max-of-batch frames (what EOS would
    do): one compile per distinct batch max, amortized by the persistent
    cache + warm pass.

    order="sorted": length-grouped (sorted by budget) — the OFFLINE-ORACLE
    baseline; it needs every request's length up front, which online serving
    never has. order="arrival": consecutive submission-order batches — the
    realistic online static baseline (a batch's wall is dominated by its
    longest member, so mixed batches idle short lanes hard)."""
    ordered = (sorted(reqs, key=lambda r: r["budget"], reverse=True)
               if order == "sorted" else list(reqs))
    out = []
    for off in range(0, len(ordered), B):
        batch = list(ordered[off:off + B])
        while len(batch) < B:
            batch.append(batch[-1])   # pad the tail batch (full-cost lanes)
        out.append((max(r["budget"] for r in batch), batch))
    return out


def run_static(tp, cp, tcfg, ccfg, reqs, args, order="sorted"):
    """Static baseline: B-lane batches, each running to its max budget
    (what EOS-driven static batching does), credited only sum(budgets)
    useful frames. order: see _static_batches."""
    from qwen3tts_tpu.runtime.decode_loop import generate_from_tokens_batched

    B, Tb = args.lanes, args.text_bucket
    H = tcfg.hidden_size
    useful = sum(r["budget"] for r in reqs)
    batches = _static_batches(reqs, B, order)
    # static needs only one request span of cache (256-aligned), not the
    # continuous session capacity — give it its natural (cheaper) size
    C_static = -(-(10 + args.max_frames + 8) // 256) * 256

    def one_pass():
        wall = 0.0
        for bi, (mf, batch) in enumerate(batches):
            tokens = np.zeros((B, Tb), np.int32)
            n_tok = np.zeros((B,), np.int32)
            for i, r in enumerate(batch):
                tokens[i, :r["n_tokens"]] = r["tokens"]
                n_tok[i] = r["n_tokens"]
            keys = jax.random.split(jax.random.PRNGKey(bi), B)
            t0 = time.perf_counter()
            res = generate_from_tokens_batched(
                tp, cp, jnp.asarray(tokens), jnp.asarray(n_tok),
                jnp.zeros((B, H), tp.codec_embd.dtype),
                jnp.full((B,), tcfg.english_language_id, jnp.int32), keys,
                talker_cfg=tcfg, cp_cfg=ccfg, max_frames=mf,
                kv_capacity=C_static, temperature=0.9, top_k=50,
                repetition_penalty=1.05, allow_eos=False)
            jax.block_until_ready(res.codes)
            np.asarray(res.n_frames)  # the host fetch ends the timed work
            wall += time.perf_counter() - t0
        return wall

    for _ in range(args.passes - 1):   # warm each max_frames bucket
        one_pass()
    wall = one_pass()
    return dict(wall_s=round(wall, 3),
                useful_frames=useful,
                frames_per_s=round(useful / wall, 1),
                buckets=sorted({mf for mf, _ in batches}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--requests", type=int, default=192)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--refill-slots", type=int, default=8)
    ap.add_argument("--max-frames", type=int, default=256)
    ap.add_argument("--text-bucket", type=int, default=32)
    ap.add_argument("--passes", type=int, default=2,
                    help="timed pass is the last; earlier passes warm "
                         "compiles (persistent cache makes reruns cheap)")
    ap.add_argument("--compact-threshold", type=int, default=128)
    ap.add_argument("--compact-policy", default="pressure",
                    choices=("pressure", "opportunistic"),
                    help="pressure (default): compact only when admission "
                         "blocks; opportunistic: also shift whenever "
                         "min(start) >= threshold (no decode benefit; a "
                         "correctness stressor)")
    ap.add_argument("--timing", action="store_true",
                    help="per-phase wall decomposition (adds a device sync "
                         "after every program — diagnosis, not headline)")
    ap.add_argument("--static-only", action="store_true")
    ap.add_argument("--continuous-only", action="store_true")
    ap.add_argument("--no-sorted", action="store_true",
                    help="skip the length-sorted oracle baseline (at large "
                         "--requests each sorted batch has a distinct max "
                         "=> one compile per batch; arrival batches "
                         "nearly all share max_frames)")
    ap.add_argument("--arrival-static", action="store_true",
                    help="also run the arrival-order static baseline (the "
                         "online-realistic one; sorted static is an offline "
                         "oracle that knows every length up front)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config (CPU smoke of the harness itself)")
    args = ap.parse_args()

    if args.tiny:
        # --tiny is a harness smoke on the CPU
        jax.config.update("jax_platforms", "cpu")

    from qwen3tts_tpu.config import PipelineConfig, tiny_pipeline_config
    from qwen3tts_tpu.models import code_predictor as cp_model
    from qwen3tts_tpu.models import talker as talker_model
    from qwen3tts_tpu.ops.quant import quantize_block_params

    cfg = tiny_pipeline_config() if args.tiny else PipelineConfig()
    tcfg, ccfg = cfg.talker, cfg.code_predictor
    quant = os.environ.get("QWEN3TTS_BENCH_QUANT", "int8")

    print(f"device: {jax.devices()[0]}", file=sys.stderr)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    tp = talker_model.init_talker_params(k1, tcfg, jnp.bfloat16)
    cp = cp_model.init_code_predictor_params(k2, ccfg, jnp.bfloat16)
    if quant in ("int8", "q4", "q4pure"):
        from qwen3tts_tpu.ops.quant import quantize_talker_blocks
        tp = tp._replace(blocks=quantize_talker_blocks(tp.blocks, quant))
        cp = cp._replace(blocks=quantize_block_params(cp.blocks))
    jax.block_until_ready(tp.codec_embd)

    rng = np.random.default_rng(17)
    reqs = make_requests(args.requests, rng, tb=args.text_bucket,
                         max_frames=args.max_frames)
    out = {"metric": "continuous_vs_static_aggregate_fps",
           "lanes": args.lanes, "requests": args.requests,
           "capacity": args.capacity, "chunk": args.chunk, "quant": quant,
           "budget_mean": round(float(np.mean([r["budget"] for r in reqs])), 1),
           "budget_max": int(max(r["budget"] for r in reqs))}

    if not args.static_only:
        print("continuous...", file=sys.stderr)
        out["continuous"] = run_continuous(tp, cp, tcfg, ccfg, reqs, args)
    if not args.continuous_only:
        if not args.no_sorted:
            print("static baseline (length-sorted oracle)...", file=sys.stderr)
            out["static"] = run_static(tp, cp, tcfg, ccfg, reqs, args)
        if args.arrival_static:
            print("static baseline (arrival order)...", file=sys.stderr)
            out["static_arrival"] = run_static(
                tp, cp, tcfg, ccfg, reqs, args, order="arrival")
    if "continuous" in out and "static" in out:
        out["speedup"] = round(out["continuous"]["frames_per_s"]
                               / out["static"]["frames_per_s"], 3)
    if "continuous" in out and "static_arrival" in out:
        out["speedup_vs_arrival"] = round(
            out["continuous"]["frames_per_s"]
            / out["static_arrival"]["frames_per_s"], 3)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
