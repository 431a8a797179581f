#!/usr/bin/env python
"""On-card A/B of the batched-vocode matmul precision tier.

The batched vocoder runs at float32 matmul precision by default
(pipeline._vocode_precision). This measures, for each precision in
{float32, BF16_BF16_F32_X3, default}:

  quality: vmapped-16 output vs the f32-truth reference (unbatched, precision
           float32 — the exact product of the bf16 weights), as corr /
           max|d| / rel-RMS. The unbatched output at the same precision is
           reported alongside: single-stream serving runs at DEFAULT
           precision, so its own distance to truth is the quality bar a
           batched tier must meet, not zero.
  speed:   wall for ceil(64/16)=4 vmapped dispatches of [16, 256] frames,
           min of 3 reps.

Decision rule: pick the fastest tier whose rel-RMS vs truth is <= the
unbatched-default tier's rel-RMS * 1.25 (i.e. batched audio no further from
truth than single-stream audio already is, with 25% slack because the
distance is itself chaotic-amplification noise — vmapped-f32 vs unbatched-f32
already shows rel-RMS 0.23 on CPU, so equality at the boundary is a coin
flip, not a quality signal). The strict no-slack pick is emitted alongside
(`pick_strict`) so the decision is auditable either way.

Usage: python tools/ab_vocode_precision.py [--frames 256] [--reps 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from qwen3tts_tpu.pipeline import enable_compile_cache  # noqa: E402

enable_compile_cache()

from qwen3tts_tpu.config import PipelineConfig
from qwen3tts_tpu.models import vocoder as V

PRECISIONS = ["float32", "BF16_BF16_F32_X3", "default"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--groups", type=int, default=4, help="dispatches per rep (64 lanes total)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    cfg = PipelineConfig().vocoder
    T, G = args.frames, args.lanes
    params = jax.block_until_ready(jax.jit(
        lambda: V.init_vocoder_params(jax.random.PRNGKey(3), cfg, jnp.bfloat16))())

    rng = np.random.default_rng(0)
    codes = jnp.asarray(rng.integers(0, 256, size=(G, T, cfg.n_codebooks), dtype=np.int64),
                        jnp.int32)
    n = jnp.full((G,), T, jnp.int32)

    def unbatched(precision):
        @jax.jit
        def run(params, c):
            with jax.default_matmul_precision(precision):
                return V.vocoder_forward(params, cfg, c, jnp.int32(T))
        return run

    def batched(precision):
        @jax.jit
        def run(params, c, n):
            with jax.default_matmul_precision(precision):
                return jax.vmap(
                    lambda ci, ni: V.vocoder_forward(params, cfg, ci, ni))(c, n)
        return run

    # f32 truth: the exact product of the bf16 weights (6-pass dots).
    truth = np.asarray(unbatched("float32")(params, codes[0]), np.float64)
    tnorm = float(np.sqrt(np.mean(truth ** 2)))

    def qual(y):
        y = np.asarray(y, np.float64)
        d = y - truth
        corr = float(np.corrcoef(y, truth)[0, 1])
        return {"corr": round(corr, 6),
                "max_abs_d": round(float(np.abs(d).max()), 4),
                "rel_rms": round(float(np.sqrt(np.mean(d ** 2))) / max(tnorm, 1e-30), 6)}

    out = {"frames": T, "lanes": G, "groups": args.groups,
           "device": str(jax.devices()[0]), "tiers": {}}
    for p in PRECISIONS:
        fu, fb = unbatched(p), batched(p)
        yu = fu(params, codes[0])
        yb = fb(params, codes, n)
        _ = np.asarray(yu), np.asarray(yb)  # compile + settle
        t = float("inf")
        for _rep in range(args.reps):
            t0 = time.perf_counter()
            for _g in range(args.groups):
                yb = fb(params, codes, n)
            _ = np.asarray(yb[:, -8:])
            t = min(t, time.perf_counter() - t0)
        out["tiers"][p] = {
            "unbatched_vs_truth": qual(yu),
            "vmapped_vs_truth": qual(np.asarray(yb)[0]),
            "wall_s_64lanes": round(t, 3),
            "ms_per_lane": round(t / (G * args.groups) * 1e3, 2),
        }
        print(json.dumps({p: out["tiers"][p]}), flush=True)

    # decision: fastest tier whose vmapped rel_rms <= unbatched-default
    # rel_rms * 1.25 (slack documented in the module docstring); the strict
    # no-slack pick is emitted too so the call is auditable.
    bar = out["tiers"]["default"]["unbatched_vs_truth"]["rel_rms"]
    def _pick(slack):
        ok = [p for p in PRECISIONS
              if out["tiers"][p]["vmapped_vs_truth"]["rel_rms"] <= bar * slack]
        return (min(ok, key=lambda p: out["tiers"][p]["wall_s_64lanes"])
                if ok else "float32")
    pick, pick_strict = _pick(1.25), _pick(1.0)
    out["quality_bar_rel_rms"] = bar
    out["quality_bar_slack"] = 1.25
    out["pick"] = pick
    out["pick_strict"] = pick_strict
    print(json.dumps({"summary": {
        "quality_bar_rel_rms": bar, "quality_bar_slack": 1.25,
        "pick": pick, "pick_strict": pick_strict,
        "walls": {p: out["tiers"][p]["wall_s_64lanes"] for p in PRECISIONS}}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
