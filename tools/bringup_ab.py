#!/usr/bin/env python
"""Layer timings on the card for the bring-up decisions.

    python tools/bringup_ab.py [--out chiprun_out/bringup_ab.json]
                               [--sections attention,talker,predictor,vocoder,longform,trace]

One process, one card. Weights are synthetic at the full width of the 0.6B
configuration. Every time is the median over repeats of a jitted call that
ends in block_until_ready, with compilation excluded.

  attention  decode attention over one layer of a [L, 2, Hkv, C, D] bf16
             cache: the split-K Pallas kernel against the XLA einsum (and
             cuDNN through jax.nn.dot_product_attention, which needs the
             seq-major layout, so its time includes the transpose), at
             C in {1024, 2304, 4352}, n_valid in {64, 1024, C}, single
             stream and vmapped B in {16, 64}; 28 layers per call
  talker     one talker decode step (28 layers), bf16 and int8 weights, at
             C = 512 and 4352, kernel on and off
  predictor  one frame of the code predictor (15 sequential 5-layer passes)
  vocoder    the vocoder forward at 256 frames, default and float32 matmul
             precision
  longform   ms/frame of the decode loop at C = 4352, kernel on and off, at
             a shallow (n_past ~ 10) and a deep (n_past ~ 3000) start
  trace      the top device ops of 16 talker steps at C = 4352 (bf16), from
             a jax.profiler trace
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

from qwen3tts_tpu.config import PipelineConfig  # noqa: E402
from qwen3tts_tpu.models import code_predictor as cp_model  # noqa: E402
from qwen3tts_tpu.models import talker as talker_model  # noqa: E402
from qwen3tts_tpu.models import vocoder as vocoder_model  # noqa: E402
from qwen3tts_tpu.ops.attention import decode_attention, kernel_allowed  # noqa: E402
from qwen3tts_tpu.ops.pallas_attention import decode_attention_pallas_layered  # noqa: E402
from qwen3tts_tpu.ops.quant import quantize_block_params, quantize_talker_blocks  # noqa: E402
from qwen3tts_tpu.pipeline import enable_compile_cache  # noqa: E402
from qwen3tts_tpu.runtime import decode_loop as DL  # noqa: E402
from qwen3tts_tpu.utils import device  # noqa: E402

CFG = PipelineConfig()
TCFG, CCFG, VCFG = CFG.talker, CFG.code_predictor, CFG.vocoder
RESULTS: dict = {}


def _ms(fn, *args, reps=20, inner=1):
    """Median wall ms of fn(*args) (already compiled by one warm call)."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) * 1e3 / inner)
    return float(np.median(ts))


def _put(section, key, value):
    RESULTS.setdefault(section, {})[key] = value
    print(f"  {section} {key}: {value}", flush=True)


def _params(tier):
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    tp = talker_model.init_talker_params(k1, TCFG, jnp.bfloat16)
    cp = cp_model.init_code_predictor_params(k2, CCFG, jnp.bfloat16)
    if tier == "int8":
        tp = tp._replace(blocks=quantize_talker_blocks(tp.blocks, "int8"))
        cp = cp._replace(blocks=quantize_block_params(cp.blocks))
    return tp, cp


def attention():
    L, Hq, Hkv, D = TCFG.n_layers, TCFG.n_heads, TCFG.n_kv_heads, TCFG.head_dim

    def over_layers(attn):
        def f(q, kv, n):
            def body(acc, li):
                return acc + attn(q, kv, li, n).astype(jnp.float32), None
            acc, _ = lax.scan(body, jnp.zeros((Hq, D), jnp.float32),
                              jnp.arange(L, dtype=jnp.int32))
            return acc
        return f

    kern = over_layers(lambda q, kv, li, n: decode_attention_pallas_layered(
        q, kv, li, n))
    xla = over_layers(lambda q, kv, li, n: decode_attention(
        q, kv[li, 0], kv[li, 1], n))

    def cudnn_one(q, kv, li, n):
        k = jnp.swapaxes(kv[li, 0], 0, 1)[None]      # [1, C, Hkv, D]
        v = jnp.swapaxes(kv[li, 1], 0, 1)[None]
        o = jax.nn.dot_product_attention(
            q[None, None], k, v, implementation="cudnn",
            key_value_seq_lengths=jnp.asarray(n, jnp.int32)[None])
        return o[0, 0]

    cudnn = over_layers(cudnn_one)
    # n_valid is a traced argument: one compile per (impl, B, C)
    impls = {"kernel": jax.jit(jax.vmap(kern)), "xla": jax.jit(jax.vmap(xla)),
             "cudnn": jax.jit(jax.vmap(cudnn))}
    for C in (1024, 2304, 4352):
        base = jax.random.normal(jax.random.PRNGKey(C), (1, L, 2, Hkv, C, D),
                                 jnp.float32).astype(jnp.bfloat16)
        for B in (1, 16, 64):
            kv = jnp.broadcast_to(base, (B,) + base.shape[1:])
            q = jax.random.normal(jax.random.PRNGKey(1), (B, Hq, D), jnp.bfloat16)
            for n in sorted({64, 1024, C}):
                ns = jnp.full((B,), n, jnp.int32)
                for name, fn in impls.items():
                    if name == "cudnn" and B > 1:
                        continue
                    try:
                        ms = _ms(fn, q, kv, ns, reps=10, inner=5)
                    except Exception as e:  # noqa: BLE001 - record, go on
                        ms = f"failed: {type(e).__name__}: {str(e)[:160]}"
                    key = f"C={C} B={B} n_valid={n} {name}"
                    _put("attention_ms_per_step_28_layers", key, ms)
            del kv
        del base


def _step_fn(attn_kernel):
    """Weights are arguments, never closed-over constants."""
    @functools.partial(jax.jit, donate_argnums=(3,))
    def step(tp, e, n, kv):
        with kernel_allowed(attn_kernel):
            h, logits, kv = talker_model.talker_step(tp, TCFG, e, n, kv)
        return logits, kv
    return step


def talker():
    for tier in ("bf16", "int8"):
        tp, _ = _params(tier)
        e = jnp.zeros((TCFG.hidden_size,), jnp.bfloat16)
        for C in (512, 4352):
            for attn_kernel in ((False,) if C < 1024 else (True, False)):
                step = _step_fn(attn_kernel)
                kv = talker_model.make_kv_cache(TCFG, C, jnp.bfloat16)
                n = jnp.int32(min(300, C - 1))
                _, kv = step(tp, e, n, kv)
                jax.block_until_ready(kv)
                ts = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    for _ in range(10):
                        _, kv = step(tp, e, n, kv)
                    jax.block_until_ready(kv)
                    ts.append((time.perf_counter() - t0) * 100)
                key = f"{tier} C={C} n_past=300 kernel={'on' if attn_kernel else 'off'}"
                _put("talker_ms_per_step", key, float(np.median(ts)))
                del kv


def predictor():
    for tier in ("bf16", "int8"):
        tp, cp = _params(tier)
        h = jnp.ones((TCFG.hidden_size,), jnp.bfloat16) * 0.1
        e = tp.codec_embd[5]
        for greedy in (True, False):
            fn = jax.jit(lambda cp, h, e, k, greedy=greedy: cp_model.predict_codes(
                cp, CCFG, h, e, k, temperature=0.0 if greedy else 0.9,
                top_k=0 if greedy else 50))
            ms = _ms(fn, cp, h, e, jax.random.PRNGKey(0), reps=20, inner=10)
            _put("predictor_ms_per_frame",
                 f"{tier} {'greedy' if greedy else 'sampled top_k=50'}", ms)


def vocoder():
    vp = vocoder_model.init_vocoder_params(jax.random.PRNGKey(4), VCFG, jnp.float32)
    codes = jax.random.randint(jax.random.PRNGKey(5), (256, VCFG.n_codebooks),
                               0, VCFG.codebook_size)
    for prec in ("default", "float32"):
        with jax.default_matmul_precision(prec):
            g = jax.jit(lambda vp, c: vocoder_model.vocoder_forward(
                vp, VCFG, c, 256))
            ms = _ms(g, vp, codes, reps=10)
        _put("vocoder_ms_256_frames", f"precision={prec}", ms)


def longform():
    for tier in ("bf16", "int8"):
        tp, cp = _params(tier)
        tokens = jnp.zeros((32,), jnp.int32).at[:20].set(jnp.arange(20) + 100)
        K = 64
        for attn_kernel in (True, False):
            @functools.partial(jax.jit, donate_argnums=(3,))
            def chunk(tp, cp, prefill, s, attn_kernel=attn_kernel):
                with kernel_allowed(attn_kernel):
                    body = DL._make_body(
                        tp, cp, TCFG, CCFG, prefill, temperature=0.9,
                        top_k=50, top_p=1.0, repetition_penalty=1.05,
                        progress_cb=None, allow_eos=False)
                    target = s.frame + K
                    return lax.while_loop(lambda x: x.frame < target, body, s)

            for depth in (10, 3000):
                state, prefill = DL.generate_init(
                    tp, cp, tokens, jnp.int32(20),
                    jnp.zeros((TCFG.hidden_size,), jnp.float32),
                    jnp.int32(2050), jax.random.PRNGKey(0), talker_cfg=TCFG,
                    cp_cfg=CCFG, max_frames=4096, kv_capacity=4352)
                state = state._replace(n_past=jnp.int32(depth))
                state = chunk(tp, cp, prefill, state)
                jax.block_until_ready(state.kv)
                ts = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    state = chunk(tp, cp, prefill, state)
                    jax.block_until_ready(state.kv)
                    ts.append((time.perf_counter() - t0) * 1e3 / K)
                key = (f"{tier} C=4352 n_past~{depth} kernel="
                       f"{'on' if attn_kernel else 'off'}")
                _put("longform_ms_per_frame", key, float(np.median(ts)))
                del state


def trace():
    tp, _ = _params("bf16")
    step = _step_fn(True)
    e = jnp.zeros((TCFG.hidden_size,), jnp.bfloat16)
    kv = talker_model.make_kv_cache(TCFG, 4352, jnp.bfloat16)
    n = jnp.int32(300)
    _, kv = step(tp, e, n, kv)
    jax.block_until_ready(kv)
    d = tempfile.mkdtemp()
    jax.profiler.start_trace(d)
    for _ in range(16):
        _, kv = step(tp, e, n, kv)
    jax.block_until_ready(kv)
    jax.profiler.stop_trace()
    paths = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs
             if f.endswith(".xplane.pb")]
    prof = jax.profiler.ProfileData.from_file(paths[0])
    per_op: dict[str, float] = {}
    total = 0.0
    planes = [p.name for p in prof.planes]
    _put("trace_talker_step_bf16_C4352", "planes", planes)
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                per_op[ev.name] = per_op.get(ev.name, 0.0) + ev.duration_ns
                total += ev.duration_ns
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:15]
    _put("trace_talker_step_bf16_C4352", "device_ns_total_16_steps", total)
    for name, ns in top:
        _put("trace_talker_step_bf16_C4352", name[:90],
             f"{ns / 16 / 1e3:.1f} us/step ({100 * ns / max(total, 1):.1f}%)")


SECTIONS = {"attention": attention, "talker": talker, "predictor": predictor,
            "vocoder": vocoder, "longform": longform, "trace": trace}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/bringup_ab.json")
    ap.add_argument("--sections", default=",".join(SECTIONS))
    args = ap.parse_args(argv)
    device.require_gpu("bringup_ab")
    enable_compile_cache()
    RESULTS["card"] = device.gpu_name_and_power_limit()
    RESULTS["device"] = device.describe()
    print(f"card: {RESULTS['card']}  device: {RESULTS['device']}", flush=True)
    failed = []
    for name in args.sections.split(","):
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            SECTIONS[name]()
        except Exception as e:  # noqa: BLE001 - keep the other sections
            failed.append(name)
            RESULTS.setdefault("errors", {})[name] = f"{type(e).__name__}: {e}"[:500]
            print(f"[{name}] FAILED: {type(e).__name__}: {e}", flush=True)
        print(f"[{name}] {time.perf_counter() - t0:.1f} s", flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(RESULTS, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
