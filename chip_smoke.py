#!/usr/bin/env python
"""On-card smoke test of the Qwen3-TTS main path, on NVIDIA GPUs.

    python chip_smoke.py          # one card: kernel, parity, main path
    python chip_smoke.py --four   # four cards: the dp=4 paths and their
                                  # one-card comparison, nothing else

Everything runs in this one process: a JAX process reserves most of a card's
memory when it starts, so a second process (for instance the CLI run as a
subprocess) could not get the card. The CLI is called in process through
``cli.main``. Weights are synthetic, made from fixed seeds, at the full width
of the 0.6B configuration (``config.PipelineConfig()``).

Phases (one card):
  kernel     the split-K decode-attention kernel at real widths, compiled
             for the card, against ops/attention.decode_attention in f32 at
             "highest" precision
  parity     talker prefill logits + 8 teacher-forced decode steps, bf16 and
             int8 tiers on the card, against a float32 run of the same
             program on the CPU backend with the same (dequantized)
             weights; vocoder audio for a fixed code sequence
  main_path  Qwen3TTS.synthesize (the 4096-frame bucket, whose cache takes
             the kernel, and two 200-frame requests), synthesize_with_voice,
             synthesize_batch (16 lanes), synthesize_queue with streaming
             on_audio, and cli.main writing a WAV

The earlier lines print the card's name and power limit, the device JAX
sees, each check against its bound, and informational timings. The last
line is one JSON object: {"ok": true, "device": {...}}. With no GPU, or when
any phase fails, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np


def _log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: the decode-attention kernel
# ---------------------------------------------------------------------------

# bf16 inputs: the kernel rounds the softmax weights to bf16 before the PV
# product (relative error 2^-9 per weight) and the output is a convex
# combination of V rows with |v| < ~5, so |error| stays below ~1e-2.
# f32 inputs: both sides run IEEE f32 dots; only the summation order
# differs (blocks, splits).
KERNEL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def phase_kernel(*, L=28, Hq=16, Hkv=8, D=128, C=4352, lanes=16,
                 block_k=None, interpret=False):
    import jax
    import jax.numpy as jnp

    from qwen3tts_tpu.ops.attention import decode_attention
    from qwen3tts_tpu.ops.pallas_attention import (
        BLOCK_K, decode_attention_pallas_layered)

    block_k = block_k or BLOCK_K
    kern = jax.jit(lambda q, kv, layer, n, s: decode_attention_pallas_layered(
        q, kv, layer, n, s, block_k=block_k, interpret=interpret))

    def ref(q, kv, layer, n, s):
        with jax.default_matmul_precision("highest"):
            f = jnp.float32
            return decode_attention(q.astype(f), kv[layer, 0].astype(f),
                                    kv[layer, 1].astype(f), n, s)

    cases = [(0, 1, 0), (5, 64, 0), (L - 1, min(1000, C), 0), (L // 2, C, 0),
             (1, (3 * C) // 4, C // 4)]
    for dtype in (jnp.bfloat16, jnp.float32):
        k1, k2 = jax.random.split(jax.random.PRNGKey(7))
        kv = jax.random.normal(k1, (L, 2, Hkv, C, D), jnp.float32).astype(dtype)
        q = jax.random.normal(k2, (Hq, D), jnp.float32).astype(dtype)
        tol = KERNEL_TOL[jnp.dtype(dtype).name]
        for layer, n, s in cases:
            got = kern(q, kv, jnp.int32(layer), jnp.int32(n), jnp.int32(s))
            err = float(jnp.max(jnp.abs(got.astype(jnp.float32)
                                        - ref(q, kv, layer, n, s))))
            _log(f"  kernel {jnp.dtype(dtype).name} L={L} C={C} layer={layer} "
                 f"n_valid={n} start={s}: max|err|={err:.3e} (tol {tol:.0e})")
            assert np.isfinite(err) and err <= tol, "kernel != reference"
        if dtype == jnp.bfloat16:
            lowered = kern.lower(q, kv, jnp.int32(0), jnp.int32(C), jnp.int32(0))
            _log(f"  memory_analysis (layered, bf16, C={C}): "
                 f"{lowered.compile().memory_analysis()}")
        del kv

    # vmapped lanes (the batched loop's shape): 2 layers, per-lane lengths
    k1, k2 = jax.random.split(jax.random.PRNGKey(8))
    kvb = jax.random.normal(k1, (lanes, 2, 2, Hkv, C, D), jnp.bfloat16)
    qb = jax.random.normal(k2, (lanes, Hq, D), jnp.bfloat16)
    ns = jnp.asarray(np.linspace(1, C, lanes).astype(np.int32))
    got = jax.jit(jax.vmap(lambda q, kv, n: decode_attention_pallas_layered(
        q, kv, 1, n, block_k=block_k, interpret=interpret)))(qb, kvb, ns)
    want = jax.vmap(lambda q, kv, n: ref(q, kv, 1, n, 0))(qb, kvb, ns)
    err = float(jnp.max(jnp.abs(got.astype(jnp.float32) - want)))
    _log(f"  kernel vmapped B={lanes} bf16: max|err|={err:.3e} "
         f"(tol {KERNEL_TOL['bfloat16']:.0e})")
    assert err <= KERNEL_TOL["bfloat16"], "vmapped kernel != reference"


# ---------------------------------------------------------------------------
# phase 2: model parity at full width
# ---------------------------------------------------------------------------

# Bounds for the card (bf16 activations) against the f32 CPU reference on
# the same weights: per-position logits cosine, and the share of positions
# whose top-1 id agrees. Random synthetic logits have small top-1 margins,
# so agreement is bounded loosely; chained greedy codes are not gated (one
# near-tie flip changes every later frame).
PARITY_MIN_COSINE = 0.99
PARITY_MIN_TOP1 = 0.6
VOCODER_MAX_REL_RMS = 5e-2


def _dequantized_f32(tree):
    import jax
    import jax.numpy as jnp

    from qwen3tts_tpu.ops.quant import (QuantLinear, QuantLinear4, dequantize,
                                        dequantize4)

    def f(x):
        if isinstance(x, QuantLinear):
            return dequantize(x, jnp.float32)
        if isinstance(x, QuantLinear4):
            return dequantize4(x, jnp.float32)
        return jnp.asarray(x, jnp.float32)

    return jax.tree.map(f, tree, is_leaf=lambda x: isinstance(
        x, (QuantLinear, QuantLinear4)))


def teacher_forced_logits(tp, tcfg, prefill_embd, step_embds, capacity):
    """Prefill logits + one talker step per row of step_embds (the inputs
    are given, not sampled). Returns [1 + n_steps, Vc] f32."""
    import jax
    import jax.numpy as jnp

    from qwen3tts_tpu.models import talker as talker_model

    kv = talker_model.make_kv_cache(tcfg, capacity, tp.codec_embd.dtype)
    _, logits0, kv = talker_model.talker_prefill(tp, tcfg, prefill_embd, kv)

    def step(carry, e):
        kv, n_past = carry
        _, logits, kv = talker_model.talker_step(tp, tcfg, e, n_past, kv)
        return (kv, n_past + 1), logits

    P = prefill_embd.shape[0]
    _, logits = jax.lax.scan(step, (kv, jnp.int32(P)), step_embds)
    return jnp.concatenate([logits0[None], logits], axis=0)


def phase_parity(cfg, *, n_steps=8, capacity=4352, vocoder_frames=32):
    import functools

    import jax
    import jax.numpy as jnp

    from qwen3tts_tpu.models import talker as talker_model
    from qwen3tts_tpu.models import vocoder as vocoder_model
    from qwen3tts_tpu.ops.quant import quantize_talker_blocks

    tcfg, vcfg = cfg.talker, cfg.vocoder
    cpu = jax.devices("cpu")[0]
    H = tcfg.hidden_size
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    tp_bf16 = talker_model.init_talker_params(k1, tcfg, jnp.bfloat16)
    prefill = (0.5 * jax.random.normal(k2, (10, H))).astype(jnp.bfloat16)
    steps = (0.5 * jax.random.normal(k3, (n_steps, H))).astype(jnp.bfloat16)
    run = jax.jit(functools.partial(teacher_forced_logits, tcfg=tcfg,
                                    capacity=capacity))
    # the reference's cache only needs the rows it uses (masking makes the
    # capacity invisible to the math)
    run_ref = jax.jit(functools.partial(teacher_forced_logits, tcfg=tcfg,
                                        capacity=16 + n_steps))

    for tier in ("bf16", "int8"):
        tp = tp_bf16 if tier == "bf16" else tp_bf16._replace(
            blocks=quantize_talker_blocks(tp_bf16.blocks, "int8"))
        got = np.asarray(run(tp, prefill_embd=prefill, step_embds=steps),
                         np.float64)
        ref_params = jax.device_put(_dequantized_f32(tp), cpu)
        with jax.default_device(cpu), jax.default_matmul_precision("highest"):
            want = np.asarray(run_ref(
                ref_params, prefill_embd=jax.device_put(
                    prefill.astype(jnp.float32), cpu),
                step_embds=jax.device_put(steps.astype(jnp.float32), cpu)),
                np.float64)
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        top1 = float(np.mean(got.argmax(-1) == want.argmax(-1)))
        _log(f"  parity {tier}: prefill + {n_steps} teacher-forced steps at "
             f"C={capacity}: min cosine {cos.min():.5f} (bound "
             f"{PARITY_MIN_COSINE}), top-1 agreement {top1:.2f} (bound "
             f"{PARITY_MIN_TOP1})")
        assert np.isfinite(got).all(), f"{tier}: non-finite logits"
        assert cos.min() >= PARITY_MIN_COSINE, f"{tier}: logits cosine"
        assert top1 >= PARITY_MIN_TOP1, f"{tier}: top-1 agreement"
        del ref_params

    vp = vocoder_model.init_vocoder_params(jax.random.PRNGKey(4), vcfg,
                                           jnp.float32)
    codes = jax.random.randint(jax.random.PRNGKey(5),
                               (vocoder_frames, vcfg.n_codebooks), 0,
                               vcfg.codebook_size)
    got = np.asarray(vocoder_model.vocoder_decode(
        vp, vcfg, codes, jnp.int32(vocoder_frames)), np.float64)
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        want = np.asarray(vocoder_model.vocoder_decode(
            jax.device_put(vp, cpu), vcfg, jax.device_put(codes, cpu),
            jnp.int32(vocoder_frames)), np.float64)
    rel = float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))
    _log(f"  parity vocoder: {vocoder_frames} frames, relative RMS "
         f"{rel:.3e} (bound {VOCODER_MAX_REL_RMS})")
    assert np.isfinite(got).all() and rel <= VOCODER_MAX_REL_RMS


# ---------------------------------------------------------------------------
# phase 3: the main path through the user entry points
# ---------------------------------------------------------------------------

def _check_result(r, cfg, label):
    spf = cfg.vocoder.samples_per_frame
    assert r.success, f"{label}: {r.error_msg}"
    assert r.n_frames > 0 and len(r.audio) == r.n_frames * spf, (
        f"{label}: {len(r.audio)} samples for {r.n_frames} frames")
    audio = np.asarray(r.audio)
    assert np.isfinite(audio).all(), f"{label}: non-finite audio"
    rms = float(np.sqrt(np.mean(audio.astype(np.float64) ** 2)))
    assert rms > 1e-4, f"{label}: silent audio (rms {rms:.2e})"
    codes = np.asarray(r.codes)
    supp = cfg.talker.codec_vocab_size - cfg.talker.n_suppressed_tail
    assert codes.shape == (r.n_frames, cfg.talker.n_codebooks), codes.shape
    assert ((codes[:, 0] >= 0) & (codes[:, 0] < supp)).all(), f"{label}: cb0"
    assert ((codes[:, 1:] >= 0)
            & (codes[:, 1:] < cfg.code_predictor.vocab_size)).all(), (
        f"{label}: residual codes")
    return rms


def _timed(label, fn, cfg):
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    results = out if isinstance(out, list) else [out]
    frames = 0
    for i, r in enumerate(results):
        _check_result(r, cfg, f"{label}[{i}]")
        frames += r.n_frames
    _log(f"  {label}: {len(results)} request(s), {frames} frames ok — "
         f"informational: wall {wall * 1e3:.1f} ms (compile included on "
         f"first use), {frames / wall:.1f} frames/s")
    return results


def phase_main_path(cfg, *, long_frames=4096, short_frames=200, lanes=16,
                    queue_frames=48, voice_seconds=10.0):
    from qwen3tts_tpu import cli
    from qwen3tts_tpu.config import SamplingConfig
    from qwen3tts_tpu.pipeline import Qwen3TTS

    tts = Qwen3TTS(cfg)
    t0 = time.perf_counter()
    assert tts.load_models(None, synthetic=True, seed=0), tts.error_msg
    _log(f"  load_models(synthetic): {time.perf_counter() - t0:.1f} s")

    text = "The quick brown fox jumps over the lazy dog."
    long_p = SamplingConfig(max_audio_tokens=long_frames, seed=1)
    _timed(f"synthesize max_audio_tokens={long_frames}",
           lambda: tts.synthesize(text, long_p), cfg)
    for seed in (2, 3):
        p = SamplingConfig(max_audio_tokens=short_frames, seed=seed)
        _timed(f"synthesize max_audio_tokens={short_frames} seed={seed}",
               lambda p=p: tts.synthesize(text, p), cfg)

    sr = cfg.speaker_encoder.sample_rate
    wave = (0.1 * np.random.default_rng(0).standard_normal(
        int(voice_seconds * sr))).astype(np.float32)
    p = SamplingConfig(max_audio_tokens=short_frames, seed=4)
    _timed(f"synthesize_with_voice ({voice_seconds:.0f} s reference)",
           lambda: tts.synthesize_with_voice(text, wave, p), cfg)

    texts = [f"Request number {i} of the batch." for i in range(lanes)]
    p = SamplingConfig(max_audio_tokens=queue_frames, seed=5)
    _timed(f"synthesize_batch ({lanes} lanes)",
           lambda: tts.synthesize_batch(texts, p), cfg)

    chunks: dict[int, list] = {}
    first_audio: dict[int, float] = {}
    t_start = [0.0]

    def on_audio(i, audio, finished):
        first_audio.setdefault(i, time.perf_counter() - t_start[0])
        chunks.setdefault(i, []).append(np.asarray(audio))

    def queue():
        t_start[0] = time.perf_counter()
        return tts.synthesize_queue(texts[: lanes // 2], p, lanes=lanes // 4,
                                    on_audio=on_audio)

    results = _timed(f"synthesize_queue ({lanes // 2} requests, "
                     f"{lanes // 4} lanes, streaming)", queue, cfg)
    for i, r in enumerate(results):
        streamed = np.concatenate(chunks[i])[: len(r.audio)]
        assert np.array_equal(streamed, r.audio), f"queue[{i}]: stream != result"
    ttfa = sorted(first_audio.values())
    _log(f"  informational: synthesize_queue time to first audio p50 "
         f"{1e3 * ttfa[len(ttfa) // 2]:.1f} ms (first run, compile included)")

    t0 = time.perf_counter()
    gen = tts.synthesize_streaming(text, SamplingConfig(
        max_audio_tokens=short_frames, seed=6), chunk_frames=8)
    first = next(gen)
    ttfa_ms = (time.perf_counter() - t0) * 1e3
    rest = sum(len(c) for c in gen)
    assert np.isfinite(first).all() and len(first) > 0
    _log(f"  synthesize_streaming: {len(first) + rest} samples — "
         f"informational: time to first audio {ttfa_ms:.1f} ms")

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "cli.wav")
        rc = cli.main(["--synthetic", "-t", text, "-o", out,
                       "--max-tokens", str(short_frames), "--no-timing"])
        assert rc == 0, f"cli.main returned {rc}"
        with open(out, "rb") as f:
            head = f.read(44)
        size = os.path.getsize(out)
        assert head[:4] == b"RIFF" and head[8:12] == b"WAVE", head[:12]
        n_samples = (size - 44) // 2
        spf = cfg.vocoder.samples_per_frame
        assert n_samples > 0 and n_samples % spf == 0, n_samples
        _log(f"  cli.main --synthetic: RIFF WAV, {n_samples // spf} frames")


# ---------------------------------------------------------------------------
# --four: the multi-card paths
# ---------------------------------------------------------------------------

def phase_four(cfg, **kw):
    import jax

    with jax.default_matmul_precision("highest"):
        _phase_four(cfg, **kw)


def _phase_four(cfg, *, n_devices=4, lanes_per_card=2, max_frames=64,
                queue_requests=12):
    """dp=n batched loop (weights replicated, lanes sharded over "dp") and
    the continuous scheduler on a dp=n mesh, each against the same lanes on
    one card. Greedy codes must be equal, so both sides run the same
    arithmetic: float32 weights at "highest" matmul precision (bf16 rounding
    that differs with fusion flips near-tied argmaxes of random weights),
    and a cache below the kernel's capacity (the mesh takes the einsum)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from qwen3tts_tpu.models import code_predictor as cp_model
    from qwen3tts_tpu.models import talker as talker_model
    from qwen3tts_tpu.ops.attention import MIN_KERNEL_CAPACITY
    from qwen3tts_tpu.parallel import mesh as mesh_mod
    from qwen3tts_tpu.runtime import decode_loop
    from qwen3tts_tpu.runtime.continuous import ContinuousScheduler

    devs = jax.devices()
    assert len(devs) >= n_devices, f"need {n_devices} devices, have {len(devs)}"
    tcfg, ccfg = cfg.talker, cfg.code_predictor
    mesh = mesh_mod.make_mesh(n_devices, 1, devices=devs[:n_devices])
    k1, k2 = jax.random.split(jax.random.PRNGKey(9))
    tp = talker_model.init_talker_params(k1, tcfg, jnp.float32)
    cp = cp_model.init_code_predictor_params(k2, ccfg, jnp.float32)
    B = n_devices * lanes_per_card
    C = -(-(10 + max_frames + 8) // 256) * 256
    assert 3 * C < MIN_KERNEL_CAPACITY

    rng = np.random.default_rng(0)
    Tb, vocab = 32, tcfg.tts_pad_token_id - 1
    tokens = np.zeros((B, Tb), np.int32)
    n_tok = rng.integers(12, Tb, B).astype(np.int32)
    for b in range(B):
        tokens[b, : n_tok[b]] = rng.integers(2, vocab, n_tok[b])
    speaker = np.zeros((B, tcfg.hidden_size), np.float32)
    lang = np.full((B,), 2050, np.int32)
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    kw = dict(talker_cfg=tcfg, cp_cfg=ccfg, max_frames=max_frames,
              kv_capacity=C, temperature=0.0, top_k=0,
              repetition_penalty=1.05, allow_eos=False)

    rep = NamedSharding(mesh, P())
    dsh = NamedSharding(mesh, P("dp"))
    t0 = time.perf_counter()
    sharded = decode_loop.generate_from_tokens_batched(
        jax.device_put(tp, rep), jax.device_put(cp, rep),
        *(jax.device_put(jnp.asarray(a), dsh)
          for a in (tokens, n_tok, speaker, lang)),
        jax.device_put(keys, dsh), **kw)
    got = np.asarray(sharded.codes)
    wall = time.perf_counter() - t0
    for g in range(n_devices):
        sl = slice(g * lanes_per_card, (g + 1) * lanes_per_card)
        one = decode_loop.generate_from_tokens_batched(
            tp, cp, jnp.asarray(tokens[sl]), jnp.asarray(n_tok[sl]),
            jnp.asarray(speaker[sl]), jnp.asarray(lang[sl]), keys[sl], **kw)
        np.testing.assert_array_equal(got[sl], np.asarray(one.codes),
                                      err_msg=f"dp lanes {sl} != one card")
    _log(f"  dp={n_devices} batched loop: {B} lanes x {max_frames} frames, "
         f"greedy codes == one card ({lanes_per_card} lanes/card) — "
         f"informational: wall {wall:.2f} s incl. compile")

    reqs = [(rng.integers(2, vocab, int(n)).astype(np.int32), int(n),
             int(rng.integers(max_frames // 4 + 1, max_frames + 1)))
            for n in rng.integers(12, Tb, queue_requests)]

    def serve(sched_mesh, lanes):
        sched = ContinuousScheduler(
            tp if sched_mesh is None else jax.device_put(tp, rep),
            cp if sched_mesh is None else jax.device_put(cp, rep),
            tcfg, ccfg, lanes=lanes, kv_capacity=3 * C, text_bucket=Tb,
            chunk_frames=8, refill_slots=2, max_frames=max_frames,
            temperature=0.0, top_k=0, repetition_penalty=1.05,
            allow_eos=False, mesh=sched_mesh)
        rids = [sched.submit(t, n, np.zeros((tcfg.hidden_size,)), 2050,
                             seed=i, max_frames=b)
                for i, (t, n, b) in enumerate(reqs)]
        out = sched.run()
        return [out[r] for r in rids]

    t0 = time.perf_counter()
    got = serve(mesh, B)
    wall = time.perf_counter() - t0
    want = serve(None, B)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    _log(f"  dp={n_devices} continuous scheduler: {queue_requests} requests "
         f"on {B} lanes, greedy codes == one card with the same lanes — "
         f"informational: wall {wall:.2f} s incl. compile")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths (dp=4)")
    ap.add_argument("--phases", default="kernel,parity,main_path",
                    help="comma-separated subset of the one-card phases")
    args = ap.parse_args(argv)
    if args.four:
        # one GEMM algorithm per shape, no autotuning: the sharded program
        # and the one-card program then round alike, so greedy codes can
        # be compared exactly (and compiles are shorter)
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_autotune_level=0").strip()

    import jax

    from qwen3tts_tpu.config import PipelineConfig
    from qwen3tts_tpu.pipeline import enable_compile_cache
    from qwen3tts_tpu.utils import device

    device.require_gpu("chip_smoke")
    cache = enable_compile_cache()
    _log(f"nvidia-smi: {device.gpu_name_and_power_limit()}")
    dev = device.describe()
    _log(f"jax {jax.__version__}: platform={dev['platform']} "
         f"device_kind={dev['kind']} count={dev['count']}; "
         f"compile cache {cache}")

    cfg = PipelineConfig()
    if args.four:
        phases = [("four", lambda: phase_four(cfg))]
    else:
        table = {"kernel": phase_kernel,
                 "parity": lambda: phase_parity(cfg),
                 "main_path": lambda: phase_main_path(cfg)}
        phases = [(n, table[n]) for n in args.phases.split(",")]

    failed = []
    for name, fn in phases:
        _log(f"[{name}]")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 - report every failing phase
            traceback.print_exc()
            failed.append(name)
            _log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
            continue
        _log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
