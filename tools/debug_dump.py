#!/usr/bin/env python
"""Dump per-stage intermediate tensors for debugging numerics.

Counterpart of the reference's scripts/debug_decoder.py /
debug_speaker_encoder.py (component #17, SURVEY.md §2): writes .npy files for
every major intermediate so two implementations (or two precisions) can be
diffed stage by stage.

    python tools/debug_dump.py --out /tmp/dump [--model <dir>|--synthetic] \
        [--text "Hello."] [--reference-audio ref.wav] [--tiny]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--text", default="Hello.")
    ap.add_argument("--language", default="en")
    ap.add_argument("--reference-audio", default=None)
    ap.add_argument("--max-frames", type=int, default=16)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from qwen3tts_tpu.audio import mel as mel_mod
    from qwen3tts_tpu.config import (PipelineConfig, RuntimeConfig, SamplingConfig,
                                     tiny_pipeline_config)
    from qwen3tts_tpu.models import talker as talker_model
    from qwen3tts_tpu.models import vocoder as vocoder_model
    from qwen3tts_tpu.pipeline import LANGUAGE_IDS, Qwen3TTS
    from qwen3tts_tpu.audio.wav import load_wav, resample_linear

    os.makedirs(args.out, exist_ok=True)
    cfg = tiny_pipeline_config() if args.tiny else PipelineConfig(
        runtime=RuntimeConfig(dtype="float32"))
    tts = Qwen3TTS(cfg)
    assert tts.load_models(args.model, synthetic=args.synthetic or args.model is None,
                           seed=args.seed), tts.error_msg

    def dump(name, arr):
        arr = np.asarray(arr)
        np.save(os.path.join(args.out, name + ".npy"), arr)
        print(f"  {name:<28} {str(arr.shape):<18} {arr.dtype}")

    lang_id = LANGUAGE_IDS[args.language.lower()]

    # 1. tokenizer
    tokens = np.array(tts.tokenizer.encode_for_tts(args.text), np.int32)
    dump("text_tokens", tokens)

    # 2. speaker path
    if args.reference_audio:
        samples, sr = load_wav(args.reference_audio)
        if sr != tts.config.speaker_encoder.sample_rate:
            samples = resample_linear(samples, sr, tts.config.speaker_encoder.sample_rate)
        if tts.speaker_params is None:
            tts._load_speaker_encoder()
        secfg = tts.config.speaker_encoder
        from qwen3tts_tpu.runtime.buckets import pick_bucket
        Sb = pick_bucket(len(samples), tts.config.runtime.speaker_buckets)
        buf = np.zeros((Sb,), np.float32)
        buf[: min(len(samples), Sb)] = samples[:Sb]
        mel, nf = mel_mod.log_mel(jnp.asarray(buf), jnp.int32(min(len(samples), Sb)),
                                  secfg, tts._mel_fb, tts._mel_win)
        dump("mel", np.asarray(mel)[: int(nf)])
        speaker = tts.extract_speaker_embedding(samples)
    else:
        speaker = np.zeros((tts.config.talker.hidden_size,), np.float32)
    dump("speaker_embedding", speaker)

    # 3. prefill conditioning
    Tb = 16 if args.tiny else max(16, int(2 ** np.ceil(np.log2(len(tokens) + 1))))
    padded = np.zeros((Tb,), np.int32)
    padded[: len(tokens)] = tokens
    pf = talker_model.build_prefill(
        tts.talker_params, tts.config.talker, jnp.asarray(padded),
        jnp.int32(len(tokens)), jnp.asarray(speaker), jnp.int32(lang_id))
    dump("prefill_embedding", pf.prefill_embd)
    dump("trailing_text_hidden", pf.trailing[: int(pf.trailing_len)])
    dump("tts_pad_embed", pf.tts_pad_embd)

    # 4. prefill forward: first-frame logits + hidden
    kv = talker_model.make_kv_cache(tts.config.talker, 256, jnp.float32
                                    if cfg.runtime.dtype == "float32" else jnp.bfloat16)
    hidden, logits, _ = talker_model.talker_prefill(
        tts.talker_params, tts.config.talker, pf.prefill_embd, kv)
    dump("first_frame_logits", logits)
    dump("prefill_last_hidden", hidden)

    # 5. generation + per-frame hidden
    params = SamplingConfig(temperature=0.0, top_k=0, language_id=lang_id,
                            max_audio_tokens=args.max_frames)
    r = tts._synthesize_internal(args.text, speaker, params, 0.0)
    assert r.success, r.error_msg
    dump("speech_codes", r.codes)

    # 6. vocoder intermediates: VQ latent + final audio
    vcfg = tts.config.vocoder
    vp = tts.vocoder_params
    codes_j = jnp.asarray(r.codes)
    first = vp.vq_first_cb[codes_j[:, 0]]
    rest = vp.vq_rest_cb[jnp.arange(vcfg.n_codebooks - 1), codes_j[:, 1:]]
    latent = first @ vp.vq_first_proj + jnp.sum(rest, axis=1) @ vp.vq_rest_proj
    dump("vq_latent", latent)
    dump("decoded_audio", r.audio)
    print(f"dumped to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
