#!/usr/bin/env python
"""Generate deterministic golden fixtures (det_*.bin style) from a checkpoint.

Counterpart of the reference's scripts/generate_deterministic_reference.py:
runs the full pipeline in float32 with greedy decoding on "Hello." and dumps
the intermediate artifacts with shapes + sha256 into det_metadata.json, so
per-stage golden tests (tests/test_goldens.py) can compare against them.

Works with real HF/GGUF checkpoints when given --model, or with deterministic
synthetic weights (--synthetic) to self-test the harness.

    python tools/make_goldens.py --model <dir> --out reference/ \
        [--text "Hello."] [--reference-audio clone.wav]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _dump(out_dir: str, meta: dict, name: str, array: np.ndarray, dtype):
    array = np.ascontiguousarray(array.astype(dtype))
    path = os.path.join(out_dir, name)
    array.tofile(path)
    meta["outputs"][name] = {
        "path": name,
        "shape": list(array.shape),
        "dtype": str(array.dtype),
        "size_bytes": array.nbytes,
        "sha256": hashlib.sha256(array.tobytes()).hexdigest(),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true", help="tiny config (harness self-test)")
    ap.add_argument("--text", default="Hello.")
    ap.add_argument("--language", default="en")
    ap.add_argument("--reference-audio", default=None)
    ap.add_argument("--max-frames", type=int, default=64)
    ap.add_argument("--out", default="reference")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from qwen3tts_tpu.config import (PipelineConfig, RuntimeConfig, SamplingConfig,
                                     tiny_pipeline_config)
    from qwen3tts_tpu.models import talker as talker_model
    from qwen3tts_tpu.pipeline import LANGUAGE_IDS, Qwen3TTS, save_wav
    from qwen3tts_tpu.audio.wav import load_wav

    if args.tiny:
        cfg = tiny_pipeline_config()
    else:
        cfg = PipelineConfig(runtime=RuntimeConfig(dtype="float32"))
    tts = Qwen3TTS(cfg)
    if not tts.load_models(args.model, synthetic=args.synthetic or args.model is None,
                           seed=args.seed):
        print(f"error: {tts.error_msg}", file=sys.stderr)
        return 1

    os.makedirs(args.out, exist_ok=True)
    lang_id = LANGUAGE_IDS[args.language.lower()]
    meta = {
        "synthesis_text": args.text,
        "language": args.language,
        "dtype": cfg.runtime.dtype,
        "synthetic_seed": args.seed if (args.synthetic or args.model is None) else None,
        "generation": {"max_new_tokens": args.max_frames, "do_sample": False},
        "token_ids": {
            "tts_bos_token_id": cfg.talker.tts_bos_token_id,
            "tts_eos_token_id": cfg.talker.tts_eos_token_id,
            "tts_pad_token_id": cfg.talker.tts_pad_token_id,
            "codec_bos_id": cfg.talker.codec_bos_id,
            "codec_eos_token_id": cfg.talker.codec_eos_id,
            "codec_pad_id": cfg.talker.codec_pad_id,
            "language_id": lang_id,
        },
        "outputs": {},
    }

    # speaker embedding
    if args.reference_audio:
        samples, sr = load_wav(args.reference_audio)
        if sr != cfg.speaker_encoder.sample_rate:
            from qwen3tts_tpu.audio.wav import resample_linear
            samples = resample_linear(samples, sr, cfg.speaker_encoder.sample_rate)
        speaker = tts.extract_speaker_embedding(samples)
    else:
        speaker = np.zeros((cfg.talker.hidden_size,), np.float32)
    _dump(args.out, meta, "det_speaker_embedding.bin", speaker, np.float32)

    # text tokens
    tokens = np.array(tts.tokenizer.encode_for_tts(args.text), np.int64)
    _dump(args.out, meta, "det_text_tokens.bin", tokens[None, :], np.int64)

    # prefill embedding + trailing schedule
    Tb = 16 if args.tiny else max(16, int(2 ** np.ceil(np.log2(len(tokens) + 1))))
    padded = np.zeros((Tb,), np.int32)
    padded[: len(tokens)] = tokens
    prefill = talker_model.build_prefill(
        tts.talker_params, cfg.talker, jnp.asarray(padded), jnp.int32(len(tokens)),
        jnp.asarray(speaker, jnp.float32), jnp.int32(lang_id))
    _dump(args.out, meta, "det_prefill_embedding.bin",
          np.asarray(prefill.prefill_embd, np.float32)[None], np.float32)
    n_trail = int(prefill.trailing_len)
    _dump(args.out, meta, "det_trailing_text.bin",
          np.asarray(prefill.trailing[:n_trail], np.float32)[None], np.float32)
    _dump(args.out, meta, "det_tts_pad_embed.bin",
          np.asarray(prefill.tts_pad_embd, np.float32)[None, None], np.float32)

    # greedy synthesis
    params = SamplingConfig(temperature=0.0, top_k=0, repetition_penalty=1.05,
                            max_audio_tokens=args.max_frames, language_id=lang_id)
    result = tts._synthesize_internal(args.text, speaker, params, 0.0)
    if not result.success:
        print(f"error: {result.error_msg}", file=sys.stderr)
        return 1
    _dump(args.out, meta, "det_speech_codes.bin", result.codes.astype(np.int64), np.int64)
    if result.hidden_states is not None:
        _dump(args.out, meta, "det_hidden_states.bin", result.hidden_states, np.float32)
    _dump(args.out, meta, "det_decoded_audio.bin", result.audio, np.float32)
    wav_path = os.path.join(args.out, "det_output.wav")
    save_wav(wav_path, result.audio, result.sample_rate)
    meta["wav"] = {
        "path": "det_output.wav",
        "sample_rate": result.sample_rate,
        "num_samples": int(len(result.audio)),
        "duration_seconds": result.audio_seconds,
    }

    with open(os.path.join(args.out, "det_metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
    print(f"wrote {len(meta['outputs'])} fixtures + det_metadata.json to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
