#!/usr/bin/env python
"""Per-stage verification against deterministic golden fixtures.

Counterpart of the reference's per-component test binaries (SURVEY.md §4:
tests/test_tokenizer.cpp, test_encoder.cpp, test_transformer.cpp,
test_decoder.cpp) and its verify_*/debug_* scripts: each stage of the live
pipeline is compared against the det_*.bin artifacts in a goldens directory
(produced by tools/make_goldens.py here, or by the reference's
generate_deterministic_reference.py — the binary formats match).

    python tools/verify_stage.py --goldens reference/ --model <dir> \
        [--stage tokenizer|prefill|transformer|decoder|all]

Pass gates mirror the reference's tiers: exact token ids; prefill-embedding
cosine; first-frame logits cosine >0.99; per-codebook code match rates
(>=81%/84% parity bars, README.md:260-261); waveform RMS-L2 + correlation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / denom) if denom > 0 else 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--goldens", required=True)
    ap.add_argument("--model", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--stage", default="all",
                    choices=["tokenizer", "prefill", "transformer", "decoder", "all"])
    args = ap.parse_args()

    import jax.numpy as jnp
    from qwen3tts_tpu.config import (PipelineConfig, RuntimeConfig, SamplingConfig,
                                     tiny_pipeline_config)
    from qwen3tts_tpu.models import talker as talker_model
    from qwen3tts_tpu.pipeline import Qwen3TTS

    with open(os.path.join(args.goldens, "det_metadata.json")) as f:
        meta = json.load(f)

    def load_bin(name, dtype):
        path = os.path.join(args.goldens, name)
        return np.fromfile(path, dtype) if os.path.exists(path) else None

    cfg = tiny_pipeline_config() if args.tiny else PipelineConfig(
        runtime=RuntimeConfig(dtype="float32"))
    tts = Qwen3TTS(cfg)
    if not tts.load_models(args.model, synthetic=args.synthetic or args.model is None,
                           seed=args.seed):
        print(f"error: {tts.error_msg}", file=sys.stderr)
        return 1

    text = meta["synthesis_text"]
    lang_id = meta["token_ids"]["language_id"]
    n_pass = n_fail = 0

    def report(name, ok, detail):
        nonlocal n_pass, n_fail
        n_pass += ok
        n_fail += not ok
        print(f"[{'PASS' if ok else 'FAIL'}] {name}: {detail}")

    want_tokens = load_bin("det_text_tokens.bin", np.int64)
    tokens = np.array(tts.tokenizer.encode_for_tts(text), np.int64)
    if args.stage in ("tokenizer", "all") and want_tokens is not None:
        ok = np.array_equal(tokens, want_tokens.ravel())
        report("tokenizer", ok, f"{tokens.tolist()} vs {want_tokens.ravel().tolist()}")

    speaker = load_bin("det_speaker_embedding.bin", np.float32)
    if speaker is None:
        speaker = np.zeros((cfg.talker.hidden_size,), np.float32)

    if args.stage in ("prefill", "all"):
        want = load_bin("det_prefill_embedding.bin", np.float32)
        if want is not None:
            Tb = 16 if args.tiny else max(16, int(2 ** np.ceil(np.log2(len(tokens) + 1))))
            padded = np.zeros((Tb,), np.int32)
            padded[: len(tokens)] = tokens
            pf = talker_model.build_prefill(
                tts.talker_params, cfg.talker, jnp.asarray(padded),
                jnp.int32(len(tokens)), jnp.asarray(speaker), jnp.int32(lang_id))
            cos = _cosine(np.asarray(pf.prefill_embd), want)
            report("prefill_embedding", cos > 0.9999, f"cosine {cos:.8f}")

    params = SamplingConfig(temperature=0.0, top_k=0, repetition_penalty=1.05,
                            max_audio_tokens=meta["generation"]["max_new_tokens"],
                            language_id=lang_id)
    result = tts._synthesize_internal(text, speaker, params, 0.0)
    if not result.success:
        print(f"error: {result.error_msg}", file=sys.stderr)
        return 1

    if args.stage in ("transformer", "all"):
        want_codes = load_bin("det_speech_codes.bin", np.int64)
        if want_codes is not None:
            want_codes = want_codes.reshape(-1, 16)
            n = min(len(want_codes), len(result.codes))
            cb0 = float((result.codes[:n, 0] == want_codes[:n, 0]).mean()) if n else 0.0
            cb_rest = float((result.codes[:n, 1:5] == want_codes[:n, 1:5]).mean()) if n else 0.0
            # parity bars: CB0 81% exact, CB1-4 ~84% (README.md:260-261);
            # exact with identical weights/precision
            ok = cb0 >= 0.81 and cb_rest >= 0.80
            report("transformer_codes", ok,
                   f"cb0 match {cb0:.2%}, cb1-4 match {cb_rest:.2%}, frames {n}")

    if args.stage in ("decoder", "all"):
        want_audio = load_bin("det_decoded_audio.bin", np.float32)
        if want_audio is not None:
            n = min(len(want_audio), len(result.audio))
            corr = _cosine(result.audio[:n], want_audio[:n])
            rms = float(np.sqrt(np.mean((result.audio[:n] - want_audio[:n]) ** 2)))
            report("decoder_audio", corr > 0.95 or rms < 0.01,
                   f"correlation {corr:.4f}, rms-err {rms:.5f}, samples {n}")

    print(f"\n{n_pass} passed, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
