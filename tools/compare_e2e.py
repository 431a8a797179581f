#!/usr/bin/env python
"""End-to-end comparison against golden fixtures with the reference's
acceptance gates (scripts/compare_e2e.py:33-38, 255-270):

  - both waveforms RMS > 0.001
  - duration ratio within (0.5, 1.5)
  - > 1000 samples
  - waveform correlation reported (informational: AR divergence under reduced
    precision is expected, README.md:257-262)

    python tools/compare_e2e.py --goldens reference/ [--model <dir>|--synthetic]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

GATES = {"min_rms": 0.001, "dur_ratio": (0.5, 1.5), "min_samples": 1000}


def compare_waveforms(a: np.ndarray, b: np.ndarray, min_samples: int | None = None) -> dict:
    n = min(len(a), len(b))
    a_, b_ = a[:n].astype(np.float64), b[:n].astype(np.float64)
    rms_a = float(np.sqrt(np.mean(a_ ** 2))) if n else 0.0
    rms_b = float(np.sqrt(np.mean(b_ ** 2))) if n else 0.0
    corr = 0.0
    if n > 1 and rms_a > 0 and rms_b > 0:
        corr = float(np.corrcoef(a_, b_)[0, 1])
    ratio = len(a) / max(len(b), 1)
    min_n = GATES["min_samples"] if min_samples is None else min_samples
    return {
        "rms_a": rms_a,
        "rms_b": rms_b,
        "duration_ratio": ratio,
        "correlation": corr,
        "n_samples": n,
        "pass": (rms_a > GATES["min_rms"] and rms_b > GATES["min_rms"]
                 and GATES["dur_ratio"][0] < ratio < GATES["dur_ratio"][1]
                 and n > min_n),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--goldens", required=True)
    ap.add_argument("--model", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()

    with open(os.path.join(args.goldens, "det_metadata.json")) as f:
        meta = json.load(f)

    from qwen3tts_tpu.config import (PipelineConfig, RuntimeConfig, SamplingConfig,
                                     tiny_pipeline_config)
    from qwen3tts_tpu.pipeline import LANGUAGE_IDS, Qwen3TTS

    cfg = tiny_pipeline_config() if args.tiny else PipelineConfig(
        runtime=RuntimeConfig(dtype="float32"))
    tts = Qwen3TTS(cfg)
    if not tts.load_models(args.model, synthetic=args.synthetic or args.model is None,
                           seed=args.seed):
        print(f"error: {tts.error_msg}", file=sys.stderr)
        return 1

    golden_audio = np.fromfile(
        os.path.join(args.goldens, "det_decoded_audio.bin"), np.float32)
    golden_codes = np.fromfile(
        os.path.join(args.goldens, "det_speech_codes.bin"), np.int64).reshape(-1, 16)

    params = SamplingConfig(
        temperature=0.0, top_k=0, repetition_penalty=1.05,
        max_audio_tokens=meta["generation"]["max_new_tokens"],
        language_id=meta["token_ids"]["language_id"])
    result = tts.synthesize(meta["synthesis_text"], params)
    if not result.success:
        print(f"error: {result.error_msg}", file=sys.stderr)
        return 1

    n = min(len(golden_codes), len(result.codes))
    cb0_match = float((result.codes[:n, 0] == golden_codes[:n, 0]).mean()) if n else 0.0
    frame_match = float((result.codes[:n] == golden_codes[:n]).all(axis=1).mean()) if n else 0.0
    report = compare_waveforms(result.audio, golden_audio,
                               min_samples=0 if args.tiny else None)
    report["cb0_exact_match"] = cb0_match
    report["frame_exact_match"] = frame_match
    print(json.dumps(report, indent=2))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
