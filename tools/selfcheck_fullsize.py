#!/usr/bin/env python
"""Full-scale loader self-check: write a fake HF checkpoint at the REAL 0.6B
shapes, load it through the complete pipeline (config inference, tokenizer,
all four loaders), and synthesize a few frames.

Catches full-size-only problems (layout mistakes, memory blowups, shape
mismatches vs docs/model_inspection.txt) before real weights are available.
Not part of the default pytest run (writes ~2.5 GB and takes minutes).

    python tools/selfcheck_fullsize.py [--dir /tmp/fullsize] [--keep]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", default="/tmp/qwen3tts_fullsize")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--frames", type=int, default=2)
    args = ap.parse_args()

    from qwen3tts_tpu.config import PipelineConfig, RuntimeConfig, SamplingConfig
    from qwen3tts_tpu.io.safetensors_io import write_safetensors
    from qwen3tts_tpu.pipeline import Qwen3TTS
    from qwen3tts_tpu.text.bpe import bytes_to_unicode
    import hf_fixture

    cfg = PipelineConfig()
    tts_dir = os.path.join(args.dir, "Qwen3-TTS-12Hz-0.6B-Base")
    tok_dir = os.path.join(args.dir, "Qwen3-TTS-Tokenizer-12Hz")
    os.makedirs(tts_dir, exist_ok=True)
    os.makedirs(tok_dir, exist_ok=True)

    t0 = time.time()
    print("writing full-size fake checkpoints (fp16)...")
    tts_tensors = {k: v.astype(np.float16)
                   for k, v in hf_fixture.make_tts_checkpoint(cfg).items()}
    n_params = sum(int(np.prod(v.shape)) for v in tts_tensors.values())
    write_safetensors(os.path.join(tts_dir, "model.safetensors"), tts_tensors)
    del tts_tensors
    tok_tensors = {k: v.astype(np.float16)
                   for k, v in hf_fixture.make_tokenizer_checkpoint(cfg).items()}
    n_params += sum(int(np.prod(v.shape)) for v in tok_tensors.values())
    write_safetensors(os.path.join(tok_dir, "model.safetensors"), tok_tensors)
    del tok_tensors
    print(f"  {n_params:,} parameters written in {time.time() - t0:.0f}s")

    # minimal real-slot vocab
    uni = bytes_to_unicode()
    vocab = {uni[b]: b + 1000 for b in range(256)}
    vocab.update({"<|im_start|>": 151644, "<|im_end|>": 151645,
                  "assistant": 77091, uni[ord("\n")]: 198})
    with open(os.path.join(tts_dir, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(tts_dir, "merges.txt"), "w") as f:
        f.write("")

    t0 = time.time()
    tts = Qwen3TTS(PipelineConfig(runtime=RuntimeConfig(
        dtype="bfloat16", frame_buckets=(8,), vocoder_buckets=(8,),
        speaker_buckets=(24000,))))
    ok = tts.load_models(args.dir)
    assert ok, tts.error_msg
    print(f"loaded full-size checkpoint in {time.time() - t0:.0f}s")

    # shape audit vs synthetic init
    import jax
    import jax.numpy as jnp
    from qwen3tts_tpu.models import talker as talker_model
    ref = talker_model.init_talker_params(jax.random.PRNGKey(0), cfg.talker, jnp.bfloat16)
    for got, want in zip(jax.tree.leaves(tts.talker_params), jax.tree.leaves(ref)):
        assert got.shape == want.shape, f"shape audit failed: {got.shape} vs {want.shape}"
    print("talker shape audit vs configured shapes: OK")

    t0 = time.time()
    r = tts.synthesize("hello world", SamplingConfig(
        temperature=0.0, top_k=0, max_audio_tokens=args.frames))
    assert r.success, r.error_msg
    assert len(r.audio) == r.n_frames * 1920
    print(f"synthesized {r.n_frames} frames ({len(r.audio)} samples) "
          f"in {time.time() - t0:.0f}s")

    # voice cloning path at full size
    t0 = time.time()
    ref_audio = (np.random.default_rng(0).normal(size=24000) * 0.1).astype(np.float32)
    r2 = tts.synthesize_with_voice("hello", ref_audio, SamplingConfig(
        temperature=0.0, top_k=0, max_audio_tokens=args.frames))
    assert r2.success, r2.error_msg
    print(f"voice-clone path OK in {time.time() - t0:.0f}s")

    if not args.keep:
        shutil.rmtree(args.dir)
    print("fullsize selfcheck PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
