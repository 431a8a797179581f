#!/usr/bin/env python
"""One-shot model setup: download HF checkpoints (+ optional GGUF conversion,
goldens, warmup AOT compile).

Counterpart of the reference's scripts/setup_pipeline_models.py (component
#13, SURVEY.md §2): repo fallback list, --force/--skip-download, and instead
of a CoreML export step (Apple-only), an optional AOT export of the compiled
programs (tools/export_aot.py).

    python tools/setup_models.py --dest models/ [--gguf f16 q8_0] [--goldens]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Download candidates, tried in order (reference setup_pipeline_models.py:35-41).
TTS_REPOS = [
    "Qwen/Qwen3-TTS-12Hz-0.6B-Base",
    "Qwen/Qwen3-TTS-12Hz-0.6B",
]
TOKENIZER_REPOS = [
    "Qwen/Qwen3-TTS-Tokenizer-12Hz",
]


def download(repo_candidates, dest: str, force: bool) -> str | None:
    """Snapshot-download the first available repo; returns the local dir."""
    for repo in repo_candidates:
        local = os.path.join(dest, repo.split("/")[-1])
        if os.path.isdir(local) and not force and any(
                f.endswith(".safetensors") for f in os.listdir(local)):
            print(f"  {repo}: already present at {local}")
            return local
        try:
            from huggingface_hub import snapshot_download
        except ImportError:
            print("  huggingface_hub not installed; place checkpoints manually under "
                  f"{local}", file=sys.stderr)
            return local if os.path.isdir(local) else None
        try:
            snapshot_download(repo_id=repo, local_dir=local)
            return local
        except Exception as e:  # noqa: BLE001
            print(f"  {repo}: download failed ({e}); trying next candidate", file=sys.stderr)
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dest", default="models")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--skip-download", action="store_true")
    ap.add_argument("--gguf", nargs="*", choices=["f16", "f32", "q8_0"], default=None,
                    help="also convert to GGUF at these precisions")
    ap.add_argument("--goldens", action="store_true",
                    help="generate deterministic reference fixtures")
    ap.add_argument("--warmup", action="store_true",
                    help="pre-compile the serving buckets once")
    args = ap.parse_args()

    os.makedirs(args.dest, exist_ok=True)
    tts_dir = tok_dir = None
    if args.skip_download:
        for name in sorted(os.listdir(args.dest)):
            sub = os.path.join(args.dest, name)
            if not os.path.isdir(sub):
                continue
            if "tokenizer" in name.lower():
                tok_dir = sub
            else:
                tts_dir = sub
    else:
        print("Downloading TTS checkpoint...")
        tts_dir = download(TTS_REPOS, args.dest, args.force)
        print("Downloading codec tokenizer checkpoint...")
        tok_dir = download(TOKENIZER_REPOS, args.dest, args.force)

    if not tts_dir or not tok_dir:
        print("error: checkpoints unavailable", file=sys.stderr)
        return 1

    if args.gguf:
        script = os.path.join(os.path.dirname(__file__), "convert_hf_to_gguf.py")
        for prec in args.gguf:
            for kind, src in (("tts", tts_dir), ("tokenizer", tok_dir)):
                base = "qwen3-tts-0.6b" if kind == "tts" else "qwen3-tts-tokenizer"
                out = os.path.join(args.dest, f"{base}-{prec}.gguf")
                print(f"Converting {kind} -> {out}")
                subprocess.run([sys.executable, script, "--input", src,
                                "--output", out, "--type", prec, "--kind", kind],
                               check=True)

    if args.goldens:
        script = os.path.join(os.path.dirname(__file__), "make_goldens.py")
        subprocess.run([sys.executable, script, "--model", args.dest,
                        "--out", os.path.join(args.dest, "reference")], check=True)

    if args.warmup:
        from qwen3tts_tpu.pipeline import Qwen3TTS
        tts = Qwen3TTS.from_pretrained(args.dest)
        tts.warmup()
        print("warmup complete (serving buckets compiled)")

    print("Model setup complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
