#!/usr/bin/env python
"""Convert HF Qwen3-TTS checkpoints to GGUF (f16/f32/q8_0/q4_k).

Counterpart of the reference's scripts/convert_tts_to_gguf.py and
scripts/convert_tokenizer_to_gguf.py, built on this framework's own GGUF
writer (no gguf-py dependency). The JAX pipeline loads HF safetensors
directly; this tool exists for interchange with GGUF-based runtimes and for
producing the Q8_0-parity artifacts.

    python tools/convert_hf_to_gguf.py --input <hf_model_dir> \
        --output model.gguf --type f16 [--kind tts|tokenizer]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from qwen3tts_tpu.io import tensor_names  # noqa: E402
from qwen3tts_tpu.io.gguf import (  # noqa: E402
    GGML_F16, GGML_F32, GGML_Q4_K, GGML_Q8_0, GGUFWriter, T_F32, T_STR, T_U32,
)
from qwen3tts_tpu.io.safetensors_io import SafetensorsDir  # noqa: E402


def convert(input_dir: str, output: str, out_type: str, kind: str) -> None:
    sub = os.path.join(input_dir, "speech_tokenizer")
    st_dir = sub if (kind == "tokenizer" and os.path.isdir(sub)) else input_dir
    st = SafetensorsDir(st_dir)

    arch = "qwen3-tts" if kind == "tts" else "qwen3-tts-tokenizer"
    w = GGUFWriter(arch)
    w.add_meta("general.name", T_STR, "Qwen3-TTS-12Hz-0.6B" if kind == "tts" else "Qwen3-TTS-Tokenizer-12Hz")
    if kind == "tts":
        # full metadata key set the reference's parse_config reads
        # (tts_transformer.cpp:212-344 / convert_tts_to_gguf.py:440-471)
        from qwen3tts_tpu.io.config_io import config_from_model_dir
        cfg = config_from_model_dir(os.path.dirname(os.path.abspath(input_dir)))
        t, cpred, spk = cfg.talker, cfg.code_predictor, cfg.speaker_encoder
        cj = os.path.join(input_dir, "config.json")
        if os.path.exists(cj):
            import json as _json
            from qwen3tts_tpu.io.config_io import talker_config_from_json, speaker_config_from_json
            with open(cj) as f:
                data = _json.load(f)
            t, cpred = talker_config_from_json(data)
            spk = speaker_config_from_json(data)
        w.add_meta(f"{arch}.block_count", T_U32, t.n_layers)
        w.add_meta(f"{arch}.embedding_length", T_U32, t.hidden_size)
        w.add_meta(f"{arch}.feed_forward_length", T_U32, t.intermediate_size)
        w.add_meta(f"{arch}.attention.head_count", T_U32, t.n_heads)
        w.add_meta(f"{arch}.attention.head_count_kv", T_U32, t.n_kv_heads)
        w.add_meta(f"{arch}.attention.key_length", T_U32, t.head_dim)
        w.add_meta(f"{arch}.attention.value_length", T_U32, t.head_dim)
        w.add_meta(f"{arch}.attention.layer_norm_rms_epsilon", T_F32, t.rms_norm_eps)
        w.add_meta(f"{arch}.rope.freq_base", T_F32, t.rope_theta)
        w.add_meta(f"{arch}.rope.mrope_section", (9, T_U32), list(t.mrope_section))
        w.add_meta(f"{arch}.vocab_size", T_U32, t.codec_vocab_size)
        w.add_meta(f"{arch}.text_vocab_size", T_U32, t.text_vocab_size)
        w.add_meta(f"{arch}.text_hidden_size", T_U32, t.text_embd_dim)
        w.add_meta(f"{arch}.num_code_groups", T_U32, t.n_codebooks)
        w.add_meta(f"{arch}.code_predictor.layer_count", T_U32, cpred.n_layers)
        w.add_meta(f"{arch}.code_predictor.vocab_size", T_U32, cpred.vocab_size)
        w.add_meta(f"{arch}.speaker_encoder.embedding_length", T_U32, spk.embedding_dim)
        w.add_meta(f"{arch}.speaker_encoder.sample_rate", T_U32, spk.sample_rate)
        w.add_meta(f"{arch}.codec.pad_id", T_U32, t.codec_pad_id)
        w.add_meta(f"{arch}.codec.bos_id", T_U32, t.codec_bos_id)
        w.add_meta(f"{arch}.codec.eos_id", T_U32, t.codec_eos_id)
    else:
        w.add_meta(f"{arch}.num_codebooks", T_U32, 16)
        w.add_meta(f"{arch}.codebook_size", T_U32, 2048)
        w.add_meta(f"{arch}.sample_rate", T_U32, 24000)

    # embed the BPE tokenizer when present (parity with the reference
    # converter, convert_tts_to_gguf.py:475-524)
    vocab_path = os.path.join(input_dir, "vocab.json")
    merges_path = os.path.join(input_dir, "merges.txt")
    if kind == "tts" and os.path.exists(vocab_path):
        import json
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        tokens = [t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])]
        w.add_meta("tokenizer.ggml.model", T_STR, "gpt2")
        w.add_meta("tokenizer.ggml.tokens", (9, T_STR), tokens)
        if os.path.exists(merges_path):
            with open(merges_path, encoding="utf-8") as f:
                merges = [ln.strip() for ln in f
                          if ln.strip() and not ln.startswith("#")]
            w.add_meta("tokenizer.ggml.merges", (9, T_STR), merges)

    # collect usage tensors to fold into codebooks (converter behavior:
    # codebook = embedding_sum / clamp(usage, 1e-5); usage not written)
    usages = {}
    for name in st.keys():
        if name.endswith("cluster_usage"):
            usages[name.replace("cluster_usage", "embedding_sum")] = st.tensor(name)

    n_conv = n_skip = 0
    for name in sorted(st.keys()):
        if name.endswith("cluster_usage"):
            continue
        ggml = tensor_names.hf_to_ggml(name)
        if ggml is None:
            n_skip += 1
            continue
        data = np.asarray(st.tensor(name), np.float32)
        if name in usages:
            usage = np.clip(np.asarray(usages[name], np.float64), 1e-5, None)
            data = (data.astype(np.float64) / usage[:, None]).astype(np.float32)
        if data.ndim <= 1:
            ttype = GGML_F32
        elif out_type == "f32":
            ttype = GGML_F32
        elif out_type == "q8_0" and tensor_names.should_quantize_q8(ggml) and data.shape[-1] % 32 == 0:
            ttype = GGML_Q8_0
        elif out_type == "q4_k" and tensor_names.should_quantize_q8(ggml) and data.shape[-1] % 256 == 0:
            # same selective policy as the reference converter: block
            # projections quantize, embeddings/norms/heads/biases stay F16
            ttype = GGML_Q4_K
        elif out_type == "q4_k_mixed" and tensor_names.should_quantize_q8(ggml):
            # storage analog of the runtime MIXED tier (ops/quant.
            # quantize_block_params_mixed): FFN projections Q4_K, attention
            # projections (and other quantizables) Q8_0 — measurably better
            # quality than all-Q4_K for ~30% more projection bytes
            if tensor_names.is_ffn_projection(ggml) and data.shape[-1] % 256 == 0:
                ttype = GGML_Q4_K
            elif data.shape[-1] % 32 == 0:
                ttype = GGML_Q8_0
            else:
                ttype = GGML_F16
        else:
            ttype = GGML_F16
        w.add_tensor(ggml, data, ttype=ttype)
        n_conv += 1

    w.write(output)
    print(f"wrote {output}: {n_conv} tensors converted, {n_skip} skipped")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", "-i", required=True)
    ap.add_argument("--output", "-o", required=True)
    ap.add_argument("--type", "-t",
                    choices=["f16", "f32", "q8_0", "q4_k", "q4_k_mixed"],
                    default="f16")
    ap.add_argument("--kind", choices=["tts", "tokenizer"], default="tts")
    args = ap.parse_args()
    convert(args.input, args.output, args.type, args.kind)
    return 0


if __name__ == "__main__":
    sys.exit(main())
