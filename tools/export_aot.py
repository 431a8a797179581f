#!/usr/bin/env python
"""AOT-export the compiled stage programs with jax.export.

The analog of the reference's CoreML exporter (component #12,
SURVEY.md §2 — scripts/convert_code_predictor_to_coreml.py): where the
reference re-builds the code predictor for Apple's ANE, the deployment
artifact is the serialized StableHLO of each jitted stage program, loadable
in a serving process without retracing Python.

    python tools/export_aot.py --out exported/ [--frames 256] [--text-bucket 64]
    python tools/export_aot.py --check exported/   # reload + run sanity check
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import export as jax_export  # noqa: E402


def _register_param_types() -> None:
    """jax.export requires NamedTuple pytree nodes to be registered for
    serialization; register every parameter container once."""
    from qwen3tts_tpu.models.code_predictor import CodePredictorParams
    from qwen3tts_tpu.models.talker import PrefillInputs, TalkerParams
    from qwen3tts_tpu.models.transformer_core import BlockParams
    from qwen3tts_tpu.models.vocoder import (
        ConvNeXtParams, DecoderBlockParams, PreTfmBlockParams, ResBlockParams,
        VocoderParams)
    from qwen3tts_tpu.ops.quantized_matmul import QuantLinear
    from qwen3tts_tpu.runtime.decode_loop import GenerateResult

    for t in (BlockParams, TalkerParams, CodePredictorParams, PrefillInputs,
              VocoderParams, PreTfmBlockParams, ConvNeXtParams,
              DecoderBlockParams, ResBlockParams, QuantLinear, GenerateResult):
        try:
            jax_export.register_namedtuple_serialization(
                t, serialized_name=f"qwen3tts_tpu.{t.__name__}")
        except ValueError:
            pass  # already registered


def build_programs(frames: int, text_bucket: int, tiny: bool):
    from qwen3tts_tpu.config import PipelineConfig, tiny_pipeline_config
    from qwen3tts_tpu.models import code_predictor as cp_model
    from qwen3tts_tpu.models import talker as talker_model
    from qwen3tts_tpu.models import vocoder as vocoder_model
    from qwen3tts_tpu.runtime import decode_loop

    cfg = tiny_pipeline_config() if tiny else PipelineConfig()
    tcfg, ccfg, vcfg = cfg.talker, cfg.code_predictor, cfg.vocoder
    dtype = jnp.float32 if tiny else jnp.bfloat16

    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    tp = talker_model.init_talker_params(k1, tcfg, dtype)
    cp = cp_model.init_code_predictor_params(k2, ccfg, dtype)
    vp = vocoder_model.init_vocoder_params(k3, vcfg, jnp.float32)

    kv_capacity = -(-(10 + frames + 8) // 256) * 256

    def generate_fn(tp, cp, tokens, n_tokens, speaker, lang, prng):
        return decode_loop.generate_from_tokens(
            tp, cp, tokens, n_tokens, speaker, lang, prng,
            talker_cfg=tcfg, cp_cfg=ccfg,
            max_frames=frames, kv_capacity=kv_capacity,
            temperature=0.9, top_k=50, repetition_penalty=1.05)

    def vocoder_fn(vp, codes, n):
        return vocoder_model.vocoder_decode(vp, vcfg, codes, n)

    gen_args = (
        tp, cp,
        jnp.zeros((text_bucket,), jnp.int32), jnp.int32(10),
        jnp.zeros((tcfg.hidden_size,), jnp.float32), jnp.int32(2050),
        jax.random.PRNGKey(0),
    )
    voc_args = (vp, jnp.zeros((frames, vcfg.n_codebooks), jnp.int32), jnp.int32(frames))
    return {
        "generate": (jax.jit(generate_fn, static_argnames=()), gen_args),
        "vocoder": (jax.jit(vocoder_fn), voc_args),
    }


def do_export(out_dir: str, frames: int, text_bucket: int, tiny: bool) -> None:
    _register_param_types()
    os.makedirs(out_dir, exist_ok=True)
    for name, (fn, args) in build_programs(frames, text_bucket, tiny).items():
        exported = jax_export.export(fn)(*args)
        blob = exported.serialize()
        path = os.path.join(out_dir, f"{name}.jaxexport")
        with open(path, "wb") as f:
            f.write(blob)
        print(f"exported {name}: {len(blob) / 1e6:.1f} MB -> {path}")


def do_check(out_dir: str, frames: int, text_bucket: int, tiny: bool) -> None:
    _register_param_types()
    programs = build_programs(frames, text_bucket, tiny)
    for name, (_fn, args) in programs.items():
        path = os.path.join(out_dir, f"{name}.jaxexport")
        with open(path, "rb") as f:
            exported = jax_export.deserialize(f.read())
        out = exported.call(*args)
        leaves = jax.tree.leaves(out)
        print(f"{name}: reloaded + executed, {len(leaves)} outputs, "
              f"first shape {np.asarray(leaves[0]).shape}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="exported")
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--text-bucket", type=int, default=64)
    ap.add_argument("--tiny", action="store_true", help="tiny config (self-test)")
    ap.add_argument("--check", action="store_true", help="reload + run instead of export")
    args = ap.parse_args()
    if args.check:
        do_check(args.out, args.frames, args.text_bucket, args.tiny)
    else:
        do_export(args.out, args.frames, args.text_bucket, args.tiny)
    return 0


if __name__ == "__main__":
    sys.exit(main())
