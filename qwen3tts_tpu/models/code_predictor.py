"""The code predictor: 5-layer AR transformer emitting codebooks 1..15.

Covers reference component #5's code-predictor half plus component #6 (the
CoreML/ANE bridge): here both collapse into one fused on-device routine —
a 2-token prefill followed by a ``lax.scan`` over 14 single-token steps with
the per-step embedding tables and LM heads stacked along a step axis and
gathered by step index (SURVEY.md §7 "the hard parts" #4).

Reference semantics (src/tts_transformer.cpp:1534-1829, 2310-2575):
- prefill input = [talker_last_hidden, talker_codec_embd[cb0]] at pos 0,1
- logits for codebook 1 come from lm_head[0] applied to the *last* prefill
  position after the final RMSNorm
- step s in 1..14: input = code_pred_embd[s-1][prev_code] at pos s+1, logits
  from lm_head[s]
- NEOX RoPE theta 1e6, q/k-norm, GQA 16/8 — identical block structure to the
  talker; temperature/top-k sampling shared with the talker's sampler but
  without repetition penalty or suppression (:2349-2387).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import CodePredictorConfig
from ..ops.norms import rms_norm
from ..ops.sampling import sample_token
from .transformer_core import BlockParams, CoreConfig, forward_prefill, forward_step, init_block_params


class CodePredictorParams(NamedTuple):
    blocks: BlockParams        # stacked x 5
    output_norm: jnp.ndarray   # [H]
    embds: jnp.ndarray         # [15, Vcp, H] code_pred_embd.{0..14}
    heads: jnp.ndarray         # [15, H, Vcp] lm_head.{0..14}


def core_config(cfg: CodePredictorConfig) -> CoreConfig:
    return CoreConfig(
        n_layers=cfg.n_layers,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        rms_norm_eps=cfg.rms_norm_eps,
        rope_theta=cfg.rope_theta,
        unroll=cfg.n_layers,  # 5 layers x 15 passes/frame: unroll fully
    )


def init_code_predictor_params(key: jax.Array, cfg: CodePredictorConfig, dtype=jnp.bfloat16) -> CodePredictorParams:
    ks = jax.random.split(key, 3)
    n = cfg.n_steps

    def w(k, shape, fan_in):
        return (jax.random.normal(k, shape, jnp.float32) / jnp.sqrt(fan_in)).astype(dtype)

    return CodePredictorParams(
        blocks=init_block_params(ks[0], core_config(cfg), cfg.hidden_size, cfg.intermediate_size, dtype),
        output_norm=jnp.ones((cfg.hidden_size,), dtype),
        embds=w(ks[1], (n, cfg.vocab_size, cfg.hidden_size), cfg.hidden_size),
        heads=w(ks[2], (n, cfg.hidden_size, cfg.vocab_size), cfg.hidden_size),
    )


def predict_codes(
    params: CodePredictorParams,
    cfg: CodePredictorConfig,
    talker_hidden: jnp.ndarray,   # [H] output-normed last talker hidden
    cb0_embd: jnp.ndarray,        # [H] talker codec_embd[cb0]
    key: jax.Array,
    *,
    temperature: float,
    top_k: int,
    top_p: float = 1.0,
    greedy=None,
    use_top_p=None,
) -> jnp.ndarray:
    """AR-generate the 15 residual codes for one frame. Returns int32 [15].

    temperature/top_p may be traced scalars; greedy/use_top_p are static
    stage gates (ops/sampling.sampling_flags)."""
    ccfg = core_config(cfg)
    kv = jnp.zeros((cfg.n_layers, 2, cfg.n_kv_heads, cfg.max_ctx, cfg.head_dim), params.embds.dtype)

    # --- 2-token prefill at positions 0,1 ---
    x = jnp.stack([talker_hidden, cb0_embd]).astype(params.embds.dtype)
    hidden, kv = forward_prefill(params.blocks, ccfg, x, jnp.arange(2, dtype=jnp.int32), None, kv, 0)
    h_last = rms_norm(hidden[-1], params.output_norm, cfg.rms_norm_eps)
    logits0 = (h_last @ params.heads[0]).astype(jnp.float32)
    key, k0 = jax.random.split(key)
    code0 = sample_token(k0, logits0, temperature=temperature, top_k=top_k, top_p=top_p, greedy=greedy, use_top_p=use_top_p)

    # --- 14 single-token steps; per-step embed table s-1 and head s ---
    def step(carry, s):
        prev_code, kv, key = carry
        emb = params.embds[s - 1, prev_code]
        hidden, kv = forward_step(params.blocks, ccfg, emb, s + 1, kv)
        h = rms_norm(hidden, params.output_norm, cfg.rms_norm_eps)
        logits = (h @ params.heads[s]).astype(jnp.float32)
        key, ks = jax.random.split(key)
        code = sample_token(ks, logits, temperature=temperature, top_k=top_k, top_p=top_p, greedy=greedy, use_top_p=use_top_p)
        return (code, kv, key), code

    (_, _, _), rest = lax.scan(step, (code0, kv, key), jnp.arange(1, cfg.n_steps, dtype=jnp.int32))
    return jnp.concatenate([code0[None], rest])
