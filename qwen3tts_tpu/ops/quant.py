"""Weight-only int8 quantization for the decode hot path.

The frame loop reads every weight each step (talker ~0.9 GB/frame + 15
sequential code-predictor passes ~2.3 GB/frame in bf16); int8 halves that.
Storage parity with the reference's Q8_0 GGUF files lives in io/gguf.py
(per-32-block scales); the runtime compute path uses per-output-channel
scales so the dequant is a fused matmul epilogue (ops/quantized_matmul.py).

Selective policy matches the reference converter
(convert_tts_to_gguf.py:244-270): block projection matrices quantize;
embeddings, norms, heads and biases stay high precision.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..models.transformer_core import BlockParams
from .quantized_matmul import (  # noqa: F401 (re-export)
    QuantLinear, QuantLinear4, Weight, matmul, unpack4)


def quantize_per_channel(w: jnp.ndarray, scale_dtype=jnp.float32) -> QuantLinear:
    """Symmetric per-output-channel (last axis) int8 quantization."""
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=-2, keepdims=True)
    scale = jnp.where(amax > 0, amax / 127.0, 1.0)
    q = jnp.clip(jnp.round(wf / scale), -127, 127).astype(jnp.int8)
    return QuantLinear(q=q, scale=scale.astype(scale_dtype))


def dequantize(w: QuantLinear, dtype=jnp.float32) -> jnp.ndarray:
    return (w.q.astype(jnp.float32) * w.scale.astype(jnp.float32)).astype(dtype)


def quantize_block_params(blocks: BlockParams) -> BlockParams:
    """Quantize the projection matrices of a (stacked) block pytree; norms
    stay as-is. The result remains a BlockParams and scans identically."""
    return blocks._replace(
        wqkv=quantize_per_channel(blocks.wqkv),
        wo=quantize_per_channel(blocks.wo),
        w_gateup=quantize_per_channel(blocks.w_gateup),
        w_down=quantize_per_channel(blocks.w_down),
    )


# Per-K-group scale width (ggml Q4_K uses 32-element sub-blocks; group-wise
# scales are what lift prefill-logits cosine from 0.81 to >0.99 vs the old
# 2-group split-half format). Shrunk via gcd at tiny/test shapes.
W4_GROUP = 32


def _w4_group_size(K: int, group_size: int = W4_GROUP) -> int:
    import math

    return math.gcd(K // 2, group_size)


def quantize_w4(w: jnp.ndarray, scale_dtype=jnp.float32,
                group_size: int = W4_GROUP) -> QuantLinear4:
    """Affine u4 ([0, 15]) with per-K-group per-output-channel (scale, zero):
    w ~= q*scale - zero, packed two-nibbles-per-byte in the split-half layout
    (see QuantLinear4). The asymmetric min/max fit matches ggml Q4_K's scheme
    and measures far better than symmetric int4 on gaussian weights."""
    wf = w.astype(jnp.float32)
    K, N = wf.shape[-2], wf.shape[-1]
    gs = _w4_group_size(K, group_size)
    G = K // gs
    grouped = wf.reshape(wf.shape[:-2] + (G, gs, N))
    wmin = jnp.minimum(jnp.min(grouped, axis=-2), 0.0)     # [..., G, N] <= 0
    wmax = jnp.maximum(jnp.max(grouped, axis=-2), 0.0)
    rng = wmax - wmin
    scale = jnp.where(rng > 0, rng / 15.0, 1.0)
    zero = -wmin                                           # >= 0
    q = jnp.clip(jnp.round((grouped + zero[..., :, None, :])
                           / scale[..., :, None, :]), 0, 15)
    q = q.reshape(wf.shape)                                # [..., K, N]
    lo, hi = q[..., :K // 2, :], q[..., K // 2:, :]
    packed = (lo.astype(jnp.int32)
              | (hi.astype(jnp.int32) << 4)).astype(jnp.uint8)
    return QuantLinear4(q=packed.view(jnp.int8),
                        scale=scale.astype(scale_dtype),
                        zero=zero.astype(scale_dtype))


def dequantize4(w: QuantLinear4, dtype=jnp.float32) -> jnp.ndarray:
    lo, hi = unpack4(w.q)
    q = jnp.concatenate([lo, hi], axis=-2).astype(jnp.float32)   # [..., K, N]
    K, N = q.shape[-2], q.shape[-1]
    G = w.scale.shape[-2]
    gs = K // G
    grouped = q.reshape(q.shape[:-2] + (G, gs, N))
    deq = (grouped * w.scale[..., :, None, :].astype(jnp.float32)
           - w.zero[..., :, None, :].astype(jnp.float32))
    return deq.reshape(q.shape).astype(dtype)


def quantize_block_params_w4(blocks: BlockParams) -> BlockParams:
    """4-bit variant of quantize_block_params (the talker's pure-w4 tier).
    Same selective policy: projections only."""
    return blocks._replace(
        wqkv=quantize_w4(blocks.wqkv),
        wo=quantize_w4(blocks.wo),
        w_gateup=quantize_w4(blocks.w_gateup),
        w_down=quantize_w4(blocks.w_down),
    )


def quantize_block_params_mixed(blocks: BlockParams) -> BlockParams:
    """Mixed-precision 4-bit tier — the DEFAULT behind quant="q4": attention
    projections (wqkv, wo) at int8, FFN projections (w_gateup, w_down — ~60%
    of projection bytes) at affine u4.

    Measured prefill-logits cosine vs bf16 on identical synthetic weights:
    0.9748, vs 0.9205 for the pure-w4 pytree and 0.9238 for the reference's
    own Q4_K storage format (convert_tts_to_gguf.py:244-270 keeps only
    embeddings/norms/biases/heads at F16 — its attention projections are all
    4-bit). The attention path's q/k/v numerics compound through RoPE +
    softmax across every cached position, so it is far more
    quantization-sensitive than the per-token FFN; spending the int8 bytes
    there buys most of the quality back for ~30% more weight traffic than
    pure w4 (11.2 vs 7.9 MB/layer at real shapes; int8 is 15.7)."""
    return blocks._replace(
        wqkv=quantize_per_channel(blocks.wqkv),
        wo=quantize_per_channel(blocks.wo),
        w_gateup=quantize_w4(blocks.w_gateup),
        w_down=quantize_w4(blocks.w_down),
    )


def quantize_talker_blocks(blocks: BlockParams, tier: str) -> BlockParams:
    """The one place the serving-tier names resolve to block policies:
    "int8" -> all-int8; "q4" -> MIXED attn-int8/ffn-u4 (the 4-bit default —
    see quantize_block_params_mixed); "q4pure" -> all-u4 (smallest, lossier).
    The code predictor stays int8 in every tier (4-bit costs it accuracy)."""
    if tier == "int8":
        return quantize_block_params(blocks)
    if tier == "q4":
        return quantize_block_params_mixed(blocks)
    if tier == "q4pure":
        return quantize_block_params_w4(blocks)
    raise ValueError(f"unknown quant tier: {tier!r}")
