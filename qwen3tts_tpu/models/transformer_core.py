"""Qwen3-style decoder blocks, layer-stacked for ``lax.scan``.

One block = RMSNorm -> GQA attention with per-head q/k RMSNorm and NEOX RoPE
-> residual -> RMSNorm -> SwiGLU MLP -> residual. This mirrors the reference
graph builders (src/tts_transformer.cpp:1124-1266 prefill,
:1268-1411 single step) but is built once per shape bucket and scanned over a
stacked parameter pytree instead of being re-built per frame — the reference's
per-step graph rebuild/alloc is the #1 cost its own timing tables expose
(README.md:276-295), and it simply does not exist under jit.

Parameter layout convention: every linear weight is stored **[in, out]** so the
forward pass is ``x @ W`` (HF checkpoints store [out, in]; the loader
transposes once at load time). Stacked block params carry a leading layer axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import attention as attn_ops
from ..ops.quantized_matmul import matmul as _mm, weight_in_dim as _win
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_for_positions


class BlockParams(NamedTuple):
    """Stacked decoder-block parameters; every leaf has leading axis L.

    q/k/v and gate/up projections are FUSED along the output dim: the decode
    loop is dominated by many small GEMVs, and one [H, (Hq+2*Hkv)*D] matmul
    streams weights from device memory far better than three (and removes per-op
    dispatch). The loader concatenates the HF tensors at load time; accessor
    properties recover the individual views for tests/tools.
    """

    attn_norm: jnp.ndarray   # [L, H]
    wqkv: jnp.ndarray        # [L, H, (Hq + 2*Hkv) * D]
    wo: jnp.ndarray          # [L, Hq*D, H]
    q_norm: jnp.ndarray      # [L, D]
    k_norm: jnp.ndarray      # [L, D]
    ffn_norm: jnp.ndarray    # [L, H]
    w_gateup: jnp.ndarray    # [L, H, 2*F]
    w_down: jnp.ndarray      # [L, F, H]


class CoreConfig(NamedTuple):
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rms_norm_eps: float
    rope_theta: float
    # lax.scan unroll factor over layers: small stacks (the 5-layer code
    # predictor runs 15x per frame) benefit from full unrolling — fewer
    # loop-iteration boundaries for XLA to schedule across.
    unroll: int = 1


def init_block_params(key: jax.Array, cfg: CoreConfig, hidden: int, ffn: int, dtype) -> BlockParams:
    """Deterministic synthetic init (scaled normal) at the configured shapes."""
    L, Hq, Hkv, D = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ks = jax.random.split(key, 7)

    def w(k, shape, fan_in):
        return (jax.random.normal(k, shape, jnp.float32) / jnp.sqrt(fan_in)).astype(dtype)

    return BlockParams(
        attn_norm=jnp.ones((L, hidden), dtype),
        wqkv=w(ks[0], (L, hidden, (Hq + 2 * Hkv) * D), hidden),
        wo=w(ks[3], (L, Hq * D, hidden), Hq * D),
        q_norm=jnp.ones((L, D), dtype),
        k_norm=jnp.ones((L, D), dtype),
        ffn_norm=jnp.ones((L, hidden), dtype),
        w_gateup=w(ks[4], (L, hidden, 2 * ffn), hidden),
        w_down=w(ks[6], (L, ffn, hidden), ffn),
    )


def _layer(params, cfg: CoreConfig, x, cos, sin, attend):
    """One block on x [T, H]; `attend(q, k, v) -> o` supplies the attention
    (and threads the KV cache via closure when decoding)."""
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T = x.shape[0]

    h = rms_norm(x, params.attn_norm, cfg.rms_norm_eps)
    qkv = _mm(h, params.wqkv)
    q = qkv[:, : Hq * D].reshape(T, Hq, D)
    k = qkv[:, Hq * D: (Hq + Hkv) * D].reshape(T, Hkv, D)
    v = qkv[:, (Hq + Hkv) * D:].reshape(T, Hkv, D)
    q = rms_norm(q, params.q_norm, cfg.rms_norm_eps)
    k = rms_norm(k, params.k_norm, cfg.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    o, kv_out = attend(q, k, v)
    x = x + _mm(o.reshape(T, Hq * D), params.wo)

    h = rms_norm(x, params.ffn_norm, cfg.rms_norm_eps)
    F = _win(params.w_down)
    gateup = _mm(h, params.w_gateup)
    gate = jax.nn.silu(gateup[:, :F].astype(jnp.float32)).astype(h.dtype)
    x = x + _mm(gate * gateup[:, F:], params.w_down)
    return x, kv_out


# Cache-update strategy threshold: the xs/ys ("sliced") scheme copies each
# layer's cache slice per step (~0.13 GB/frame at C=512, ~1 GB/frame at
# C=4352 in bf16), so large capacities take the carry-threaded scheme with
# in-place updates and layer-indexed decode attention. Chosen statically per
# compiled bucket.
CARRY_THRESHOLD = 1024


def forward_prefill(
    blocks: BlockParams,
    cfg: CoreConfig,
    x: jnp.ndarray,          # [P, H]
    positions: jnp.ndarray,  # [P] int32
    valid_len,               # scalar: tokens >= valid_len are padding
    kv: jnp.ndarray,         # [L, 2, Hkv, C, D] preallocated head-major cache
    n_past: int | jnp.ndarray = 0,
):
    """Run the full stack over a (padded) prefill window, writing K/V into the
    cache at [n_past, n_past+P). Returns (hidden [P, H] pre-output-norm, kv)."""
    cos, sin = rope_for_positions(positions, cfg.head_dim, cfg.rope_theta)
    if kv.shape[3] >= CARRY_THRESHOLD:
        return _forward_prefill_carried(blocks, cfg, x, cos, sin, valid_len, kv, n_past)
    return _forward_prefill_sliced(blocks, cfg, x, cos, sin, valid_len, kv, n_past)


def _forward_prefill_sliced(blocks, cfg, x, cos, sin, valid_len, kv, n_past):
    def scan_fn(carry, layer_in):
        x = carry
        params_l, kv_l = layer_in

        def attend(q, k, v):
            k_cache = lax.dynamic_update_slice(
                kv_l[0], k.transpose(1, 0, 2).astype(kv_l.dtype), (0, n_past, 0))
            v_cache = lax.dynamic_update_slice(
                kv_l[1], v.transpose(1, 0, 2).astype(kv_l.dtype), (0, n_past, 0))
            # Prefill always starts from an empty cache in this pipeline
            # (the reference clears it first), so causal attention over the
            # window itself is sufficient.
            o = attn_ops.prefill_attention(q, k, v, valid_len=valid_len)
            return o, jnp.stack([k_cache, v_cache])

        x, kv_l_new = _layer(params_l, cfg, x, cos, sin, attend)
        return x, kv_l_new

    x, kv_new = lax.scan(scan_fn, x, (blocks, kv), unroll=cfg.unroll)
    return x, kv_new


def _forward_prefill_carried(blocks, cfg, x, cos, sin, valid_len, kv, n_past):
    L = kv.shape[0]

    def scan_fn(carry, layer_in):
        x, kv = carry
        params_l, li = layer_in

        def attend(q, k, v):
            upd = jnp.stack([k.transpose(1, 0, 2), v.transpose(1, 0, 2)])
            kv_new = lax.dynamic_update_slice(
                kv, upd[None].astype(kv.dtype), (li, 0, 0, n_past, 0))
            o = attn_ops.prefill_attention(q, k, v, valid_len=valid_len)
            return o, kv_new

        x, kv = _layer(params_l, cfg, x, cos, sin, attend)
        return (x, kv), None

    (x, kv), _ = lax.scan(scan_fn, (x, kv),
                          (blocks, jnp.arange(L, dtype=jnp.int32)),
                          unroll=cfg.unroll)
    return x, kv


def forward_step(
    blocks: BlockParams,
    cfg: CoreConfig,
    x: jnp.ndarray,          # [H] single-token input
    n_past: jnp.ndarray,     # scalar int: cache fill level == position
    kv: jnp.ndarray,         # [L, 2, Hkv, C, D] head-major
    strategy: str = "auto",
    start: jnp.ndarray | None = None,
):
    """Single-token decode step; K/V written at position n_past; attention over
    cache[0:n_past+1]. Returns (hidden [H] pre-output-norm, kv).

    strategy: "auto" picks sliced below CARRY_THRESHOLD slots and carried
    (in-place updates + layer-indexed attention) above; "carried"/"sliced"
    force it. Under vmap the sliced scheme's per-layer cache copies multiply
    by the batch, so batched callers pass "carried".

    `start` (scalar, optional): additionally mask cache positions < start —
    continuous-batching lanes splice a new request's prefill mid-cache and
    everything below the splice point belongs to the previous occupant
    (runtime/continuous.py). RoPE uses absolute cache positions, so a spliced
    request reproduces a fresh run exactly (rotary shift invariance)."""
    pos = jnp.asarray(n_past, jnp.int32)[None]
    cos, sin = rope_for_positions(pos, cfg.head_dim, cfg.rope_theta)
    if strategy == "carried" or (strategy == "auto"
                                 and kv.shape[3] >= CARRY_THRESHOLD):
        return _forward_step_carried(blocks, cfg, x, cos, sin, n_past, kv, start)
    return _forward_step_sliced(blocks, cfg, x, cos, sin, n_past, kv, start)


def _forward_step_sliced(blocks, cfg, x, cos, sin, n_past, kv, start=None):
    def scan_fn(carry, layer_in):
        x = carry
        params_l, kv_l = layer_in

        def attend(q, k, v):
            k_cache = lax.dynamic_update_slice(
                kv_l[0], k.transpose(1, 0, 2).astype(kv_l.dtype), (0, n_past, 0))
            v_cache = lax.dynamic_update_slice(
                kv_l[1], v.transpose(1, 0, 2).astype(kv_l.dtype), (0, n_past, 0))
            o = attn_ops.decode_attention_auto(
                q[0], k_cache, v_cache, n_past + 1, start)
            return o[None], jnp.stack([k_cache, v_cache])

        x2, kv_l_new = _layer(params_l, cfg, x[None], cos, sin, attend)
        return x2[0], kv_l_new

    x, kv_new = lax.scan(scan_fn, x, (blocks, kv), unroll=cfg.unroll)
    return x, kv_new


def _forward_step_carried(blocks, cfg, x, cos, sin, n_past, kv, start=None):
    L = kv.shape[0]

    def scan_fn(carry, layer_in):
        x, kv = carry
        params_l, li = layer_in

        def attend(q, k, v):
            upd = jnp.stack([k.transpose(1, 0, 2), v.transpose(1, 0, 2)])
            kv_new = lax.dynamic_update_slice(
                kv, upd[None].astype(kv.dtype), (li, 0, 0, n_past, 0))
            o = attn_ops.decode_attention_layered(
                q[0], kv_new, li, n_past + 1, start)
            return o[None], kv_new

        x2, kv = _layer(params_l, cfg, x[None], cos, sin, attend)
        return (x2[0], kv), None

    (x, kv), _ = lax.scan(scan_fn, (x, kv),
                          (blocks, jnp.arange(L, dtype=jnp.int32)),
                          unroll=cfg.unroll)
    return x, kv
