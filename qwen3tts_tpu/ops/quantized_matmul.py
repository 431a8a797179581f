"""QuantLinear leaf type + quant-aware matmul (no model imports — this sits
below models/ in the import graph; policy helpers live in ops/quant.py)."""

from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp


class QuantLinear(NamedTuple):
    """int8 weights + per-output-channel scales for an [..., K, N] weight."""

    q: jnp.ndarray       # int8 [..., K, N]
    scale: jnp.ndarray   # [..., 1, N]


class QuantLinear4(NamedTuple):
    """4-bit weights for an [..., K, N] weight, split-half nibble packing
    with per-K-group per-output-channel AFFINE dequantization:

        w[k, n] = q[k, n] * scale[g(k), n] - zero[g(k), n],   q in [0, 15]

    the same affine-per-32-sub-block scheme as ggml Q4_K (which the reference
    ships and runs, convert_tts_to_gguf.py:244-270) but with full-precision
    scales instead of Q4_K's 6-bit quantized scale/min pairs — measured
    strictly more accurate than a Q4_K storage roundtrip on the same weights
    (asymmetric fit beats symmetric int4 by a wide margin on
    gaussian-distributed weights; tests/test_quant.py).

    Byte [i, n] holds row i in its low nibble and row i + K/2 in its high
    nibble. This layout unpacks into two contiguous [K/2, N] halves — no
    interleave — so a matmul is two half-K dots. Group g covers
    LOGICAL rows [g*gs, (g+1)*gs) with gs = K // G (32 at the real shapes);
    groups [0, G/2) cover the low-nibble half, [G/2, G) the high half.

    Q4_K's on-disk super-block layout itself is a storage codec tuned for
    AVX/NEON dot kernels — see io/gguf.py for that codec; GGUF
    Q4_K tensors re-quantize into this runtime format at load.
    """

    q: jnp.ndarray       # int8 [..., K//2, N] (two nibbles per byte, raw u4)
    scale: jnp.ndarray   # [..., G, N] per-group scales in logical-K order
    zero: jnp.ndarray    # [..., G, N] per-group offsets (subtracted)


Weight = Union[jnp.ndarray, QuantLinear, QuantLinear4]


def weight_in_dim(w: Weight) -> int:
    """Logical K (input dim) of a weight leaf — QuantLinear4 stores K//2
    packed rows."""
    if isinstance(w, QuantLinear4):
        return 2 * w.q.shape[-2]
    if isinstance(w, QuantLinear):
        return w.q.shape[-2]
    return w.shape[-2]


def unpack4(q: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Packed [..., K//2, N] int8 -> (lo, hi) raw-u4 halves in [0, 15]."""
    b = q.astype(jnp.int32)
    lo = (b & 15).astype(jnp.int8)
    hi = ((b >> 4) & 15).astype(jnp.int8)
    return lo, hi


def matmul(x: jnp.ndarray, w: Weight) -> jnp.ndarray:
    """x @ w for a plain or quantized weight. The int8->bf16 convert + scale
    are left to XLA to fuse into the matmul as prologue/epilogue."""
    if isinstance(w, QuantLinear):
        y = jnp.dot(x, w.q.astype(x.dtype), preferred_element_type=jnp.float32)
        return (y * w.scale.astype(jnp.float32)).astype(x.dtype)
    if isinstance(w, QuantLinear4):
        lo, hi = unpack4(w.q)
        Kh = lo.shape[-2]
        G = w.scale.shape[-2]
        Gh = G // 2

        def half(xh, wh, sh, zh):
            # grouped dot: P[.., g, n] = x_g @ q_g, then Σ_g (P*s_g - t_g*z_g)
            # with t_g = Σ_k x_g[k] (the affine offset folds into a per-group
            # scalar correction) — the weight bytes stay int (converted in
            # registers), no K×N f32 dequant materialization.
            xg = xh.reshape(xh.shape[:-1] + (Gh, wh.shape[-2] // Gh))
            wg = wh.reshape(wh.shape[:-2] + (Gh, wh.shape[-2] // Gh, wh.shape[-1]))
            p = jnp.einsum("...gk,...gkn->...gn", xg, wg.astype(xh.dtype),
                           preferred_element_type=jnp.float32)
            t = jnp.sum(xg.astype(jnp.float32), axis=-1)           # [..., Gh]
            return (jnp.sum(p * sh.astype(jnp.float32), axis=-2)
                    - jnp.einsum("...g,...gn->...n", t, zh.astype(jnp.float32)))

        y = (half(x[..., :Kh], lo, w.scale[..., :Gh, :], w.zero[..., :Gh, :])
             + half(x[..., Kh:], hi, w.scale[..., Gh:, :], w.zero[..., Gh:, :]))
        return y.astype(x.dtype)
    return x @ w
