"""Split-K decode attention (one query token against a KV cache), written in
Pallas for the Triton route.

The XLA path (``ops/attention.decode_attention``) reads the whole
preallocated cache every step: at a 4096-frame budget that is
28 layers x 2 x 8 heads x 4352 rows x 128 x 2 B ~= 499 MB per talker step in
bf16, whether 64 or 4000 rows are valid. This kernel reads only the rows in
[start, n_valid) (flash-decoding):

- grid (KV head, split): split j owns cache rows [j*S, (j+1)*S); its program
  loops over the ``block_k``-row blocks of that range that overlap
  [start, n_valid) and skips the rest, so traffic follows the valid prefix;
- each program keeps an online softmax (running max m, denominator l and the
  unnormalised output o) in registers and writes (o, m, l) for its split;
- a small ``jnp`` combine merges the splits.

The query group (G = Hq/Hkv query heads per KV head) is zero-padded to 16
rows, the smallest M a tensor-core dot takes; the padded rows are sliced away.

The cache keeps its head-major layouts: ``[Hkv, C, D]`` per layer, or the
layer-stacked ``[L, 2, Hkv, C, D]`` read in place at a traced layer index
(a custom call cannot fuse a dynamic slice, so slicing ``kv[layer]`` first
would copy the layer every step). The cache refs are passed unblocked and the
kernel computes its own row offsets.

Semantics match ``decode_attention``: GQA, scale 1/sqrt(D), softmax in f32
over cache rows [start, n_valid).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG_INF = -1e30
GROUP_PAD = 16       # tensor-core dots need M >= 16
BLOCK_K = 64         # cache rows per inner-loop step
MAX_SPLITS = 32      # splits per KV head (grid = Hkv x splits programs)


def num_splits(capacity: int, block_k: int = BLOCK_K,
               max_splits: int = MAX_SPLITS) -> int:
    """Largest split count <= max_splits that divides the capacity's blocks
    (each split then covers a whole number of blocks)."""
    n_blocks = capacity // block_k
    return max(s for s in range(1, min(max_splits, n_blocks) + 1)
               if n_blocks % s == 0)


def _kernel(nv_ref, st_ref, ly_ref, q_ref, k_ref, v_ref, o_ref, m_ref, l_ref,
            *, block_k: int, split: int, k_kind: int, v_kind: int):
    h = pl.program_id(0)
    j = pl.program_id(1)
    n_valid = nv_ref[()]
    start = st_ref[()]
    layer = ly_ref[()]
    lo = jnp.maximum(j * split, start)
    hi = jnp.minimum((j + 1) * split, n_valid)
    b_lo = lo // block_k
    b_hi = jnp.where(hi > lo, (hi + block_k - 1) // block_k, b_lo)

    q = q_ref[...]                                         # [GP, D]
    gp, d = q.shape
    scale = 1.0 / (d ** 0.5)
    precision = (lax.Precision.HIGHEST if q.dtype == jnp.float32 else None)
    rows = jnp.arange(block_k)

    def body(b, carry):
        o, m, l = carry
        off = pl.multiple_of(b * block_k, block_k)
        k = k_ref[layer, k_kind, h, pl.ds(off, block_k), :]   # [BK, D]
        v = v_ref[layer, v_kind, h, pl.ds(off, block_k), :]
        s = pl.dot(q, k.astype(q.dtype), trans_b=True,
                   precision=precision) * scale                # [GP, BK] f32
        idx = off + rows
        valid = (idx >= start) & (idx < n_valid)
        s = jnp.where(valid[None, :], s, NEG_INF)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        p = jnp.exp(s - m_new[:, None])
        alpha = jnp.exp(m - m_new)
        l_new = alpha * l + jnp.sum(p, axis=1)
        o_new = alpha[:, None] * o + pl.dot(
            p.astype(v.dtype), v, precision=precision)
        return o_new, m_new, l_new

    init = (jnp.zeros((gp, d), jnp.float32),
            jnp.full((gp,), NEG_INF, jnp.float32),
            jnp.zeros((gp,), jnp.float32))
    o, m, l = lax.fori_loop(b_lo, b_hi, body, init)
    o_ref[...] = o
    m_ref[...] = m
    l_ref[...] = l


def _decode(q, k5, v5, k_kind, v_kind, layer, n_valid, start, *,
            block_k, splits, interpret):
    """q [Hq, D]; k5/v5 [L, 2|1, Hkv, C, D] read at (layer, kind)."""
    Hq, D = q.shape
    Hkv, C = k5.shape[2], k5.shape[3]
    G = Hq // Hkv
    assert G <= GROUP_PAD and Hq % Hkv == 0, (Hq, Hkv)
    assert C % block_k == 0, f"capacity {C} must be a multiple of {block_k}"
    splits = splits or num_splits(C, block_k)
    assert (C // block_k) % splits == 0, (C, block_k, splits)
    split = C // splits

    qg = jnp.zeros((Hkv, GROUP_PAD, D), q.dtype).at[:, :G].set(
        q.reshape(Hkv, G, D))
    scalar = pl.BlockSpec((), lambda h, j: ())
    whole = pl.BlockSpec(k5.shape, lambda h, j: (0,) * 5)
    o, m, l = pl.pallas_call(
        functools.partial(_kernel, block_k=block_k, split=split,
                          k_kind=k_kind, v_kind=v_kind),
        grid=(Hkv, splits),
        in_specs=[scalar, scalar, scalar,
                  pl.BlockSpec((None, GROUP_PAD, D), lambda h, j: (h, 0, 0)),
                  whole, whole],
        out_specs=[
            pl.BlockSpec((None, None, GROUP_PAD, D), lambda h, j: (h, j, 0, 0)),
            pl.BlockSpec((None, None, GROUP_PAD), lambda h, j: (h, j, 0)),
            pl.BlockSpec((None, None, GROUP_PAD), lambda h, j: (h, j, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((Hkv, splits, GROUP_PAD, D), jnp.float32),
            jax.ShapeDtypeStruct((Hkv, splits, GROUP_PAD), jnp.float32),
            jax.ShapeDtypeStruct((Hkv, splits, GROUP_PAD), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="decode_attention",
    )(jnp.asarray(n_valid, jnp.int32), jnp.asarray(start, jnp.int32),
      jnp.asarray(layer, jnp.int32), qg, k5, v5)

    # merge the splits; empty splits carry m = NEG_INF, l = 0, o = 0
    m_all = jnp.max(m, axis=1, keepdims=True)               # [Hkv, 1, GP]
    corr = jnp.exp(m - m_all)
    l_all = jnp.sum(l * corr, axis=1)                        # [Hkv, GP]
    o_all = jnp.sum(o * corr[..., None], axis=1)             # [Hkv, GP, D]
    out = o_all / jnp.maximum(l_all, 1e-30)[..., None]
    return out[:, :G].reshape(Hq, D).astype(q.dtype)


@functools.partial(jax.jit,
                   static_argnames=("block_k", "splits", "interpret"))
def decode_attention_pallas(
    q: jnp.ndarray,        # [Hq, D]
    k_cache: jnp.ndarray,  # [Hkv, C, D] head-major
    v_cache: jnp.ndarray,  # [Hkv, C, D]
    n_valid: jnp.ndarray,  # scalar int32
    start: jnp.ndarray | int = 0,   # scalar: rows < start are stale
    *,
    block_k: int = BLOCK_K,
    splits: int | None = None,
    interpret: bool = False,
) -> jnp.ndarray:
    return _decode(q, k_cache[None, None], v_cache[None, None], 0, 0, 0,
                   n_valid, start, block_k=block_k, splits=splits,
                   interpret=interpret)


@functools.partial(jax.jit,
                   static_argnames=("block_k", "splits", "interpret"))
def decode_attention_pallas_layered(
    q: jnp.ndarray,        # [Hq, D]
    kv: jnp.ndarray,       # [L, 2, Hkv, C, D] layer-stacked cache
    layer: jnp.ndarray,    # scalar int32
    n_valid: jnp.ndarray,  # scalar int32
    start: jnp.ndarray | int = 0,
    *,
    block_k: int = BLOCK_K,
    splits: int | None = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """Reads K/V of `layer` straight out of the stacked cache (no copy)."""
    return _decode(q, kv, kv, 0, 1, layer, n_valid, start, block_k=block_k,
                   splits=splits, interpret=interpret)
