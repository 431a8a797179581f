"""GQA attention: prefill, and single-token decode over a KV cache.

Semantics match the reference graphs:

- scale 1/sqrt(head_dim), causal mask, softmax in f32
  (src/tts_transformer.cpp:1219-1226)
- GQA with n_heads query heads sharing n_kv_heads KV heads (16/8 for the
  talker and code predictor; the vocoder pre-transformer is MHA 16/16).

Decode attention has two implementations: the plain XLA einsum
(``decode_attention``, the reference for every test) and the split-K Pallas
kernel of ``ops/pallas_attention.py``. The choice depends on the platform and
the cache shape alone: ``kernel_fits`` checks the shape at trace time, and
``lax.platform_dependent`` lowers the kernel only for CUDA (every other
platform lowers the einsum).
"""

from __future__ import annotations

import contextlib
import contextvars

import jax
import jax.numpy as jnp
from jax import lax

NEG_INF = -1e30  # plain float: no device allocation at import time

# The smallest capacity the kernel was measured at, where it already beat
# the einsum (H100, 400 W: 0.39-0.44 against 0.46 ms for 28 layers single
# stream, 0.63-1.32 against 3.54 ms at 16 lanes; PERF.md). Smaller caches
# take the einsum until measured.
MIN_KERNEL_CAPACITY = 1024

# False while tracing a program whose operands span several devices:
# pallas_call has no partitioning rule, so the einsum (which GSPMD
# partitions) must run there. Set only through `kernel_allowed`.
_KERNEL_ALLOWED = contextvars.ContextVar("decode_attention_kernel",
                                         default=True)


@contextlib.contextmanager
def kernel_allowed(allowed: bool):
    """Trace the enclosed code with the decode-attention kernel allowed or
    not. Entry points that take multi-device operands set it from a static
    argument, so the choice is part of the compiled program's key."""
    token = _KERNEL_ALLOWED.set(bool(allowed))
    try:
        yield
    finally:
        _KERNEL_ALLOWED.reset(token)


def kernel_fits(capacity: int, head_dim: int, n_heads: int,
                n_kv_heads: int, dtype) -> bool:
    """Whether a CUDA lowering may take the split-K kernel: caches of at
    least MIN_KERNEL_CAPACITY rows whose shapes it tiles, outside
    multi-device programs. Everything else takes the einsum."""
    from .pallas_attention import BLOCK_K, GROUP_PAD

    return (_KERNEL_ALLOWED.get()
            and capacity >= MIN_KERNEL_CAPACITY
            and capacity % BLOCK_K == 0
            and head_dim >= 16 and head_dim & (head_dim - 1) == 0
            and n_heads % n_kv_heads == 0
            and n_heads // n_kv_heads <= GROUP_PAD
            and not _is_f8(dtype))


def prefill_attention(
    q: jnp.ndarray,        # [P, Hq, D]
    k: jnp.ndarray,        # [P, Hkv, D]
    v: jnp.ndarray,        # [P, Hkv, D]
    valid_len: jnp.ndarray | int | None = None,
) -> jnp.ndarray:
    """Causal self-attention over a padded prefill window.

    Positions >= valid_len are padding: they are masked out as keys. (Their
    query outputs are garbage but are never read.) Returns [P, Hq, D].
    """
    P, Hq, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    scale = 1.0 / (D ** 0.5)

    qg = q.reshape(P, Hkv, group, D)
    # scores[p, h, g, c]
    scores = jnp.einsum("phgd,chd->phgc", qg, k, preferred_element_type=jnp.float32)
    scores = scores * scale

    pos = jnp.arange(P)
    causal = pos[None, :] <= pos[:, None]            # [P(query), P(key)]
    if valid_len is not None:
        causal = causal & (pos[None, :] < valid_len)
    scores = jnp.where(causal[:, None, None, :], scores, NEG_INF)

    probs = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum("phgc,chd->phgd", probs.astype(v.dtype), v)
    return out.reshape(P, Hq, D)


def decode_attention_layered(
    q: jnp.ndarray,        # [Hq, D]
    kv: jnp.ndarray,       # [L, 2, Hkv, C, D] full head-major cache
    layer: jnp.ndarray,    # scalar int32 layer index
    n_valid: jnp.ndarray,
    start: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Decode attention reading the FULL layer-stacked cache at a dynamic
    layer index. The kernel reads the layer in place; the XLA path reads
    kv[layer] as a dynamic-slice that fuses into the einsum.

    `start` (scalar): mask out cache positions < start — a lane refilled
    mid-session by the continuous-batching scheduler has stale entries from
    the previous occupant below its splice point (runtime/continuous.py)."""
    _, _, Hkv, C, D = kv.shape

    def einsum(q, kv, layer, n_valid, start):
        return decode_attention(q, kv[layer, 0], kv[layer, 1], n_valid, start)

    return _dispatch(einsum, "decode_attention_pallas_layered",
                     kernel_fits(C, D, q.shape[0], Hkv, kv.dtype),
                     q, kv, layer, n_valid, start)


def decode_attention_auto(
    q: jnp.ndarray,
    k_cache: jnp.ndarray,
    v_cache: jnp.ndarray,
    n_valid: jnp.ndarray,
    start: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Decode attention over a head-major [Hkv, C, D] cache: the kernel on
    CUDA when kernel_fits, the einsum otherwise."""
    Hkv, C, D = k_cache.shape
    return _dispatch(decode_attention, "decode_attention_pallas",
                     kernel_fits(C, D, q.shape[0], Hkv, k_cache.dtype),
                     q, k_cache, v_cache, n_valid, start)


def _dispatch(einsum, kernel_name: str, fits: bool, *args):
    """einsum(*args) everywhere, or the named kernel when lowering for CUDA
    and the shape fits. `start` (the last arg) may be None: no stale rows."""
    if not fits:
        return einsum(*args)
    from . import pallas_attention

    kernel = getattr(pallas_attention, kernel_name)
    *head, start = args
    if start is None:
        return lax.platform_dependent(
            *head, cuda=lambda *a: kernel(*a, 0),
            default=lambda *a: einsum(*a, None))
    return lax.platform_dependent(*head, start, cuda=kernel, default=einsum)


def _is_f8(dtype) -> bool:
    return dtype in (jnp.float8_e4m3fn, jnp.float8_e5m2)


def decode_attention(
    q: jnp.ndarray,        # [Hq, D]
    k_cache: jnp.ndarray,  # [Hkv, C, D] head-major
    v_cache: jnp.ndarray,  # [Hkv, C, D]
    n_valid: jnp.ndarray,  # scalar int: number of valid cache entries
    start: jnp.ndarray | None = None,  # scalar: entries < start are stale
) -> jnp.ndarray:
    """Single-token attention over a preallocated KV cache. Returns [Hq, D].

    An fp8 (e4m3) cache is upcast explicitly; XLA fuses the convert into the
    matmul operand read, so the cache is read at 8 bits."""
    Hq, D = q.shape
    Hkv, C, _ = k_cache.shape
    group = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    if _is_f8(k_cache.dtype):
        k_cache = k_cache.astype(jnp.bfloat16)
        v_cache = v_cache.astype(jnp.bfloat16)

    qg = q.reshape(Hkv, group, D)
    scores = jnp.einsum("hgd,hcd->hgc", qg, k_cache, preferred_element_type=jnp.float32)
    scores = scores * scale
    mask = jnp.arange(C) < n_valid
    if start is not None:
        mask = mask & (jnp.arange(C) >= start)
    scores = jnp.where(mask[None, None, :], scores, NEG_INF)
    probs = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum("hgc,hcd->hgd", probs.astype(v_cache.dtype), v_cache)
    return out.reshape(Hq, D)
