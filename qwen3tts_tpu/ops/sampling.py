"""On-device token sampling.

Reproduces the reference CLI semantics exactly, but entirely inside the jitted
decode loop (no host round-trip):

- greedy when temperature <= 0 (argmax, first-max tie-break)
  (reference src/tts_transformer.cpp:2686-2687)
- temperature scaling -> top-k filter -> softmax -> categorical
  (reference src/tts_transformer.cpp:2689-2721)
- HuggingFace-style repetition penalty over the set of previously generated
  codebook-0 tokens: positive logits divided, negative multiplied
  (reference src/tts_transformer.cpp:2672-2683); the C++ ``unordered_set``
  becomes a fixed-size boolean seen-mask carried through the loop.
- codebook-0 suppression of the top-1024 codec ids except EOS
  (reference src/tts_transformer.cpp:2658,2665-2670)
- top-p (nucleus) filtering: parsed-but-dead in the reference CLI
  (README.md:184); wired for real here. top_p >= 1.0 disables it.

All masking uses a large-negative constant rather than -inf so that fully
masked rows cannot produce NaNs under f32 softmax.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF = -1e30  # plain float: no device allocation at import time


def sampling_flags(temperature, top_p, greedy=None, use_top_p=None):
    """Static sampler-stage gates, derived once at the outermost entry point
    from python-float sampling params (traced scalars keep the conservative
    dynamic path: greedy=False, use_top_p=True).

    Flags instead of branchless compute: the top-p binary search is a chain
    of full-vector reductions that costs time even when the stage is a no-op
    (top_p == 1, or greedy decode). With flags the common classes skip it,
    while changing temperature/top_p VALUES within a class never recompiles
    (they stay traced scalars). Moving between classes (greedy<->sampled,
    top_p on<->off) compiles each program once — four variants at most per
    shape bucket.
    """
    if greedy is None:
        greedy = isinstance(temperature, (int, float)) and float(temperature) <= 0.0
    if use_top_p is None:
        if isinstance(top_p, (int, float)):
            use_top_p = float(top_p) < 1.0
        else:
            use_top_p = True
    return bool(greedy), bool(use_top_p)


def apply_suppression(logits: jnp.ndarray, suppress_start: int, eos_id: int) -> jnp.ndarray:
    """Mask ids in [suppress_start, vocab) except eos_id."""
    vocab = logits.shape[-1]
    ids = jnp.arange(vocab)
    mask = (ids >= suppress_start) & (ids != eos_id)
    return jnp.where(mask, NEG_INF, logits)


def apply_repetition_penalty(logits: jnp.ndarray, seen_mask: jnp.ndarray, penalty) -> jnp.ndarray:
    """HF-style penalty on previously seen ids (seen_mask: bool [vocab]).
    penalty may be a python float or a traced scalar (recompile-free)."""
    if isinstance(penalty, (int, float)) and penalty == 1.0:
        return logits
    penalized = jnp.where(logits > 0.0, logits / penalty, logits * penalty)
    return jnp.where(seen_mask, penalized, logits)


def apply_top_k(logits: jnp.ndarray, top_k: int) -> jnp.ndarray:
    """Keep the top-k logits (threshold = k-th largest, ties kept), mask rest.

    Matches the reference's partial_sort threshold semantics
    (src/tts_transformer.cpp:2693-2708): values strictly below the k-th
    largest are masked; equal values survive.
    """
    vocab = logits.shape[-1]
    if top_k <= 0 or top_k >= vocab:
        return logits
    kth = jax.lax.top_k(logits, top_k)[0][..., -1]
    return jnp.where(logits < kth[..., None], NEG_INF, logits)


_TOPP_BSEARCH_ITERS = 30


def apply_top_p(logits: jnp.ndarray, top_p) -> jnp.ndarray:
    """Nucleus filtering: keep the smallest prefix of the sorted distribution
    whose cumulative probability reaches top_p (the crossing token and its
    ties are kept).

    Implemented as a binary search for the probability threshold tau —
    largest tau with mass(probs >= tau) >= top_p — instead of a sort:
    O(V·iters) elementwise work traced once, no sort network per frame, and
    top_p may be a TRACED scalar (recompile-free sampling params). Bit-for-
    bit the same keep-set as the sort formulation away from FP-tie edges."""
    if isinstance(top_p, (int, float)) and top_p >= 1.0:
        return logits
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)

    def bs(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        mass = jnp.sum(jnp.where(probs >= mid, probs, 0.0), axis=-1,
                       keepdims=True)
        take = mass >= top_p
        return jnp.where(take, mid, lo), jnp.where(take, hi, mid)

    lo0 = jnp.zeros_like(probs[..., :1])
    hi0 = jnp.max(probs, axis=-1, keepdims=True)
    plo, _ = jax.lax.fori_loop(0, _TOPP_BSEARCH_ITERS, bs, (lo0, hi0))
    masked = jnp.where(probs >= plo, logits, NEG_INF)
    return jnp.where(top_p >= 1.0, logits, masked)


def sample_token(
    key: jax.Array,
    logits: jnp.ndarray,
    *,
    temperature,
    top_k: int,
    top_p=1.0,
    greedy=None,
    use_top_p=None,
) -> jnp.ndarray:
    """Sample one token id from logits [vocab] (or batched [..., vocab]).

    top_k is a Python int (static: lax.top_k needs a static k); temperature
    and top_p may be Python floats OR traced scalars — one compiled program
    serves every sampling configuration within a stage class (the reference
    accepts these per-call, src/tts_transformer.cpp:2577-2596). greedy /
    use_top_p are static stage gates (sampling_flags), derived from
    python-float params when not given.
    """
    greedy, use_top_p = sampling_flags(temperature, top_p, greedy, use_top_p)
    greedy_tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    if greedy:
        return greedy_tok
    t = jnp.asarray(temperature, jnp.float32)
    scaled = logits.astype(jnp.float32) / jnp.maximum(t, 1e-6)
    scaled = apply_top_k(scaled, top_k)
    if use_top_p:
        scaled = apply_top_p(scaled, top_p)
    sampled = jax.random.categorical(key, scaled, axis=-1).astype(jnp.int32)
    return jnp.where(t <= 0.0, greedy_tok, sampled)
