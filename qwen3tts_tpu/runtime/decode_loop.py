"""The fused autoregressive frame loop — entirely on device under one jit.

This replaces the reference's hot loop (src/tts_transformer.cpp:2577-2851),
which rebuilds+reallocates GGML graphs every talker step and all 14 code
predictor steps of every frame and round-trips logits to the host for
sampling. Its own timing tables attribute ~71% of generation time to the code
predictor and large constant costs to graph build/alloc (README.md:276-295).
Under ``jax.jit`` with ``lax.while_loop`` none of that exists: one compiled
program per (frame-bucket, text-bucket) pair runs prefill, per-frame talker
steps, the 15-code predictor scan, and sampling without leaving the device.

Per frame (matching generate() semantics exactly):
  1. suppress codec ids [vocab-1024, vocab) except EOS on the cb0 logits
  2. HF-style repetition penalty over the seen-cb0 mask
  3. sample cb0 (greedy / temperature+top-k(+top-p)); stop on EOS 2150
  4. code predictor -> codes 1..15
  5. step_embd = codec_embd[cb0] + sum_cb code_pred_embd[cb-1][code_cb]
                 + trailing_text_hidden[frame] (tts_pad beyond the schedule)
     (tts_transformer.cpp:2759-2790)
  6. talker forward_step -> next logits / hidden
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import io_callback as _io_callback
from jax import lax

from ..config import CodePredictorConfig, TalkerConfig
from ..models import code_predictor as cp_model
from ..models import talker as talker_model
from ..ops.attention import kernel_allowed
from ..ops.sampling import (apply_repetition_penalty, apply_suppression,
                            sample_token, sampling_flags)
from ..parallel.mesh import spans_devices


class GenerateResult(NamedTuple):
    codes: jnp.ndarray      # [max_frames, 16] int32 (rows >= n_frames are zero)
    n_frames: jnp.ndarray   # scalar int32
    hidden: jnp.ndarray     # [max_frames, H] output-normed per-frame talker hidden


class _LoopState(NamedTuple):
    frame: jnp.ndarray
    n_past: jnp.ndarray
    logits: jnp.ndarray      # [Vc] cb0 logits of the last talker step
    last_hidden: jnp.ndarray
    kv: jnp.ndarray
    seen: jnp.ndarray
    codes: jnp.ndarray
    hidden_out: jnp.ndarray
    key: jax.Array
    done: jnp.ndarray


def _rest_embd_sum(cp_params, cp_cfg, rest):
    """Sigma_cb code_pred_embd[cb-1][code_cb] term of the next talker step
    embedding (reference src/tts_transformer.cpp:2759-2790); the table
    alignment must match cp_model.predict_codes' embds[s-1] convention.
    rest is [15] (single-stream) or [B, 15] (batched lanes)."""
    idx = jnp.arange(cp_cfg.n_steps)
    if rest.ndim == 2:
        emb = cp_params.embds[idx[None, :], rest]        # [B, 15, H]
        return jnp.sum(emb.astype(jnp.float32), axis=1)
    return jnp.sum(cp_params.embds[idx, rest].astype(jnp.float32), axis=0)


def _init_state(talker_params, talker_cfg, prefill, key, *, max_frames,
                kv_capacity) -> _LoopState:
    """Talker prefill over the fixed window + the loop's initial state."""
    H = talker_cfg.hidden_size
    Vc = talker_cfg.codec_vocab_size
    dtype = talker_params.codec_embd.dtype
    kv = talker_model.make_kv_cache(talker_cfg, kv_capacity, dtype)
    last_hidden, logits, kv = talker_model.talker_prefill(
        talker_params, talker_cfg, prefill.prefill_embd, kv)
    return _LoopState(
        frame=jnp.int32(0),
        n_past=jnp.int32(prefill.prefill_embd.shape[0]),
        logits=logits,
        last_hidden=last_hidden,
        kv=kv,
        seen=jnp.zeros((Vc,), jnp.bool_),
        codes=jnp.zeros((max_frames, talker_cfg.n_codebooks), jnp.int32),
        hidden_out=jnp.zeros((max_frames, H), dtype),
        key=key,
        done=jnp.bool_(False),
    )


def generate(
    talker_params: talker_model.TalkerParams,
    cp_params: cp_model.CodePredictorParams,
    talker_cfg: TalkerConfig,
    cp_cfg: CodePredictorConfig,
    prefill: talker_model.PrefillInputs,
    key: jax.Array,
    *,
    max_frames: int,
    kv_capacity: int,
    temperature: float,
    top_k: int,
    top_p: float = 1.0,
    repetition_penalty: float = 1.05,
    progress_cb=None,
    allow_eos: bool = True,
    kv_strategy: str = "auto",
    greedy=None,
    use_top_p=None,
    budget=None,   # traced scalar frame cap (EOS emulation / per-request)
) -> GenerateResult:
    """Run prefill + the full frame loop. Static args define the compiled
    shape bucket; temperature/top_p/repetition_penalty are traced scalars
    (value changes never recompile) and tensor args vary freely within it.

    progress_cb, if given, is invoked from the device loop via io_callback
    with the current frame count — this wires up the reference's declared-but-
    never-called progress callback (qwen3_tts.cpp:444-446) for real. It costs
    a host round trip per frame; leave it None on the fast path."""
    greedy, use_top_p = sampling_flags(temperature, top_p, greedy, use_top_p)
    state = _init_state(talker_params, talker_cfg, prefill, key,
                        max_frames=max_frames, kv_capacity=kv_capacity)
    body = _make_body(
        talker_params, cp_params, talker_cfg, cp_cfg, prefill,
        temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty, progress_cb=progress_cb,
        allow_eos=allow_eos, kv_strategy=kv_strategy, greedy=greedy,
        use_top_p=use_top_p)

    limit = (jnp.int32(max_frames) if budget is None
             else jnp.minimum(jnp.int32(max_frames),
                              jnp.asarray(budget, jnp.int32)))

    def cond(s: _LoopState):
        return jnp.logical_and(~s.done, s.frame < limit)

    final = lax.while_loop(cond, body, state)
    return GenerateResult(codes=final.codes, n_frames=final.frame, hidden=final.hidden_out)


def _make_body(
    talker_params, cp_params, talker_cfg, cp_cfg, prefill, *,
    temperature, top_k, top_p, repetition_penalty, progress_cb, allow_eos,
    kv_strategy: str = "auto", greedy=None, use_top_p=None,
):
    """The per-frame loop body, shared by full and chunked (streaming)
    generation."""
    Vc = talker_cfg.codec_vocab_size
    suppress_start = Vc - talker_cfg.n_suppressed_tail
    Trb = prefill.trailing.shape[0]
    dtype = talker_params.codec_embd.dtype
    greedy, use_top_p = sampling_flags(temperature, top_p, greedy, use_top_p)

    def body(s: _LoopState) -> _LoopState:
        # --- sample codebook 0 ---
        # allow_eos=False additionally masks EOS (benchmark mode: fixed-length
        # runs regardless of what random/sampled logits prefer).
        eos_for_mask = talker_cfg.codec_eos_id if allow_eos else -1
        key, k_cb0, k_cp = jax.random.split(s.key, 3)
        l = apply_suppression(s.logits, suppress_start, eos_for_mask)
        l = apply_repetition_penalty(l, s.seen, repetition_penalty)
        cb0 = sample_token(k_cb0, l, temperature=temperature, top_k=top_k,
                           top_p=top_p, greedy=greedy, use_top_p=use_top_p)
        done = jnp.logical_and(cb0 == talker_cfg.codec_eos_id, allow_eos)

        # --- residual codebooks 1..15 ---
        cb0_embd = talker_params.codec_embd[cb0]
        rest = cp_model.predict_codes(
            cp_params, cp_cfg, s.last_hidden.astype(dtype), cb0_embd, k_cp,
            temperature=temperature, top_k=top_k, top_p=top_p,
            greedy=greedy, use_top_p=use_top_p)
        frame_codes = jnp.concatenate([cb0[None], rest])

        emit = ~done
        codes = s.codes.at[s.frame].set(jnp.where(emit, frame_codes, s.codes[s.frame]))
        hidden_out = s.hidden_out.at[s.frame].set(
            jnp.where(emit, s.last_hidden.astype(s.hidden_out.dtype), s.hidden_out[s.frame]))
        seen = s.seen.at[cb0].set(jnp.where(emit, True, s.seen[cb0]))

        # --- next-step input embedding ---
        rest_sum = _rest_embd_sum(cp_params, cp_cfg, rest)
        trailing_row = prefill.trailing[jnp.minimum(s.frame, Trb - 1)]
        step_embd = (cb0_embd.astype(jnp.float32)
                     + rest_sum
                     + trailing_row.astype(jnp.float32)).astype(dtype)

        # --- talker step ---
        hidden, logits, kv = talker_model.talker_step(
            talker_params, talker_cfg, step_embd, s.n_past, s.kv,
            strategy=kv_strategy)

        if progress_cb is not None:
            _io_callback(progress_cb, None, s.frame + emit.astype(jnp.int32),
                         ordered=False)

        return _LoopState(
            frame=s.frame + emit.astype(jnp.int32),
            n_past=s.n_past + 1,
            logits=logits,
            last_hidden=hidden,
            kv=kv,
            seen=seen,
            codes=codes,
            hidden_out=hidden_out,
            key=key,
            done=done,
        )

    return body


def generate_from_tokens(
    talker_params,
    cp_params,
    tokens: jnp.ndarray,        # [Tb] padded TTS-formatted ids
    n_tokens: jnp.ndarray,      # scalar
    speaker_embd: jnp.ndarray,  # [H]
    language_id: jnp.ndarray,   # scalar
    key: jax.Array,
    *,
    talker_cfg: TalkerConfig,
    cp_cfg: CodePredictorConfig,
    max_frames: int,
    kv_capacity: int,
    temperature: float,
    top_k: int,
    top_p: float = 1.0,
    repetition_penalty: float = 1.05,
    nothink: bool = False,
    progress_cb=None,
    allow_eos: bool = True,
    greedy=None,
    use_top_p=None,
) -> GenerateResult:
    """End-to-end jitted path: prefill-embedding construction + generate.

    temperature/top_p/repetition_penalty are traced — value changes reuse
    the compiled program; the static sampler-stage flags are derived here
    (sampling.sampling_flags)."""
    greedy, use_top_p = sampling_flags(temperature, top_p, greedy, use_top_p)
    return _generate_from_tokens_jit(
        talker_params, cp_params, tokens, n_tokens, speaker_embd, language_id,
        key, talker_cfg=talker_cfg, cp_cfg=cp_cfg, max_frames=max_frames,
        kv_capacity=kv_capacity, temperature=temperature, top_k=top_k,
        top_p=top_p, repetition_penalty=repetition_penalty, nothink=nothink,
        progress_cb=progress_cb, allow_eos=allow_eos, greedy=greedy,
        use_top_p=use_top_p)


@functools.partial(
    jax.jit,
    static_argnames=(
        "talker_cfg", "cp_cfg", "max_frames", "kv_capacity", "top_k",
        "nothink", "progress_cb", "allow_eos", "greedy", "use_top_p",
    ),
)
def _generate_from_tokens_jit(
    talker_params, cp_params, tokens, n_tokens, speaker_embd, language_id,
    key, *, talker_cfg, cp_cfg, max_frames, kv_capacity, temperature, top_k,
    top_p, repetition_penalty, nothink, progress_cb, allow_eos, greedy,
    use_top_p,
) -> GenerateResult:
    prefill = talker_model.build_prefill(
        talker_params, talker_cfg, tokens, n_tokens, speaker_embd, language_id,
        nothink=nothink)
    return generate(
        talker_params, cp_params, talker_cfg, cp_cfg, prefill, key,
        max_frames=max_frames, kv_capacity=kv_capacity,
        temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty, progress_cb=progress_cb,
        allow_eos=allow_eos, greedy=greedy, use_top_p=use_top_p)


def generate_from_tokens_batched(
    talker_params, cp_params, tokens, n_tokens, speaker_embd, language_id,
    keys, *, talker_cfg, cp_cfg, max_frames, kv_capacity, temperature, top_k,
    top_p=1.0, repetition_penalty=1.05, nothink=False, allow_eos=True,
    greedy=None, use_top_p=None, budgets=None,
) -> GenerateResult:
    """See _generate_from_tokens_batched_jit. This wrapper derives the static
    sampler-stage flags from python-float params (sampling.sampling_flags),
    so temperature/top_p value changes never recompile, and whether the
    decode-attention kernel may run: not when the params or lanes span
    several devices (pallas_call has no partitioning rule)."""
    greedy, use_top_p = sampling_flags(temperature, top_p, greedy, use_top_p)
    return _generate_from_tokens_batched_jit(
        talker_params, cp_params, tokens, n_tokens, speaker_embd, language_id,
        keys, budgets, talker_cfg=talker_cfg, cp_cfg=cp_cfg,
        max_frames=max_frames, kv_capacity=kv_capacity,
        temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty, nothink=nothink,
        allow_eos=allow_eos, greedy=greedy, use_top_p=use_top_p,
        attn_kernel=not spans_devices(talker_params, cp_params, tokens, keys))


class _BatchedState(NamedTuple):
    it: jnp.ndarray          # scalar iteration counter (== n_past - prefill)
    n_past: jnp.ndarray      # scalar: lockstep across lanes (fixed prefill)
    logits: jnp.ndarray      # [B, Vc]
    last_hidden: jnp.ndarray  # [B, H]
    kv: jnp.ndarray          # [B, L, 2, Hkv, C, D]
    seen: jnp.ndarray        # [B, Vc]
    frame: jnp.ndarray       # [B]
    codes: jnp.ndarray       # [B, maxF, 16]
    hidden_out: jnp.ndarray  # [B, maxF, H]
    keys: jax.Array          # [B] per-lane PRNG keys
    done: jnp.ndarray        # [B]


@functools.partial(
    jax.jit,
    static_argnames=(
        "talker_cfg", "cp_cfg", "max_frames", "kv_capacity", "top_k",
        "nothink", "allow_eos", "greedy", "use_top_p", "attn_kernel",
    ),
)
def _generate_from_tokens_batched_jit(
    talker_params,
    cp_params,
    tokens: jnp.ndarray,        # [B, Tb]
    n_tokens: jnp.ndarray,      # [B]
    speaker_embd: jnp.ndarray,  # [B, H]
    language_id: jnp.ndarray,   # [B]
    keys: jax.Array,            # [B] PRNG keys (jax.random.split output)
    budgets: jnp.ndarray | None,   # [B] per-lane frame caps (traced)
    *,
    talker_cfg: TalkerConfig,
    cp_cfg: CodePredictorConfig,
    max_frames: int,
    kv_capacity: int,
    temperature: float,
    top_k: int,
    top_p: float,
    repetition_penalty: float,
    nothink: bool,
    allow_eos: bool,
    greedy: bool,
    use_top_p: bool,
    attn_kernel: bool,
) -> GenerateResult:
    """Batched multi-utterance generation (BASELINE.json config #5).

    All lanes advance through each AR step together: n_past is a shared
    scalar because the prefill window length is fixed, and the loop runs
    until every lane is done (finished lanes keep stepping with masked
    emissions). Per-lane semantics equal the single-stream loop: every lane
    carries its own key chain, split exactly like generate()'s body (key ->
    key, k_cb0, k_cp per frame), so lane b reproduces
    generate_from_tokens(keys[b]).

    One loop with a scalar exit condition rather than vmap over generate():
    a vmapped while_loop with a per-lane predicate selects every carried
    buffer (the whole KV cache) per step. Shard the batch axis over the
    mesh's "dp" axis and the params over "tp" (parallel/shardings.py) for
    multi-device serving."""
    with kernel_allowed(attn_kernel):
        return _generate_batched(
            talker_params, cp_params, tokens, n_tokens, speaker_embd,
            language_id, keys, budgets, talker_cfg=talker_cfg, cp_cfg=cp_cfg,
            max_frames=max_frames, kv_capacity=kv_capacity,
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, nothink=nothink,
            allow_eos=allow_eos, greedy=greedy, use_top_p=use_top_p)


def _generate_batched(
    talker_params, cp_params, tokens, n_tokens, speaker_embd, language_id,
    keys, budgets, *, talker_cfg, cp_cfg, max_frames, kv_capacity,
    temperature, top_k, top_p, repetition_penalty, nothink, allow_eos,
    greedy, use_top_p,
) -> GenerateResult:
    B = tokens.shape[0]
    H = talker_cfg.hidden_size
    Vc = talker_cfg.codec_vocab_size
    suppress_start = Vc - talker_cfg.n_suppressed_tail
    dtype = talker_params.codec_embd.dtype

    prefill = jax.vmap(
        lambda t, n, sp, lg: talker_model.build_prefill(
            talker_params, talker_cfg, t, n, sp, lg, nothink=nothink)
    )(tokens, n_tokens, speaker_embd, language_id)
    prefill_len = prefill.prefill_embd.shape[1]
    Trb = prefill.trailing.shape[1]

    kv0 = talker_model.make_kv_cache(talker_cfg, kv_capacity, dtype)
    last_hidden, logits, kv = jax.vmap(
        lambda pe: talker_model.talker_prefill(talker_params, talker_cfg, pe, kv0)
    )(prefill.prefill_embd)
    eos_for_mask = talker_cfg.codec_eos_id if allow_eos else -1

    state = _BatchedState(
        it=jnp.int32(0),
        n_past=jnp.int32(prefill_len),
        logits=logits,
        last_hidden=last_hidden,
        kv=kv,
        seen=jnp.zeros((B, Vc), jnp.bool_),
        frame=jnp.zeros((B,), jnp.int32),
        codes=jnp.zeros((B, max_frames, talker_cfg.n_codebooks), jnp.int32),
        hidden_out=jnp.zeros((B, max_frames, H), dtype),
        keys=keys,
        done=jnp.zeros((B,), jnp.bool_),
    )

    def body(s: _BatchedState) -> _BatchedState:
        # per-lane key chains, split exactly like the single-stream body
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(s.keys)   # [B, 3, ...]
        keys_next, k_cb0, k_cp = ks[:, 0], ks[:, 1], ks[:, 2]
        l = apply_suppression(s.logits, suppress_start, eos_for_mask)
        l = apply_repetition_penalty(l, s.seen, repetition_penalty)
        cb0 = jax.vmap(
            lambda kk, row: sample_token(
                kk, row, temperature=temperature, top_k=top_k,
                top_p=top_p, greedy=greedy, use_top_p=use_top_p)
        )(k_cb0, l)
        done = jnp.logical_or(
            s.done, jnp.logical_and(cb0 == talker_cfg.codec_eos_id, allow_eos))
        emit = ~done

        # one-hot matmul instead of a per-lane row gather of the [Vc, H]
        # table (exact: one nonzero term per row)
        onehot_cb0 = (cb0[:, None] == jnp.arange(Vc)[None, :])
        cb0_embd = jax.lax.dot_general(
            onehot_cb0.astype(dtype), talker_params.codec_embd,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32).astype(dtype)   # [B, H]
        rest = jax.vmap(
            lambda h, ce, kk: cp_model.predict_codes(
                cp_params, cp_cfg, h, ce, kk, temperature=temperature,
                top_k=top_k, top_p=top_p, greedy=greedy,
                use_top_p=use_top_p)
        )(s.last_hidden.astype(dtype), cb0_embd, k_cp)           # [B, 15]
        rest_sum = _rest_embd_sum(cp_params, cp_cfg, rest)       # [B, H]
        frame_codes = jnp.concatenate([cb0[:, None], rest], axis=1)

        # lanes are LOCKSTEP (frame[b] == it for every never-done lane), so
        # the emission writes land at column `it` as ONE dynamic_update_slice
        # instead of per-lane scatters; done lanes' masked writes re-write
        # the unwritten zeros at column it (their frame froze earlier) — a
        # no-op, preserving per-lane scatter semantics exactly
        codes = lax.dynamic_update_slice(
            s.codes,
            jnp.where(emit[:, None, None], frame_codes[:, None, :],
                      lax.dynamic_slice(
                          s.codes, (0, s.it, 0),
                          (B, 1, talker_cfg.n_codebooks))),
            (0, s.it, 0))
        h_row = s.last_hidden.astype(s.hidden_out.dtype)[:, None, :]
        hidden_out = lax.dynamic_update_slice(
            s.hidden_out,
            jnp.where(emit[:, None, None], h_row,
                      lax.dynamic_slice(s.hidden_out, (0, s.it, 0), (B, 1, H))),
            (0, s.it, 0))
        seen = s.seen | (onehot_cb0 & emit[:, None])

        # trailing row via masked reduction (per-lane dynamic row of
        # [B, Trb, H] — gather-free; Trb is a small bucket)
        t_idx = jnp.minimum(s.frame, Trb - 1)                  # [B]
        t_mask = (jnp.arange(Trb)[None, :] == t_idx[:, None])  # [B, Trb]
        trailing_row = jnp.sum(
            jnp.where(t_mask[:, :, None], prefill.trailing, 0).astype(jnp.float32),
            axis=1)
        step_embd = (cb0_embd.astype(jnp.float32) + rest_sum
                     + trailing_row).astype(dtype)

        # "carried" KV strategy: under vmap the sliced scheme's per-layer
        # cache copies multiply by B
        hidden, logits, kv = jax.vmap(
            lambda e, kvi: talker_model.talker_step(
                talker_params, talker_cfg, e, s.n_past, kvi,
                strategy="carried")
        )(step_embd, s.kv)

        frame_new = s.frame + emit.astype(jnp.int32)
        if budgets is not None:
            # per-lane frame budgets (EOS emulation for synthetic weights /
            # per-request caps): a lane is done once it has emitted its
            # budget — the while_loop then exits at max-of-batch budget
            # instead of the compiled max_frames bucket, exactly like a
            # batch of real EOS hits (continuous.decode_chunk semantics)
            done = jnp.logical_or(done, frame_new >= budgets)
        return _BatchedState(
            it=s.it + 1,
            n_past=s.n_past + 1,
            logits=logits,
            last_hidden=hidden,
            kv=kv,
            seen=seen,
            frame=frame_new,
            codes=codes,
            hidden_out=hidden_out,
            keys=keys_next,
            done=done,
        )

    def cond(s: _BatchedState):
        return jnp.logical_and(jnp.any(~s.done), s.it < max_frames)

    final = lax.while_loop(cond, body, state)
    return GenerateResult(codes=final.codes, n_frames=final.frame,
                          hidden=final.hidden_out)


# ---------------------------------------------------------------------------
# chunked (streaming) generation: prefill once, then decode in fixed-size
# frame chunks so audio can be vocoded and emitted while generation continues
# (the reference lists streaming as unimplemented future work,
# OPTIMIZATION.md:157-159).
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("talker_cfg", "cp_cfg", "max_frames", "kv_capacity",
                     "nothink"),
)
def generate_init(
    talker_params,
    cp_params,
    tokens: jnp.ndarray,
    n_tokens: jnp.ndarray,
    speaker_embd: jnp.ndarray,
    language_id: jnp.ndarray,
    key: jax.Array,
    *,
    talker_cfg: TalkerConfig,
    cp_cfg: CodePredictorConfig,
    max_frames: int,
    kv_capacity: int,
    nothink: bool = False,
):
    """Build prefill inputs, run the talker prefill, return (state, prefill)
    ready for generate_chunk."""
    prefill = talker_model.build_prefill(
        talker_params, talker_cfg, tokens, n_tokens, speaker_embd, language_id,
        nothink=nothink)
    state = _init_state(talker_params, talker_cfg, prefill, key,
                        max_frames=max_frames, kv_capacity=kv_capacity)
    return state, prefill


def generate_chunk(
    talker_params, cp_params, prefill, state, *, talker_cfg, cp_cfg,
    chunk_frames, max_frames, temperature, top_k, top_p=1.0,
    repetition_penalty=1.05, allow_eos=True, greedy=None, use_top_p=None,
) -> _LoopState:
    """Advance the decode loop by up to chunk_frames emitted frames. The
    state is donated (the KV cache updates in place across chunks); read
    state.frame/state.done/state.codes between chunks. Sampling params are
    traced; stage flags derived here."""
    greedy, use_top_p = sampling_flags(temperature, top_p, greedy, use_top_p)
    return _generate_chunk_jit(
        talker_params, cp_params, prefill, state, talker_cfg=talker_cfg,
        cp_cfg=cp_cfg, chunk_frames=chunk_frames, max_frames=max_frames,
        temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty, allow_eos=allow_eos,
        greedy=greedy, use_top_p=use_top_p)


@functools.partial(
    jax.jit,
    static_argnames=(
        "talker_cfg", "cp_cfg", "chunk_frames", "max_frames", "top_k",
        "allow_eos", "greedy", "use_top_p",
    ),
    donate_argnames=("state",),
)
def _generate_chunk_jit(
    talker_params,
    cp_params,
    prefill: talker_model.PrefillInputs,
    state: _LoopState,
    *,
    talker_cfg: TalkerConfig,
    cp_cfg: CodePredictorConfig,
    chunk_frames: int,
    max_frames: int,
    temperature: float,
    top_k: int,
    top_p: float,
    repetition_penalty: float,
    allow_eos: bool,
    greedy: bool,
    use_top_p: bool,
) -> _LoopState:
    body = _make_body(
        talker_params, cp_params, talker_cfg, cp_cfg, prefill,
        temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty, progress_cb=None,
        allow_eos=allow_eos, greedy=greedy, use_top_p=use_top_p)
    target = jnp.minimum(state.frame + chunk_frames, max_frames)

    def cond(s: _LoopState):
        return jnp.logical_and(~s.done, s.frame < target)

    return lax.while_loop(cond, body, state)


def generate_start(
    talker_params, cp_params, tokens, n_tokens, speaker_embd, language_id,
    key, *, talker_cfg, cp_cfg, chunk_frames, max_frames, kv_capacity,
    temperature, top_k, top_p=1.0, repetition_penalty=1.05, nothink=False,
    allow_eos=True, greedy=None, use_top_p=None,
):
    """Prefill + the FIRST chunk in one dispatch (time-to-first-audio path).
    Sampling params traced; stage flags derived here."""
    greedy, use_top_p = sampling_flags(temperature, top_p, greedy, use_top_p)
    return _generate_start_jit(
        talker_params, cp_params, tokens, n_tokens, speaker_embd, language_id,
        key, talker_cfg=talker_cfg, cp_cfg=cp_cfg, chunk_frames=chunk_frames,
        max_frames=max_frames, kv_capacity=kv_capacity,
        temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty, nothink=nothink,
        allow_eos=allow_eos, greedy=greedy, use_top_p=use_top_p)


@functools.partial(
    jax.jit,
    static_argnames=(
        "talker_cfg", "cp_cfg", "chunk_frames", "max_frames", "kv_capacity",
        "top_k", "nothink", "allow_eos", "greedy", "use_top_p",
    ),
)
def _generate_start_jit(
    talker_params,
    cp_params,
    tokens: jnp.ndarray,
    n_tokens: jnp.ndarray,
    speaker_embd: jnp.ndarray,
    language_id: jnp.ndarray,
    key: jax.Array,
    *,
    talker_cfg: TalkerConfig,
    cp_cfg: CodePredictorConfig,
    chunk_frames: int,
    max_frames: int,
    kv_capacity: int,
    temperature: float,
    top_k: int,
    top_p: float,
    repetition_penalty: float,
    nothink: bool,
    allow_eos: bool,
    greedy: bool,
    use_top_p: bool,
):
    """Prefill + the FIRST chunk in one dispatch (time-to-first-audio path:
    one device round-trip instead of two before the first vocoder call)."""
    prefill = talker_model.build_prefill(
        talker_params, talker_cfg, tokens, n_tokens, speaker_embd, language_id,
        nothink=nothink)
    state = _init_state(talker_params, talker_cfg, prefill, key,
                        max_frames=max_frames, kv_capacity=kv_capacity)
    body = _make_body(
        talker_params, cp_params, talker_cfg, cp_cfg, prefill,
        temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty, progress_cb=None,
        allow_eos=allow_eos, greedy=greedy, use_top_p=use_top_p)
    target = jnp.minimum(jnp.int32(chunk_frames), max_frames)

    def cond(s: _LoopState):
        return jnp.logical_and(~s.done, s.frame < target)

    return lax.while_loop(cond, body, state), prefill
