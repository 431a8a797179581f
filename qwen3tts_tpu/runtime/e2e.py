"""Single-dispatch synthesis: prefill + frame loop + vocoder in ONE jitted
program.

The split pipeline (generate dispatch -> host codes transfer -> vocoder
dispatch) pays two device round trips, and the host hop serializes the
stages. Fusing them returns the full padded-bucket waveform with the frame
count, one dispatch end-to-end.

Trade-off: the vocoder runs over the whole max_frames bucket even when EOS
stops generation early (codes rows past n_frames are zero; the audio tail is
sliced off on the host). That's the right trade for serving with tight
max-token budgets and for benchmarks; the default pipeline path keeps the
split so short utterances vocode a smaller bucket
(RuntimeConfig.fused_dispatch opts in).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..models import vocoder as vocoder_model
from ..ops.sampling import sampling_flags
from . import decode_loop


def generate_and_vocode(
    talker_params, cp_params, vocoder_params, tokens, n_tokens, speaker_embd,
    language_id, key, *, talker_cfg, cp_cfg, vocoder_cfg, max_frames,
    kv_capacity, temperature, top_k, top_p=1.0, repetition_penalty=1.05,
    nothink=False, allow_eos=True, greedy=None, use_top_p=None, pcm16=False,
):
    """Returns (audio [max_frames * samples_per_frame] f32 — or int16 PCM
    when pcm16, halving the host-fetch bytes — and GenerateResult). Valid
    audio is the first n_frames * samples_per_frame samples. Sampling params
    are traced; stage flags derived here (sampling.sampling_flags)."""
    greedy, use_top_p = sampling_flags(temperature, top_p, greedy, use_top_p)
    return _generate_and_vocode_jit(
        talker_params, cp_params, vocoder_params, tokens, n_tokens,
        speaker_embd, language_id, key, talker_cfg=talker_cfg, cp_cfg=cp_cfg,
        vocoder_cfg=vocoder_cfg, max_frames=max_frames,
        kv_capacity=kv_capacity, temperature=temperature, top_k=top_k,
        top_p=top_p, repetition_penalty=repetition_penalty, nothink=nothink,
        allow_eos=allow_eos, greedy=greedy, use_top_p=use_top_p, pcm16=pcm16)


@functools.partial(
    jax.jit,
    static_argnames=(
        "talker_cfg", "cp_cfg", "vocoder_cfg", "max_frames", "kv_capacity",
        "top_k", "nothink", "allow_eos", "greedy", "use_top_p", "pcm16",
    ),
)
def _generate_and_vocode_jit(
    talker_params,
    cp_params,
    vocoder_params,
    tokens: jnp.ndarray,        # [Tb] padded TTS-formatted ids
    n_tokens: jnp.ndarray,      # scalar
    speaker_embd: jnp.ndarray,  # [H]
    language_id: jnp.ndarray,   # scalar
    key: jax.Array,
    *,
    talker_cfg,
    cp_cfg,
    vocoder_cfg,
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
    pcm16: bool,
):
    gen = decode_loop.generate_from_tokens(
        talker_params, cp_params, tokens, n_tokens, speaker_embd, language_id,
        key, talker_cfg=talker_cfg, cp_cfg=cp_cfg, max_frames=max_frames,
        kv_capacity=kv_capacity, temperature=temperature, top_k=top_k,
        top_p=top_p, repetition_penalty=repetition_penalty, nothink=nothink,
        allow_eos=allow_eos, greedy=greedy, use_top_p=use_top_p)
    audio = vocoder_model.vocoder_forward(
        vocoder_params, vocoder_cfg, gen.codes, gen.n_frames)
    if pcm16:
        audio = jnp.clip(audio * 32767.0, -32768.0, 32767.0).astype(jnp.int16)
    return audio, gen


def start_and_vocode(
    talker_params, cp_params, vocoder_params, tokens, n_tokens, speaker_embd,
    language_id, key, *, talker_cfg, cp_cfg, vocoder_cfg, chunk_frames,
    max_frames, kv_capacity, temperature, top_k, top_p=1.0,
    repetition_penalty=1.05, nothink=False, allow_eos=True, greedy=None,
    use_top_p=None,
):
    """Time-to-first-audio path, one dispatch: prefill + the first
    chunk_frames of generation + vocoder over that chunk. Returns
    (audio [chunk_frames * samples_per_frame] f32, state, prefill); continue
    with decode_loop.generate_chunk + the streaming vocoder. Sampling params
    are traced; stage flags derived here."""
    greedy, use_top_p = sampling_flags(temperature, top_p, greedy, use_top_p)
    return _start_and_vocode_jit(
        talker_params, cp_params, vocoder_params, tokens, n_tokens,
        speaker_embd, language_id, key, talker_cfg=talker_cfg, cp_cfg=cp_cfg,
        vocoder_cfg=vocoder_cfg, chunk_frames=chunk_frames,
        max_frames=max_frames, kv_capacity=kv_capacity,
        temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty, nothink=nothink,
        allow_eos=allow_eos, greedy=greedy, use_top_p=use_top_p)


@functools.partial(
    jax.jit,
    static_argnames=(
        "talker_cfg", "cp_cfg", "vocoder_cfg", "chunk_frames", "max_frames",
        "kv_capacity", "top_k", "nothink", "allow_eos", "greedy",
        "use_top_p",
    ),
)
def _start_and_vocode_jit(
    talker_params,
    cp_params,
    vocoder_params,
    tokens: jnp.ndarray,
    n_tokens: jnp.ndarray,
    speaker_embd: jnp.ndarray,
    language_id: jnp.ndarray,
    key: jax.Array,
    *,
    talker_cfg,
    cp_cfg,
    vocoder_cfg,
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
    state, prefill = decode_loop.generate_start(
        talker_params, cp_params, tokens, n_tokens, speaker_embd, language_id,
        key, talker_cfg=talker_cfg, cp_cfg=cp_cfg, chunk_frames=chunk_frames,
        max_frames=max_frames, kv_capacity=kv_capacity,
        temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty, nothink=nothink,
        allow_eos=allow_eos, greedy=greedy, use_top_p=use_top_p)
    audio = vocoder_model.vocoder_forward(
        vocoder_params, vocoder_cfg, state.codes[:chunk_frames],
        jnp.minimum(state.frame, chunk_frames))
    return audio, state, prefill
