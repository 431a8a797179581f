"""Continuous batching: refill finished serving lanes mid-flight.

The static batched loop (decode_loop._generate_batched) admits B
requests together and runs until EVERY lane hits EOS — short utterances
idle (masked) while the longest one drains, so aggregate occupancy is the
mean/max length ratio of the mix. The reference has no analog (its serving
story is one utterance at a time, src/main.cpp); production TTS serving is
a stream of unequal-length requests, which is exactly where lockstep
batching loses.

This module keeps the lockstep *step* (all lanes advance together, so one
weight read serves all lanes) but makes lane OCCUPANCY dynamic:

- One global write column ``n_past`` advances every step, shared by all
  lanes.
- When a lane finishes, a new request's fixed-length prefill window
  (models/talker.build_prefill: always 10 rows, 9 nothink — text arrives
  via the per-frame trailing schedule) is spliced into that lane's cache at
  columns [n_past - P, n_past), overwriting the previous occupant's stale
  tail. Writes stay lockstep; the splice never collides with live columns.
- Each lane carries ``start`` — its first valid cache column. Attention
  masks columns < start (stale entries from the previous occupant). RoPE
  uses absolute cache positions, and rotary attention is shift-invariant,
  so a spliced request generates EXACTLY what a fresh run at positions
  [0, P) would (tests/test_continuous.py asserts greedy-code equality).
- The host drives fixed-size frame chunks (``decode_chunk``, K frames in
  ONE dispatch — the per-dispatch cost amortizes over K*B frames) and
  refills idle lanes between chunks (``refill``, R fixed slots). Two
  compiled programs total, per (B, C, K/R, quant) config.

Capacity: a request admitted at column p may write up to max_frames
columns, so admission requires p + max_frames + K <= C. When the write
column nears C with lanes still active, ROLLING COMPACTION (``compact``)
reclaims the columns below every active lane's start — the cache rolls
down by min(active start) and the K rows are re-rotated by -shift in
place — so sessions run indefinitely instead of draining. Compaction is
pressure-only by default (compact_policy="pressure"): it exists to
reclaim admission capacity, not to speed decode — a global shift leaves
the attended window [min(active start), n_past) as deep as before. Only
when every lane idles AND capacity still blocks does the scheduler reset
the session (same compiled programs — n_past rewinds to P).
"""

from __future__ import annotations

import functools
import os as _os
import time as _time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import CodePredictorConfig, TalkerConfig
from ..models import code_predictor as cp_model
from ..models import talker as talker_model
from ..ops.attention import kernel_allowed
from ..ops.sampling import (apply_repetition_penalty, apply_suppression,
                            sample_token, sampling_flags)
from .decode_loop import _rest_embd_sum


def prefill_window_len(nothink: bool) -> int:
    """build_prefill's fixed window: 3 role rows + (3 nothink | 4) codec
    rows + speaker + pad/bos + first-text row."""
    return 9 if nothink else 10


def _host_prngkey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) built on the HOST: the jax call would create
    a device array that _do_refill fetches straight back — two device round
    trips per request. Matches threefry2x32 key data for any seed (jax
    truncates to 32 bits when x64 is off, mirrored here;
    tests/test_continuous.py asserts equality against jax.random.PRNGKey)."""
    hi = (int(seed) >> 32) & 0xFFFFFFFF if jax.config.jax_enable_x64 else 0
    return np.array([hi, int(seed) & 0xFFFFFFFF], np.uint32)


class ContinuousState(NamedTuple):
    n_past: jnp.ndarray       # scalar int32: global write column (lockstep)
    start: jnp.ndarray        # [B] int32: per-lane first valid cache column
    logits: jnp.ndarray       # [B, Vc] carried cb0 logits
    last_hidden: jnp.ndarray  # [B, H]
    kv: jnp.ndarray           # [B, L, 2, Hkv, C, D] batch-major
    seen: jnp.ndarray         # [B, Vc] bool repetition-penalty set
    frame: jnp.ndarray        # [B] int32: frames emitted by current occupant
    budget: jnp.ndarray       # [B] int32: occupant's max_audio_tokens
    samp: jnp.ndarray         # [B, 3] f32 per-occupant sampling params:
                              # (temperature, top_p, repetition_penalty)
    trailing: jnp.ndarray     # [B, Trb, H] per-occupant trailing schedule
    keys: jax.Array           # [B] per-lane PRNG keys
    done: jnp.ndarray         # [B] bool: lane idle (finished / never filled)


def init_state(
    talker_params, talker_cfg: TalkerConfig, *, lanes: int, kv_capacity: int,
    trailing_len: int, nothink: bool = False,
) -> ContinuousState:
    """All lanes idle; n_past starts at the prefill window length so the
    first refill can splice at [0, P) like every later one."""
    B = lanes
    H = talker_cfg.hidden_size
    Vc = talker_cfg.codec_vocab_size
    dtype = talker_params.codec_embd.dtype
    kv = jnp.zeros(
        (B, talker_cfg.n_layers, 2, talker_cfg.n_kv_heads, kv_capacity,
         talker_cfg.head_dim), dtype)
    P = prefill_window_len(nothink)
    return ContinuousState(
        n_past=jnp.int32(P),
        start=jnp.zeros((B,), jnp.int32),
        logits=jnp.zeros((B, Vc), jnp.float32),
        last_hidden=jnp.zeros((B, H), dtype),
        kv=kv,
        seen=jnp.zeros((B, Vc), jnp.bool_),
        frame=jnp.zeros((B,), jnp.int32),
        budget=jnp.zeros((B,), jnp.int32),
        samp=jnp.ones((B, 3), jnp.float32),
        trailing=jnp.zeros((B, trailing_len, H), dtype),
        keys=jnp.zeros((B, 2), jnp.uint32),
        done=jnp.ones((B,), jnp.bool_),
    )


@functools.partial(jax.jit, static_argnames=(
    "talker_cfg", "nothink"), donate_argnames=("state",))
def refill(
    talker_params,
    state: ContinuousState,
    lane_idx: jnp.ndarray,     # [R] int32 target lanes (ignored where ~mask)
    mask: jnp.ndarray,         # [R] bool: slot r actually refills
    tokens: jnp.ndarray,       # [R, Tb]
    n_tokens: jnp.ndarray,     # [R]
    speaker_embd: jnp.ndarray,  # [R, H]
    language_id: jnp.ndarray,  # [R]
    keys: jax.Array,           # [R] fresh per-request PRNG keys
    budgets: jnp.ndarray,      # [R] int32 per-request max_audio_tokens
    samp: jnp.ndarray,         # [R, 3] f32 per-request (temp, top_p, pen)
    *,
    talker_cfg: TalkerConfig,
    nothink: bool = False,
) -> ContinuousState:
    """Splice up to R new requests into idle lanes at the current n_past.

    Computes each slot's fixed prefill window at absolute positions
    [n_past - P, n_past) (talker_model.talker_prefill_window), scatters the
    window K/V into the lane's cache, and resets the lane's sampling state
    (each request carries its own temperature/top_p/repetition_penalty in
    `samp`). Masked slots are no-ops. R is static — one compiled program
    per R."""
    B = state.kv.shape[0]
    p = state.n_past
    P = prefill_window_len(nothink)
    pos0 = p - P
    dtype = talker_params.codec_embd.dtype

    pre = jax.vmap(
        lambda t, n, sp, lg: talker_model.build_prefill(
            talker_params, talker_cfg, t, n, sp, lg, nothink=nothink)
    )(tokens, n_tokens, speaker_embd, language_id)
    last_hidden, logits, kv_win = jax.vmap(
        lambda pe: talker_model.talker_prefill_window(
            talker_params, talker_cfg, pe, pos0, kv_dtype=state.kv.dtype)
    )(pre.prefill_embd)                     # [R,H], [R,Vc], [R,L,2,Hkv,P,D]

    R = lane_idx.shape[0]
    L, _, Hkv, C, D = state.kv.shape[1:]
    Vc = talker_cfg.codec_vocab_size

    kv = state.kv
    start = state.start
    st_logits = state.logits
    lh = state.last_hidden
    seen = state.seen
    frame = state.frame
    budget = state.budget
    st_samp = state.samp
    trailing = state.trailing
    st_keys = state.keys
    done = state.done

    for r in range(R):
        lane = lane_idx[r]
        m = mask[r]

        old = lax.dynamic_slice(
            kv, (lane, 0, 0, 0, pos0, 0), (1, L, 2, Hkv, P, D))
        new = jnp.where(m, kv_win[r][None].astype(kv.dtype), old)
        kv = lax.dynamic_update_slice(kv, new, (lane, 0, 0, 0, pos0, 0))

        def put(arr, val):
            return arr.at[lane].set(jnp.where(m, val, arr[lane]))

        start = put(start, pos0)
        lh = put(lh, last_hidden[r].astype(dtype))
        seen = put(seen, jnp.zeros((Vc,), jnp.bool_))
        frame = put(frame, jnp.int32(0))
        budget = put(budget, budgets[r])
        st_samp = put(st_samp, jnp.asarray(samp[r], jnp.float32))
        trailing = put(trailing, pre.trailing[r].astype(trailing.dtype))
        st_keys = put(st_keys, keys[r])
        done = put(done, jnp.bool_(False))
        st_logits = put(st_logits, logits[r])

    return state._replace(
        start=start, logits=st_logits, last_hidden=lh,
        kv=kv, seen=seen, frame=frame, budget=budget, samp=st_samp,
        trailing=trailing, keys=st_keys, done=done)


@functools.partial(jax.jit, static_argnames=("talker_cfg",),
                   donate_argnames=("state",))
def compact(state: ContinuousState, shift: jnp.ndarray, *,
            talker_cfg: TalkerConfig) -> ContinuousState:
    """Reclaim cache columns below every active lane's start: roll the whole
    cache down by `shift` columns, re-rotate the K rows by -shift, and
    rebase n_past/start — serving sessions then run indefinitely at bounded
    capacity instead of draining when the write column hits C.

    Exactness: attention depends only on RELATIVE positions. The cache
    stores post-RoPE K = R(pos)·k_raw; at the shifted column the row must
    read R(pos-shift)·k_raw = R(-shift)·R(pos)·k_raw — NEOX rotations
    compose per frequency pair, so one extra rotation by -shift fixes every
    K row in place (V rows are position-free). The wrapped-around tail is
    invalid by construction (cols >= n_past-shift) and idle lanes' stale
    starts clamp at 0.

    Cost: ~1.5 full-cache passes of device memory (roll + K rewrite) per
    call. The pass is layer-scanned: a whole-cache roll + f32 K
    materialization needs ~2x the cache in program temps (14 GB at
    B=64/C=1024); per-layer temps are 1/L of that and the donated cache
    updates in place."""
    from ..ops.rope import rope_angles

    kv = state.kv                      # [B, L, 2, Hkv, C, D]
    L, D = kv.shape[1], kv.shape[5]
    half = D // 2
    cos, sin = rope_angles(-jnp.asarray(shift, jnp.int32), D,
                           talker_cfg.rope_theta)      # [D/2] f32

    def body(l, kvc):
        lane = lax.dynamic_slice_in_dim(kvc, l, 1, axis=1)  # [B,1,2,Hkv,C,D]
        rolled = jnp.roll(lane, -shift, axis=4)
        k = rolled[:, :, 0].astype(jnp.float32)             # [B,1,Hkv,C,D]
        k1, k2 = k[..., :half], k[..., half:]
        k_rot = jnp.concatenate(
            [k1 * cos - k2 * sin, k1 * sin + k2 * cos],
            axis=-1).astype(kvc.dtype)
        return lax.dynamic_update_slice_in_dim(
            kvc, rolled.at[:, :, 0].set(k_rot), l, axis=1)

    return state._replace(
        kv=lax.fori_loop(0, L, body, kv),
        n_past=state.n_past - shift,
        start=jnp.maximum(state.start - shift, 0))


class ChunkResult(NamedTuple):
    state: ContinuousState
    codes: jnp.ndarray    # [B, K, 16] int32 (emitted frames; rest garbage)
    emit: jnp.ndarray     # [B, K] bool: row (b, k) is a real emission
    eos: jnp.ndarray      # [B, K] bool: lane b hit EOS at chunk step k
    host: jnp.ndarray     # [B, 16K + 2K + 1] int32: codes|emit|eos|done packed
                          # so the scheduler's per-chunk harvest is ONE
                          # device->host fetch


@functools.partial(jax.jit, static_argnames=(
    "talker_cfg", "cp_cfg", "chunk_frames", "top_k", "allow_eos", "greedy",
    "use_top_p", "attn_kernel"),
    donate_argnames=("state",))
def decode_chunk(
    talker_params,
    cp_params,
    state: ContinuousState,
    *,
    talker_cfg: TalkerConfig,
    cp_cfg: CodePredictorConfig,
    chunk_frames: int,
    top_k: int = 0,
    allow_eos: bool = True,
    greedy: bool = False,
    use_top_p: bool = True,
    attn_kernel: bool = True,
) -> ChunkResult:
    """Advance every lane K=chunk_frames steps in ONE dispatch.

    Per-iteration semantics match decode_loop._generate_batched exactly
    (same key-split order, suppression/penalty/sampler, one-hot cb0
    embedding, lockstep emission) with four continuous-batching deltas:
    per-lane `start` reaches the talker's attention mask, the trailing
    schedule comes from carried per-lane state, each
    lane samples with its occupant's own temperature/top_p/
    repetition_penalty (state.samp — greedy/use_top_p/top_k stay
    per-server statics), and a lane is additionally done when its occupant
    reaches its per-request frame budget. Idle (done) lanes keep stepping
    with masked emissions, as in the static loop.

    attn_kernel=False keeps the decode-attention kernel out of the program
    (lane state sharded over several devices)."""
    with kernel_allowed(attn_kernel):
        return _decode_chunk(talker_params, cp_params, state,
                             talker_cfg=talker_cfg, cp_cfg=cp_cfg,
                             chunk_frames=chunk_frames, top_k=top_k,
                             allow_eos=allow_eos, greedy=greedy,
                             use_top_p=use_top_p)


def _decode_chunk(talker_params, cp_params, state, *, talker_cfg, cp_cfg,
                  chunk_frames, top_k, allow_eos, greedy, use_top_p):
    B, _, _, _, C, _ = state.kv.shape
    H = talker_cfg.hidden_size
    Vc = talker_cfg.codec_vocab_size
    K = chunk_frames
    suppress_start = Vc - talker_cfg.n_suppressed_tail
    eos_for_mask = talker_cfg.codec_eos_id if allow_eos else -1
    dtype = talker_params.codec_embd.dtype
    Trb = state.trailing.shape[1]

    codes_buf = jnp.zeros((B, K, talker_cfg.n_codebooks), jnp.int32)
    emit_buf = jnp.zeros((B, K), jnp.bool_)
    eos_buf = jnp.zeros((B, K), jnp.bool_)

    def body(k, carry):
        s, codes_buf, emit_buf, eos_buf = carry
        temp_l, topp_l, pen_l = s.samp[:, 0], s.samp[:, 1], s.samp[:, 2]
        ks = jax.vmap(lambda kk: jax.random.split(kk, 3))(s.keys)
        keys_next, k_cb0, k_cp = ks[:, 0], ks[:, 1], ks[:, 2]
        l = apply_suppression(s.logits, suppress_start, eos_for_mask)
        l = apply_repetition_penalty(l, s.seen, pen_l[:, None])
        cb0 = jax.vmap(
            lambda kk, row, t, p: sample_token(
                kk, row, temperature=t, top_k=top_k,
                top_p=p, greedy=greedy, use_top_p=use_top_p)
        )(k_cb0, l, temp_l, topp_l)
        is_eos = jnp.logical_and(cb0 == talker_cfg.codec_eos_id, allow_eos)
        done = jnp.logical_or(s.done, is_eos)
        emit = ~done
        # Done lanes attend only to the current step's row (their outputs
        # are masked), so they read no stale history; active lanes' masks
        # are untouched and the next refill rewrites start.
        start_eff = jnp.where(done, s.n_past, s.start)

        onehot_cb0 = (cb0[:, None] == jnp.arange(Vc)[None, :])
        cb0_embd = lax.dot_general(
            onehot_cb0.astype(dtype), talker_params.codec_embd,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32).astype(dtype)   # [B, H]
        rest = jax.vmap(
            lambda h, ce, kk, t, p: cp_model.predict_codes(
                cp_params, cp_cfg, h, ce, kk, temperature=t,
                top_k=top_k, top_p=p, greedy=greedy,
                use_top_p=use_top_p)
        )(s.last_hidden.astype(dtype), cb0_embd, k_cp, temp_l, topp_l)
        rest_sum = _rest_embd_sum(cp_params, cp_cfg, rest)
        frame_codes = jnp.concatenate([cb0[:, None], rest], axis=1)

        codes_buf = lax.dynamic_update_slice(
            codes_buf, frame_codes[:, None, :], (0, k, 0))
        emit_buf = lax.dynamic_update_slice(
            emit_buf, emit[:, None], (0, k))
        eos_buf = lax.dynamic_update_slice(
            eos_buf, jnp.logical_and(is_eos, ~s.done)[:, None], (0, k))
        seen = s.seen | (onehot_cb0 & emit[:, None])

        t_idx = jnp.minimum(s.frame, Trb - 1)
        t_mask = (jnp.arange(Trb)[None, :] == t_idx[:, None])
        trailing_row = jnp.sum(
            jnp.where(t_mask[:, :, None], s.trailing, 0).astype(jnp.float32),
            axis=1)
        step_embd = (cb0_embd.astype(jnp.float32) + rest_sum
                     + trailing_row).astype(dtype)

        hidden, logits, kv = jax.vmap(
            lambda e, kvi, st: talker_model.talker_step(
                talker_params, talker_cfg, e, s.n_past, kvi,
                strategy="carried", start=st)
        )(step_embd, s.kv, start_eff)

        frame = s.frame + emit.astype(jnp.int32)
        done = jnp.logical_or(done, frame >= s.budget)
        s = s._replace(
            n_past=s.n_past + 1, logits=logits,
            last_hidden=hidden, kv=kv, seen=seen, frame=frame,
            keys=keys_next, done=done)
        return s, codes_buf, emit_buf, eos_buf

    s, codes_buf, emit_buf, eos_buf = lax.fori_loop(
        0, K, body, (state, codes_buf, emit_buf, eos_buf))
    host = jnp.concatenate([
        codes_buf.reshape(B, K * talker_cfg.n_codebooks),
        emit_buf.astype(jnp.int32), eos_buf.astype(jnp.int32),
        s.done.astype(jnp.int32)[:, None]], axis=1)
    return ChunkResult(state=s, codes=codes_buf, emit=emit_buf, eos=eos_buf,
                       host=host)


class _Lane(NamedTuple):
    rid: int
    codes: list


class ContinuousScheduler:
    """Host-side request scheduler over the two device programs.

    Usage:
        sched = ContinuousScheduler(tp, cp, talker_cfg, cp_cfg, lanes=64,
                                    kv_capacity=1024, text_bucket=32,
                                    max_frames=256)
        rid = sched.submit(tokens, n_tokens, speaker_embd, language_id, seed)
        results = sched.run()       # {rid: codes np[n, 16]}

    run() drives refill/decode_chunk until the queue drains; completed
    requests' codes are assembled host-side from chunk emissions (the
    vocoder consumes only codes — pipeline.vocode_batched them afterwards).

    compact_policy: "pressure" (default) compacts only when admission is
    blocked and the shift unblocks it; "opportunistic" additionally shifts
    whenever min(active start) >= compact_threshold — no decode benefit
    (the attended window depth is invariant under a global shift), kept as
    a correctness stressor.

    mesh: shard lane state over the mesh's "dp" axis (weights shard over
    "tp" via parallel/shardings.shard_params at the caller). The programs
    then leave out the decode-attention kernel, which has no partitioning
    rule.
    """

    def __init__(self, talker_params, cp_params, talker_cfg: TalkerConfig,
                 cp_cfg: CodePredictorConfig, *, lanes: int = 64,
                 kv_capacity: int = 1024, text_bucket: int = 32,
                 chunk_frames: int = 32, refill_slots: int = 8,
                 max_frames: int = 256, temperature: float = 0.9,
                 top_k: int = 50, top_p: float = 1.0,
                 repetition_penalty: float = 1.05, nothink: bool = False,
                 allow_eos: bool = True, mesh=None,
                 compact_threshold: int = 128,
                 compact_policy: str = "pressure", timing: bool = False,
                 overlap_harvest: bool | None = None,
                 admit_per_boundary: int | None = None):
        P = prefill_window_len(nothink)
        assert kv_capacity >= P + max_frames + chunk_frames, \
            "kv_capacity cannot admit even one request"
        self.tp, self.cp = talker_params, cp_params
        self.tcfg, self.ccfg = talker_cfg, cp_cfg
        self.B, self.C = lanes, kv_capacity
        self.Tb, self.K, self.R = text_bucket, chunk_frames, refill_slots
        self.max_frames = max_frames
        self.compact_threshold = int(compact_threshold)
        assert compact_policy in ("pressure", "opportunistic"), compact_policy
        self.compact_policy = compact_policy
        self.nothink, self.allow_eos = nothink, allow_eos
        # greedy/use_top_p/top_k are per-SERVER statics (compiled program
        # class, sampling.sampling_flags); temperature/top_p/
        # repetition_penalty are per-REQUEST (state.samp), defaulting to
        # the values here
        greedy, use_top_p = sampling_flags(temperature, top_p)
        self.defaults = (float(temperature), float(top_p),
                         float(repetition_penalty))
        self.mesh = mesh
        self.statics = dict(
            top_k=top_k, greedy=greedy, use_top_p=use_top_p,
            attn_kernel=not (mesh is not None and mesh.size > 1))
        self.state = self._shard_state(init_state(
            talker_params, talker_cfg, lanes=lanes, kv_capacity=kv_capacity,
            trailing_len=text_bucket - 3, nothink=nothink))
        self._queue: list[tuple] = []
        self._next_rid = 0
        self._lane_owner: list[_Lane | None] = [None] * lanes
        # Host mirrors of the device scheduling state. n_past advances
        # deterministically (+K per chunk, -shift per compact) and every
        # lane's start is set by THIS scheduler's own refill decisions, so
        # re-fetching them from the device each loop iteration would add
        # device round trips per chunk boundary. tests/test_continuous.py
        # asserts mirror==device after every run.
        self._n_past_h = P
        self._start_h = np.zeros((lanes,), np.int64)
        self._done_h = np.ones((lanes,), bool)
        self.results: dict[int, np.ndarray] = {}
        self.chunks_run = 0
        self.sessions = 0
        self.compactions = 0
        self.refills = 0
        # Overlapped harvest (default ON, QWEN3TTS_OVERLAP_HARVEST=0 or
        # overlap_harvest=False for the serial A/B): run() keeps one decode
        # chunk in flight and fetches the PREVIOUS chunk's host blob while
        # the device executes the next, so the dispatch + fetch between
        # chunks rides under device compute. Refill
        # decisions are thereby delayed one chunk (a lane that finished in
        # the in-flight chunk refills at the NEXT boundary); per-request
        # outputs are unchanged — splices are exact whenever applied
        # (tests/test_continuous.py::test_overlap_harvest_matches_serial).
        if overlap_harvest is None:
            overlap_harvest = _os.environ.get(
                "QWEN3TTS_OVERLAP_HARVEST", "1") not in ("0", "false", "off")
        self.overlap_harvest = bool(overlap_harvest)
        # Admission pacing (streaming): cap lanes admitted per loop
        # boundary so a burst of queued requests doesn't splice (and then
        # first-window vocode) all at one chunk boundary — spreading the
        # per-request first-emission work across boundaries keeps the
        # decode cadence flowing and staircases TTFA instead of delaying
        # every request behind one giant vocode set. None = admit greedily
        # (the throughput-optimal default for code-only serving).
        self.admit_per_boundary = (None if admit_per_boundary is None
                                   else int(admit_per_boundary))
        # opt-in phase decomposition: forces a device sync after every
        # program — diagnosis only, not for headline numbers
        self.timing = bool(timing)
        self.stats = {k: 0.0 for k in
                      ("refill_s", "decode_s", "compact_s", "harvest_s")}

    def _tock(self, key: str, t0: float) -> None:
        if self.timing:
            jax.block_until_ready(self.state.n_past)
            self.stats[key] += _time.perf_counter() - t0

    def submit(self, tokens, n_tokens: int, speaker_embd, language_id: int,
               seed: int = 0, max_frames: int | None = None,
               temperature: float | None = None, top_p: float | None = None,
               repetition_penalty: float | None = None) -> int:
        """Enqueue one request; tokens longer than the text bucket are
        rejected (pick the bucket for your corpus). max_frames is this
        request's frame budget (<= the scheduler's admission max).

        temperature/top_p/repetition_penalty override the scheduler
        defaults PER REQUEST (carried in state.samp; one compiled program
        serves them all). Overrides must stay within the server's compiled
        sampling class: a greedy server (default temperature<=0) takes no
        sampled overrides and vice versa; top_p<1 needs a server whose
        default already engaged the top-p stage."""
        tokens = np.asarray(tokens, np.int32)
        assert tokens.shape[0] <= self.Tb, \
            f"prompt ({tokens.shape[0]}) exceeds text bucket {self.Tb}"
        budget = self.max_frames if max_frames is None else int(max_frames)
        assert 0 < budget <= self.max_frames, \
            f"max_frames {budget} outside (0, {self.max_frames}]"
        t0, p0, r0 = self.defaults
        t = t0 if temperature is None else float(temperature)
        p = p0 if top_p is None else float(top_p)
        rp = r0 if repetition_penalty is None else float(repetition_penalty)
        assert (t <= 0.0) == self.statics["greedy"], \
            f"temperature {t} crosses this server's greedy/sampled class"
        assert p >= 1.0 or self.statics["use_top_p"] or \
            self.statics["greedy"], \
            f"top_p {p} needs a server compiled with the top-p stage"
        padded = np.zeros((self.Tb,), np.int32)
        padded[:tokens.shape[0]] = tokens
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(
            (rid, padded, int(n_tokens), np.asarray(speaker_embd),
             int(language_id), int(seed), budget, (t, p, rp)))
        return rid

    # -- internals ---------------------------------------------------------

    def _shard_state(self, state: ContinuousState) -> ContinuousState:
        """Multi-device serving: place batch-dim state on the mesh's "dp" axis
        (weights shard over "tp" via parallel/shardings.shard_params at the
        caller). lanes must divide the dp axis size."""
        if self.mesh is None:
            return state
        from jax.sharding import NamedSharding, PartitionSpec as P

        def put(x):
            if getattr(x, "ndim", 0) >= 1 and x.shape[0] == self.B:
                spec = P("dp", *([None] * (x.ndim - 1)))
            else:
                spec = P()
            return jax.device_put(x, NamedSharding(self.mesh, spec))

        return jax.tree.map(put, state)

    def _can_admit(self) -> bool:
        return self._n_past_h + self.max_frames + self.K <= self.C

    def _do_refill(self, done_np, limit: int | None = None) -> int:
        """Admit queued requests into idle (unowned) lanes: up to R per call
        normally, or all B lanes in ONE bulk dispatch when more than R lanes
        are idle and queued work covers them (instead of ceil(B/R)
        sequential dispatches). refill() is shape-jitted, so the bulk
        variant is just a second compiled program (R=B). Returns the number
        admitted; `limit` caps it (admission pacing)."""
        idle = [b for b in range(self.B)
                if self._lane_owner[b] is None and bool(done_np[b])]
        n = min(len(idle), len(self._queue))
        if limit is not None:
            n = min(n, limit)
        R_eff = self.B if n > self.R else self.R
        n = min(n, R_eff)
        if n == 0 or not self._can_admit():
            return 0
        lane_idx = np.zeros((R_eff,), np.int32)
        mask = np.zeros((R_eff,), bool)
        tokens = np.zeros((R_eff, self.Tb), np.int32)
        n_tok = np.full((R_eff,), 10, np.int32)
        spk = np.zeros((R_eff, self.tcfg.hidden_size), np.float32)
        lang = np.zeros((R_eff,), np.int32)
        keys = np.zeros((R_eff, 2), np.uint32)
        budgets = np.ones((R_eff,), np.int32)
        samp = np.ones((R_eff, 3), np.float32)
        for r in range(n):
            rid, t, nt, sp, lg, seed, budget, samp_r = self._queue.pop(0)
            lane = idle[r]
            lane_idx[r] = lane
            mask[r] = True
            tokens[r], n_tok[r], spk[r], lang[r] = t, nt, sp, lg
            keys[r] = _host_prngkey(seed)
            budgets[r] = budget
            samp[r] = samp_r
            self._lane_owner[lane] = _Lane(rid=rid, codes=[])
            # refill() splices this lane at [n_past - P, n_past)
            self._start_h[lane] = self._n_past_h - prefill_window_len(
                self.nothink)
            self._done_h[lane] = False
        dtype = self.tp.codec_embd.dtype
        t0 = _time.perf_counter()
        self.state = refill(
            self.tp, self.state, jnp.asarray(lane_idx), jnp.asarray(mask),
            jnp.asarray(tokens), jnp.asarray(n_tok),
            jnp.asarray(spk, dtype), jnp.asarray(lang),
            jnp.asarray(keys), jnp.asarray(budgets), jnp.asarray(samp),
            talker_cfg=self.tcfg, nothink=self.nothink)
        self.refills += 1
        self._tock("refill_s", t0)
        return n

    def _harvest(self, res: ChunkResult, on_chunk=None, owners=None):
        """Fold one chunk's emissions into its lanes' request buffers.

        `owners`, if given, is the _lane_owner snapshot taken when the
        chunk was DISPATCHED (the overlapped loop refills lanes while a
        chunk is still in flight — attributing a stale chunk's latched
        done flags to a lane's NEW occupant would zero-finalize it).
        A lane whose snapshot owner is already finalized (rid in results)
        only carries masked emissions + a latched done bit; it is skipped."""
        # ONE packed fetch (codes|emit|eos|done)
        blob = np.asarray(res.host)
        if owners is None:
            owners = self._lane_owner
        K, nc = self.K, self.tcfg.n_codebooks
        codes = blob[:, :K * nc].reshape(self.B, K, nc)
        emit = blob[:, K * nc:K * nc + K].astype(bool)
        done_np = blob[:, -1].astype(bool)
        self._done_h = done_np
        events = []
        for b in range(self.B):
            owner = owners[b]
            if owner is None or owner.rid in self.results:
                continue
            rows = codes[b][emit[b]]
            if rows.size:
                owner.codes.append(rows)
            finished = bool(done_np[b])
            if rows.size or finished:
                events.append((owner.rid, rows, finished))
            if finished:
                self.results[owner.rid] = (
                    np.concatenate(owner.codes, axis=0) if owner.codes
                    else np.zeros((0, self.tcfg.n_codebooks), np.int32))
                if self._lane_owner[b] is owner:
                    self._lane_owner[b] = None
        if on_chunk is not None and events:
            on_chunk(events)
        return done_np

    def _reset_session(self):
        """Capacity reached and all lanes idle: rewind the write column.
        Same compiled programs — only state values change."""
        assert all(o is None for o in self._lane_owner)
        self.state = None   # free the old cache BEFORE allocating the new
        self.state = self._shard_state(init_state(
            self.tp, self.tcfg, lanes=self.B, kv_capacity=self.C,
            trailing_len=self.Tb - 3, nothink=self.nothink))
        self._n_past_h = prefill_window_len(self.nothink)
        self._start_h[:] = 0
        self._done_h[:] = True
        self.sessions += 1

    def _try_compact(self, opportunistic: bool = False) -> bool:
        """Reclaim the columns below every ACTIVE lane's start
        (runtime/continuous.compact). The PRESSURE trigger (default policy)
        fires only when admission is blocked and the shift is large enough
        to unblock it — compaction exists solely to reclaim ADMISSION
        capacity. A global shift cannot make decode steps cheaper: the
        attended window [min(active start), n_past) keeps its depth under a
        rigid shift. compact_policy="opportunistic" (shift >=
        compact_threshold at any boundary) is kept as a correctness
        stressor: tests/test_continuous.py drives compaction mid-request at
        threshold 4. Idle lanes don't constrain the shift (their stale
        windows are dead; decode_chunk masks them out too)."""
        active_starts = [int(self._start_h[b]) for b in range(self.B)
                         if self._lane_owner[b] is not None]
        if not active_starts:
            return False
        smin = min(active_starts)
        if opportunistic:
            needed = self.compact_threshold
        else:
            needed = self._n_past_h + self.max_frames + self.K - self.C
        if smin <= 0 or smin < needed:
            return False
        t0 = _time.perf_counter()
        self.state = compact(self.state, jnp.int32(smin),
                             talker_cfg=self.tcfg)
        self._n_past_h -= smin
        np.maximum(self._start_h - smin, 0, out=self._start_h)
        self.compactions += 1
        self._tock("compact_s", t0)
        return True

    def check_host_mirrors(self) -> None:
        """Test hook: assert the host scheduling mirrors equal the device
        state. A drifted n_past/start mirror would compact beyond a live
        lane's splice point and corrupt its history, so the continuous
        tests call this after every run."""
        assert self._n_past_h == int(np.asarray(self.state.n_past)), \
            (self._n_past_h, int(np.asarray(self.state.n_past)))
        np.testing.assert_array_equal(
            self._start_h, np.asarray(self.state.start).astype(np.int64))
        np.testing.assert_array_equal(
            self._done_h, np.asarray(self.state.done))

    def run(self, max_chunks: int | None = None,
            on_chunk=None, feeder=None) -> dict[int, np.ndarray]:
        """Drive the scheduler until the queue drains and all lanes finish.
        Returns {rid: codes [n_frames, 16]} for every completed request.

        on_chunk, if given, is called after every decode chunk with a list
        of (rid, new_codes [k, 16], finished) events — the codes-streaming
        hook (pipeline.synthesize_queue turns it into chunked audio via the
        vocoder). Per-request latency is then ~one chunk wall instead of
        completion wall.

        feeder, if given, models ONLINE ARRIVALS (tools/benchmark_arrivals):
        called as feeder(idle: bool) at every loop boundary; it submits any
        requests whose arrival time has come (self.submit) and returns True
        while arrivals are still pending, which keeps the loop alive when
        the queue and lanes are momentarily empty. When `idle` is True
        nothing is running — a real-time feeder should block until its next
        arrival instead of busy-spinning.

        With overlap_harvest (the default) one chunk stays in flight: the
        previous chunk's host blob is fetched while the device executes the
        next, and refill decisions run one chunk behind (per-request codes
        unchanged). overlap_harvest=False is the serial A/B reference."""
        if self.overlap_harvest:
            return self._run_overlapped(max_chunks, on_chunk, feeder)
        return self._run_serial(max_chunks, on_chunk, feeder)

    def _run_serial(self, max_chunks, on_chunk, feeder) -> dict[int, np.ndarray]:
        done_np = self._done_h
        while True:
            active = any(o is not None for o in self._lane_owner)
            if feeder is not None:
                pending = feeder(not active and not self._queue)
                if not self._queue and not active:
                    if not pending:
                        break
                    continue
            elif not self._queue and not active:
                break
            if self._queue and not self._can_admit():
                if not active:
                    self._reset_session()
                    done_np = self._done_h
                else:
                    # pressure compaction must reclaim enough to admit; a
                    # partial (threshold) shift is pointless here — admission
                    # unblocks on the same event either way (the oldest
                    # active lane finishing), and each call costs a
                    # full-cache pass
                    if not self._try_compact() and \
                            self.compact_policy == "opportunistic":
                        self._try_compact(opportunistic=True)
            elif active and self.compact_policy == "opportunistic":
                self._try_compact(opportunistic=True)
            # refill until lanes are full, the queue drains, or capacity
            # blocks: one call admits at most R requests, and a chunk can
            # finish far more than R lanes — a single call per boundary
            # leaves most lanes idle
            cap = self.admit_per_boundary
            admitted = 0
            while cap is None or admitted < cap:
                got = self._do_refill(
                    done_np, None if cap is None else cap - admitted)
                if not got:
                    break
                admitted += got
            if not any(o is not None for o in self._lane_owner):
                # queue present but nothing admitted (capacity): drain path
                # above will reset next loop
                continue
            t0 = _time.perf_counter()
            res = decode_chunk(
                self.tp, self.cp, self.state, talker_cfg=self.tcfg,
                cp_cfg=self.ccfg, chunk_frames=self.K,
                allow_eos=self.allow_eos, **self.statics)
            self.state = res.state
            self._n_past_h += self.K
            self.chunks_run += 1
            self._tock("decode_s", t0)
            t0 = _time.perf_counter()
            done_np = self._harvest(res, on_chunk)
            self._tock("harvest_s", t0)
            if max_chunks is not None and self.chunks_run >= max_chunks:
                break
        return self.results

    def _run_overlapped(self, max_chunks, on_chunk, feeder) -> dict[int, np.ndarray]:
        """run() with one chunk in flight.

        Enqueue order on the device per boundary: [refill*, compact?,
        decode_chunk N] — then the host fetches chunk N-1's packed blob
        while the device executes N. Refill decisions therefore see the
        done/idle picture as of chunk N-1 (one chunk stale); a lane that
        finishes inside the in-flight chunk refills one boundary later.
        Exactness is untouched (the splice is exact at whatever column it
        lands, rotary shift invariance), only occupancy timing moves — and
        the serialized ~fetch+decision gap between chunks drops out of the
        wall. The `timing` diagnostic mode forces per-program syncs and so
        measures the serial phases, not the overlapped wall."""
        pending = None      # (ChunkResult, owner snapshot) in flight
        done_np = self._done_h
        while True:
            active = any(o is not None for o in self._lane_owner)
            idle = not active and not self._queue and pending is None
            if feeder is not None:
                arrivals_pending = feeder(idle)
                if not self._queue and not active:
                    if pending is not None:
                        done_np = self._harvest(pending[0], on_chunk, pending[1])
                        pending = None
                        continue
                    if not arrivals_pending:
                        break
                    continue
            elif not self._queue and not active:
                if pending is not None:
                    done_np = self._harvest(pending[0], on_chunk, pending[1])
                    pending = None
                    continue
                break
            if self._queue and not self._can_admit():
                if pending is not None:
                    # drain the in-flight chunk before reset/compaction
                    # decisions: both need fresh owner/done mirrors
                    done_np = self._harvest(pending[0], on_chunk, pending[1])
                    pending = None
                    continue
                if not active:
                    self._reset_session()
                    done_np = self._done_h
                else:
                    if not self._try_compact() and \
                            self.compact_policy == "opportunistic":
                        self._try_compact(opportunistic=True)
            elif active and self.compact_policy == "opportunistic":
                self._try_compact(opportunistic=True)
            cap = self.admit_per_boundary
            admitted = 0
            while cap is None or admitted < cap:
                got = self._do_refill(
                    done_np, None if cap is None else cap - admitted)
                if not got:
                    break
                admitted += got
            if not any(o is not None for o in self._lane_owner):
                if pending is not None:
                    done_np = self._harvest(pending[0], on_chunk, pending[1])
                    pending = None
                continue
            t0 = _time.perf_counter()
            res = decode_chunk(
                self.tp, self.cp, self.state, talker_cfg=self.tcfg,
                cp_cfg=self.ccfg, chunk_frames=self.K,
                allow_eos=self.allow_eos, **self.statics)
            self.state = res.state
            self._n_past_h += self.K
            self.chunks_run += 1
            self._tock("decode_s", t0)
            snapshot = list(self._lane_owner)
            if pending is not None:
                t0 = _time.perf_counter()
                done_np = self._harvest(pending[0], on_chunk, pending[1])
                self._tock("harvest_s", t0)
            pending = (res, snapshot)
            if max_chunks is not None and self.chunks_run >= max_chunks:
                break
        if pending is not None:
            self._harvest(pending[0], on_chunk, pending[1])
        return self.results
