"""Qwen3TTS pipeline orchestrator (reference component #2, SURVEY.md §2).

Mirrors the reference API surface (src/qwen3_tts.h:82-143):
``load_models`` / ``synthesize`` / ``synthesize_with_voice`` /
``set_progress_callback``, plus the lifecycle policies:

- speaker encoder loads lazily on the first voice-cloning request
  (qwen3_tts.cpp:244-260)
- QWEN3_TTS_LOW_MEM=1 drops the talker after generation and the vocoder
  after decode, reloading on the next call (qwen3_tts.cpp:126-131,332-407)
- basic synthesis uses a zero speaker embedding (qwen3_tts.cpp:204-208)
- per-stage wall times + RSS snapshots in the result (qwen3_tts.cpp:414-439)

Differences from the reference: every stage is a jitted program compiled
per shape bucket; ``warmup()`` pre-compiles the serving buckets; and with no checkpoint
available the pipeline can self-initialize deterministic synthetic weights at
the exact configured shapes (``load_models(synthetic=True)``) so the whole
system is exercisable anywhere.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from .audio import mel as mel_mod
from .audio.wav import load_wav, resample_linear, save_wav  # noqa: F401 (re-export)
from .config import PipelineConfig, SamplingConfig
from .io import loader as loader_mod
from .models import code_predictor as cp_model
from .models import speaker_encoder as se_model
from .models import talker as talker_model
from .models import vocoder as vocoder_model
from .runtime import decode_loop
from .runtime.buckets import pick_bucket
from .runtime.timing import StageTimings, now_ms, rss_bytes
from .text.bpe import TextTokenizer, synthetic_tokenizer

import functools

# Fixed default location of the persistent compilation cache: the path is
# part of the cache key, so a directory that moves never hits.
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory:
    $JAX_COMPILATION_CACHE_DIR when set, otherwise <repo>/.jax_cache. Every
    entry point (CLI, library load_models, bench.py, chip_smoke.py, tools/)
    calls this and sets no other path."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_COMPILE_CACHE
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


# one batched vocoder dispatch holds at most this many lanes: the conv
# stack's activations scale with B x frames, so groups bound the program's
# memory while keeping the dispatch count at B/16 instead of B.
# QWEN3TTS_VOCODE_LANES overrides (read at import time).
_VOCODE_MAX_LANES = int(os.environ.get("QWEN3TTS_VOCODE_LANES", "16"))


def _vocode_precision() -> str:
    """Matmul precision for the batched vocoder — TRACE-time gate.

    float32 by default: Snake amplifies reduced-precision rounding, so a
    batched program at default precision diverges from the unbatched one
    (corr 0.99 / max|d| 1.6 on synthetic weights). On the GPU "float32"
    also rules out TF32. Override with QWEN3TTS_VOCODE_PRECISION={float32,
    BF16_BF16_F32_X3, default} (tools/ab_vocode_precision.py measures
    quality against the f32 truth and wall time). 'bfloat16_3x' is accepted
    as an alias for BF16_BF16_F32_X3 (the name JAX's precision parser
    takes)."""
    p = os.environ.get("QWEN3TTS_VOCODE_PRECISION", "float32")
    return "BF16_BF16_F32_X3" if p == "bfloat16_3x" else p


# Lane mapping for the batched vocoder: "laxmap" (default) runs the
# UNBATCHED per-lane program sequentially inside ONE dispatch via
# jax.lax.map, which makes batched output BIT-EXACT with single-stream
# vocoding (same compiled body per lane). "vmap" batches the lanes.
_VOCODE_MAP = os.environ.get("QWEN3TTS_VOCODE_MAP", "laxmap")

# Fetch the batched waveform as device-side int16 PCM instead of f32: half
# the device->host bytes, and the WAV writer quantizes to PCM16 anyway, so
# the 3e-5 roundtrip error never reaches the user. QWEN3TTS_FETCH_PCM16=0
# restores f32 fetches.
_FETCH_PCM16 = os.environ.get("QWEN3TTS_FETCH_PCM16", "1") not in (
    "0", "false", "off")


@functools.partial(jax.jit, static_argnames=("cfg", "pcm16"))
def _vocode_batch(vparams, cfg, codes, n_frames, pcm16=False):
    """Batched vocoder over a shared frame bucket: codes [G, Fb, 16],
    n_frames [G] -> audio [G, Fb * samples_per_frame] (f32, or int16 PCM
    when pcm16 — halves the host-fetch bytes)."""
    with jax.default_matmul_precision(_vocode_precision()):
        if _VOCODE_MAP == "laxmap":
            audio = jax.lax.map(
                lambda cn: vocoder_model.vocoder_forward(
                    vparams, cfg, cn[0], cn[1][0]),
                (codes, n_frames[:, None]))
        else:
            audio = jax.vmap(
                lambda c, n: vocoder_model.vocoder_forward(vparams, cfg, c, n)
            )(codes, n_frames)
    if pcm16:
        audio = jnp.clip(audio * 32767.0, -32768.0, 32767.0).astype(jnp.int16)
    return audio


def _fetch_audio(dev_audio) -> np.ndarray:
    """Device audio -> host f32 (dequantizing the PCM16 fetch tier)."""
    host = np.asarray(dev_audio)
    if host.dtype == np.int16:
        return host.astype(np.float32) / 32767.0
    return host


def vocode_batched_groups(vparams, cfg, codes, n_frames):
    """Batch vocode in <=_VOCODE_MAX_LANES-lane dispatches, yielding
    (g0, g1, host_audio[g1-g0]) per group. ALL groups are dispatched before
    the first fetch, so group g's device->host transfer rides under group
    g+1..n's compute — and streaming consumers
    (synthesize_queue's on_audio) can emit group g's chunks while later
    groups still run instead of waiting for the whole set."""
    B = codes.shape[0]
    bounds, devs = [], []
    for g0 in range(0, B, _VOCODE_MAX_LANES):
        g1 = min(B, g0 + _VOCODE_MAX_LANES)
        # pad the tail group to the full lane count so one program serves
        # every group (compile once per bucket)
        if g1 - g0 < _VOCODE_MAX_LANES and B > _VOCODE_MAX_LANES:
            pad = _VOCODE_MAX_LANES - (g1 - g0)
            c = jnp.concatenate(
                [codes[g0:g1], jnp.zeros((pad,) + codes.shape[1:], codes.dtype)])
            n = jnp.concatenate(
                [n_frames[g0:g1], jnp.ones((pad,), n_frames.dtype)])
        else:
            c, n = codes[g0:g1], n_frames[g0:g1]
        bounds.append((g0, g1))
        devs.append(_vocode_batch(vparams, cfg, c, n, pcm16=_FETCH_PCM16))
    for (g0, g1), dev in zip(bounds, devs):
        yield g0, g1, _fetch_audio(dev)[: g1 - g0]


def vocode_batched(vparams, cfg, codes, n_frames):
    """Batch vocode (the serving path: B lanes -> ceil(B/16) dispatches,
    fetch overlapped with later groups' compute; codes [B, Fb, 16])."""
    outs = [a for _, _, a in vocode_batched_groups(vparams, cfg, codes, n_frames)]
    return np.concatenate(outs) if len(outs) > 1 else outs[0]


# Language name/code -> codec language id (reference src/main.cpp:104-113).
LANGUAGE_IDS = {
    "en": 2050, "english": 2050,
    "de": 2053, "german": 2053,
    "es": 2054, "spanish": 2054,
    "zh": 2055, "chinese": 2055,
    "ja": 2058, "japanese": 2058,
    "fr": 2061, "french": 2061,
    "ko": 2064, "korean": 2064,
    "ru": 2069, "russian": 2069,
    "it": 2070, "italian": 2070,
    "pt": 2071, "portuguese": 2071,
}


@dataclasses.dataclass
class TTSResult:
    audio: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.float32))
    sample_rate: int = 24000
    codes: Optional[np.ndarray] = None
    # per-frame output-normed talker hidden states [n_frames, H]
    # (golden-fixture parity: reference det_hidden_states.bin)
    hidden_states: Optional[np.ndarray] = None
    n_frames: int = 0
    success: bool = False
    error_msg: str = ""
    timings: StageTimings = dataclasses.field(default_factory=StageTimings)

    @property
    def audio_seconds(self) -> float:
        return len(self.audio) / self.sample_rate if self.sample_rate else 0.0


class Qwen3TTS:
    """End-to-end text -> 24 kHz waveform pipeline."""

    def __init__(self, config: Optional[PipelineConfig] = None):
        self.config = config or PipelineConfig()
        self.dtype = jnp.bfloat16 if self.config.runtime.dtype == "bfloat16" else jnp.float32
        self.tokenizer: Optional[TextTokenizer] = None
        self.talker_params = None
        self.cp_params = None
        self.vocoder_params = None
        self.speaker_params = None
        self._mel_fb = None
        self._mel_win = None
        self._loaded = False
        self._model_dir: Optional[str] = None
        self._synthetic_seed: Optional[int] = None
        self.low_mem = bool(os.environ.get("QWEN3_TTS_LOW_MEM", "").strip("0"))
        self.progress_callback: Optional[Callable[[int, int], None]] = None
        self.error_msg = ""

    @classmethod
    def from_pretrained(cls, model_dir: str, runtime=None) -> "Qwen3TTS":
        """Construct with hyperparameters read from the checkpoint's
        config.json files (defaults fill gaps) and load the weights."""
        from .io.config_io import config_from_model_dir

        tts = cls(config_from_model_dir(model_dir, runtime))
        if not tts.load_models(model_dir):
            raise RuntimeError(tts.error_msg)
        return tts

    # ------------------------------------------------------------------
    # model lifecycle
    # ------------------------------------------------------------------

    def load_models(self, model_dir: Optional[str] = None, *, synthetic: bool = False,
                    seed: int = 0) -> bool:
        """Load weights from an HF checkpoint directory (containing the
        Qwen3-TTS-12Hz-0.6B-Base and Qwen3-TTS-Tokenizer-12Hz subdirs or their
        safetensors directly), or deterministic synthetic weights."""
        t0 = now_ms()
        enable_compile_cache()
        self._model_dir = model_dir
        self._synthetic_seed = seed if (synthetic or model_dir is None) else None
        try:
            self._load_tokenizer()
            self._load_talker()
            if not self.low_mem:
                self._load_vocoder()
            self._loaded = True
        except Exception as e:  # noqa: BLE001 - surface as error string like the reference
            self.error_msg = f"Failed to load models: {e}"
            return False
        self._t_load_ms = now_ms() - t0
        return True

    def _paths(self):
        d = self._model_dir
        tts_dir, tok_dir = None, None
        if d:
            for name in sorted(os.listdir(d)):
                sub = os.path.join(d, name)
                if not os.path.isdir(sub):
                    continue
                low = name.lower()
                if "tokenizer" in low:
                    tok_dir = sub
                elif "tts" in low or "base" in low:
                    tts_dir = sub
            if tts_dir is None and any(f.endswith(".safetensors") for f in os.listdir(d)):
                tts_dir = d
        return tts_dir, tok_dir

    def _gguf_paths(self):
        """Reference on-disk convention: <dir>/qwen3-tts-0.6b-f16.gguf +
        <dir>/qwen3-tts-tokenizer-f16.gguf (qwen3_tts.cpp:118-119)."""
        if not self._model_dir:
            return None, None
        from .io.gguf_checkpoint import find_gguf_models
        return find_gguf_models(self._model_dir)

    def _open_tts_checkpoint(self):
        tts_dir, _ = self._paths()
        if tts_dir is not None:
            return loader_mod.open_checkpoint_dir(tts_dir)
        tts_gguf, _ = self._gguf_paths()
        if tts_gguf is not None:
            from .io.gguf_checkpoint import GGUFCheckpoint
            return GGUFCheckpoint(tts_gguf)
        raise FileNotFoundError(f"no TTS checkpoint (safetensors or gguf) under {self._model_dir}")

    def _open_vocoder_checkpoint(self):
        _, tok_dir = self._paths()
        if tok_dir is not None:
            return loader_mod.open_checkpoint_dir(tok_dir)
        _, tok_gguf = self._gguf_paths()
        if tok_gguf is not None:
            from .io.gguf_checkpoint import GGUFCheckpoint
            return GGUFCheckpoint(tok_gguf)
        raise FileNotFoundError(f"no tokenizer/vocoder checkpoint under {self._model_dir}")

    def _load_tokenizer(self):
        tts_dir, _ = self._paths()
        if self._synthetic_seed is not None:
            self.tokenizer = synthetic_tokenizer(self.config.talker.text_vocab_size)
        elif tts_dir is not None:
            self.tokenizer = TextTokenizer.from_hf_dir(tts_dir)
        else:
            tts_gguf, _ = self._gguf_paths()
            if tts_gguf is None:
                self.tokenizer = synthetic_tokenizer(self.config.talker.text_vocab_size)
            else:
                from .io.gguf import GGUFReader
                try:
                    self.tokenizer = TextTokenizer.from_gguf(GGUFReader(tts_gguf))
                except ValueError:
                    import sys
                    print("warning: GGUF file carries no tokenizer vocab; "
                          "using the embedded synthetic tokenizer", file=sys.stderr)
                    self.tokenizer = synthetic_tokenizer(self.config.talker.text_vocab_size)

    def _load_talker(self):
        cfg = self.config
        if self._synthetic_seed is not None:
            key = jax.random.PRNGKey(self._synthetic_seed)
            k1, k2 = jax.random.split(key)
            self.talker_params = talker_model.init_talker_params(k1, cfg.talker, self.dtype)
            self.cp_params = cp_model.init_code_predictor_params(k2, cfg.code_predictor, self.dtype)
        else:
            st = self._open_tts_checkpoint()
            self.talker_params = loader_mod.load_talker(st, cfg.talker, self.dtype)
            self.cp_params = loader_mod.load_code_predictor(st, cfg.code_predictor, self.dtype)
        if cfg.runtime.quant in ("int8", "q4", "q4pure"):
            # Serving tiers (ops/quant.quantize_talker_blocks): "int8" Q8_0-
            # parity; "q4" the MIXED attn-int8/ffn-u4 4-bit default (beats the
            # reference's own Q4_K storage quality — 0.9748 vs 0.9238 prefill-
            # logits cosine on identical weights); "q4pure" all-u4. The code
            # predictor is int8 in every tier.
            from .ops.quant import quantize_block_params, quantize_talker_blocks
            self.talker_params = self.talker_params._replace(
                blocks=quantize_talker_blocks(
                    self.talker_params.blocks, cfg.runtime.quant))
            self.cp_params = self.cp_params._replace(
                blocks=quantize_block_params(self.cp_params.blocks))

    def _load_vocoder(self):
        cfg = self.config
        if self._synthetic_seed is not None:
            self.vocoder_params = vocoder_model.init_vocoder_params(
                jax.random.PRNGKey(self._synthetic_seed + 1), cfg.vocoder, jnp.float32)
        else:
            from .io.config_io import infer_vocoder_config
            st = self._open_vocoder_checkpoint()
            vcfg = infer_vocoder_config(st, cfg.vocoder)
            if vcfg != cfg.vocoder:
                self.config = dataclasses.replace(self.config, vocoder=vcfg)
            self.vocoder_params = loader_mod.load_vocoder(st, vcfg, jnp.float32)

    def _load_speaker_encoder(self):
        cfg = self.config
        if self._synthetic_seed is not None:
            self.speaker_params = se_model.init_speaker_encoder_params(
                jax.random.PRNGKey(self._synthetic_seed + 2), cfg.speaker_encoder, jnp.float32)
        else:
            from .io.config_io import infer_speaker_config
            st = self._open_tts_checkpoint()
            scfg = infer_speaker_config(st, cfg.speaker_encoder)
            if scfg != cfg.speaker_encoder:
                self.config = dataclasses.replace(self.config, speaker_encoder=scfg)
            self.speaker_params = loader_mod.load_speaker_encoder(st, scfg, jnp.float32)
        self._mel_fb = jnp.asarray(mel_mod.slaney_mel_filterbank(cfg.speaker_encoder))
        self._mel_win = jnp.asarray(mel_mod.centered_hann(cfg.speaker_encoder))

    def unload_models(self):
        self.talker_params = self.cp_params = None
        self.vocoder_params = self.speaker_params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded

    def set_progress_callback(self, cb: Optional[Callable[[int, int], None]]):
        self.progress_callback = cb

    # ------------------------------------------------------------------
    # synthesis
    # ------------------------------------------------------------------

    def _fit_tokens(self, tokens):
        """Pad token ids into a prefill bucket; truncate (with a warning) if
        the text exceeds the largest configured bucket, preserving the
        template suffix (the last 5 ids close the chat template)."""
        import sys
        rt = self.config.runtime
        max_b = max(rt.prefill_buckets)
        if len(tokens) > max_b:
            print(f"warning: text of {len(tokens)} tokens exceeds the largest "
                  f"prefill bucket ({max_b}); truncating", file=sys.stderr)
            tokens = list(tokens[: max_b - 5]) + list(tokens[-5:])
        Tb = pick_bucket(len(tokens), rt.prefill_buckets)
        padded = np.zeros((Tb,), np.int32)
        padded[: len(tokens)] = tokens
        return padded, len(tokens)

    def synthesize(self, text: str, params: SamplingConfig = SamplingConfig()) -> TTSResult:
        """Basic synthesis with the model's default voice (zero x-vector)."""
        speaker = np.zeros((self.config.talker.hidden_size,), np.float32)
        return self._synthesize_internal(text, speaker, params, t_encode_ms=0.0)

    def synthesize_with_voice(
        self,
        text: str,
        reference_audio: Union[str, np.ndarray],
        params: SamplingConfig = SamplingConfig(),
        reference_sample_rate: Optional[int] = None,
    ) -> TTSResult:
        """Voice cloning from a reference waveform (path or samples)."""
        result = TTSResult()
        if not self._loaded:
            result.error_msg = "Models not loaded"
            return result
        if isinstance(reference_audio, str):
            samples, sr = load_wav(reference_audio)
        else:
            samples = np.asarray(reference_audio, np.float32)
            sr = reference_sample_rate or self.config.speaker_encoder.sample_rate
        if sr != self.config.speaker_encoder.sample_rate:
            samples = resample_linear(samples, sr, self.config.speaker_encoder.sample_rate)

        t0 = now_ms()
        speaker = self.extract_speaker_embedding(samples)
        t_encode = now_ms() - t0
        return self._synthesize_internal(text, speaker, params, t_encode_ms=t_encode)

    def extract_speaker_embedding(self, samples: np.ndarray) -> np.ndarray:
        """ECAPA-TDNN x-vector from 24 kHz samples (jitted, bucketed)."""
        if self.speaker_params is None:
            self._load_speaker_encoder()
        cfg = self.config.speaker_encoder
        Sb = pick_bucket(len(samples), self.config.runtime.speaker_buckets)
        if len(samples) > Sb:
            import sys
            print(f"warning: reference audio of {len(samples) / cfg.sample_rate:.1f}s "
                  f"exceeds the largest speaker bucket "
                  f"({Sb / cfg.sample_rate:.0f}s); truncating", file=sys.stderr)
        buf = np.zeros((Sb,), np.float32)
        buf[: min(len(samples), Sb)] = samples[:Sb]
        emb = _speaker_embed_jit(
            self.speaker_params, cfg, jnp.asarray(buf),
            jnp.int32(min(len(samples), Sb)), self._mel_fb, self._mel_win)
        return np.asarray(emb)

    def _synthesize_internal(self, text: str, speaker: np.ndarray,
                             params: SamplingConfig, t_encode_ms: float) -> TTSResult:
        result = TTSResult()
        result.timings.t_encode_ms = t_encode_ms
        result.timings.mem_rss_start = rss_bytes()
        t_total0 = now_ms()

        if not self._loaded:
            result.error_msg = "Models not loaded"
            return result

        rt = self.config.runtime
        tcfg, ccfg = self.config.talker, self.config.code_predictor

        # 1. tokenize
        t0 = now_ms()
        tokens = self.tokenizer.encode_for_tts(text)
        result.timings.t_tokenize_ms = now_ms() - t0
        if len(tokens) < 9:  # chat template (8) + at least one text token
            result.error_msg = "Text produced no tokens"
            return result

        # 2. generate codes (fused on-device loop)
        if self.talker_params is None:
            self._load_talker()
        t0 = now_ms()
        padded, n_tok = self._fit_tokens(tokens)
        max_frames = pick_bucket(params.max_audio_tokens, rt.frame_buckets)
        # round capacity up to a multiple of 256 rows
        kv_capacity = -(-(10 + max_frames + rt.kv_margin) // 256) * 256

        progress_cb = None
        if self.progress_callback is not None:
            user_cb = self.progress_callback
            total = params.max_audio_tokens

            def progress_cb(frame):  # noqa: ANN001
                user_cb(int(frame), total)

        fused_audio = None
        use_fused_dispatch = (rt.fused_dispatch and progress_cb is None
                              and not self.low_mem)
        if use_fused_dispatch:
            # one jitted program: frame loop + vocoder over the full bucket
            # (runtime/e2e.py) — one device round trip end-to-end
            from .runtime.e2e import generate_and_vocode

            if self.vocoder_params is None:
                self._load_vocoder()
            fused_audio, gen = generate_and_vocode(
                self.talker_params, self.cp_params, self.vocoder_params,
                jnp.asarray(padded), jnp.int32(n_tok),
                jnp.asarray(speaker, jnp.float32), jnp.int32(params.language_id),
                jax.random.PRNGKey(params.seed),
                talker_cfg=tcfg, cp_cfg=ccfg, vocoder_cfg=self.config.vocoder,
                max_frames=max_frames, kv_capacity=kv_capacity,
                temperature=params.temperature, top_k=params.top_k,
                top_p=params.top_p,
                repetition_penalty=params.repetition_penalty,
                nothink=params.language_id < 0,
                pcm16=_FETCH_PCM16,
            )
        else:
            gen = decode_loop.generate_from_tokens(
                self.talker_params, self.cp_params,
                jnp.asarray(padded), jnp.int32(n_tok),
                jnp.asarray(speaker, jnp.float32), jnp.int32(params.language_id),
                jax.random.PRNGKey(params.seed),
                talker_cfg=tcfg, cp_cfg=ccfg,
                max_frames=max_frames, kv_capacity=kv_capacity,
                temperature=params.temperature, top_k=params.top_k, top_p=params.top_p,
                repetition_penalty=params.repetition_penalty,
                nothink=params.language_id < 0,
                progress_cb=progress_cb,
            )
        n_frames = int(gen.n_frames)
        n_frames = min(n_frames, params.max_audio_tokens)
        # fetch the FULL buckets and slice on the host: a device-side [:n]
        # slice lowers a fresh program per distinct n
        codes = np.asarray(gen.codes)[:n_frames]
        result.timings.t_generate_ms = now_ms() - t0
        result.codes = codes
        result.hidden_states = np.asarray(gen.hidden)[:n_frames].astype(
            np.float32)
        result.n_frames = n_frames
        if n_frames == 0:
            result.error_msg = "No speech codes generated"
            return result

        if self.low_mem:
            self.talker_params = self.cp_params = None

        # 3. vocoder decode
        # NB: with fused_dispatch the vocoder already ran INSIDE the
        # generation dispatch, so t_generate_ms above absorbs the vocoder
        # time and t_decode_ms only measures the host-side slice below —
        # read t_generate_ms as the combined device wall in that mode.
        t0 = now_ms()
        if fused_audio is not None:
            spf = self.config.vocoder.samples_per_frame
            audio = _fetch_audio(fused_audio)[: n_frames * spf].astype(
                np.float32)
        else:
            if self.vocoder_params is None:
                self._load_vocoder()
            audio = self.decode_codes(codes)
        result.timings.t_decode_ms = now_ms() - t0

        if self.low_mem:
            self.vocoder_params = None

        result.audio = audio
        result.sample_rate = self.config.vocoder.sample_rate
        result.success = True
        result.timings.t_total_ms = now_ms() - t_total0
        result.timings.mem_rss_peak = rss_bytes()
        return result

    def synthesize_batch(self, texts, params: SamplingConfig = SamplingConfig(),
                         speakers=None):
        """Batched multi-utterance synthesis (BASELINE.json config #5): all
        utterances run one fused batched decode loop, then ONE vmapped
        vocoder dispatch over a shared frame bucket (shard the batch over a
        "dp" mesh axis for multi-chip serving). Returns a list of TTSResult.

        Timing attribution: t_generate_ms / t_decode_ms on each result are
        the batch stage walls divided by B — the amortized per-utterance
        serving cost (so per-utterance RTF reflects throughput); t_total_ms
        is the whole-batch wall."""
        rt = self.config.runtime
        tcfg, ccfg = self.config.talker, self.config.code_predictor
        B = len(texts)
        if speakers is None:
            speakers = np.zeros((B, tcfg.hidden_size), np.float32)
        results = [TTSResult() for _ in texts]
        if not self._loaded:
            for r in results:
                r.error_msg = "Models not loaded"
            return results

        t_total0 = now_ms()
        token_lists = [self.tokenizer.encode_for_tts(t) for t in texts]
        fitted = [self._fit_tokens(ids) for ids in token_lists]
        Tb = max(p.shape[0] for p, _ in fitted)
        tokens = np.zeros((B, Tb), np.int32)
        n_tok = np.zeros((B,), np.int32)
        for i, (p_i, n_i) in enumerate(fitted):
            tokens[i, : p_i.shape[0]] = p_i
            n_tok[i] = n_i
        max_frames = pick_bucket(params.max_audio_tokens, rt.frame_buckets)
        kv_capacity = -(-(10 + max_frames + rt.kv_margin) // 256) * 256

        t0 = now_ms()
        gen = decode_loop.generate_from_tokens_batched(
            self.talker_params, self.cp_params,
            jnp.asarray(tokens), jnp.asarray(n_tok),
            jnp.asarray(speakers, jnp.float32),
            jnp.full((B,), params.language_id, jnp.int32),
            jax.random.split(jax.random.PRNGKey(params.seed), B),
            talker_cfg=tcfg, cp_cfg=ccfg,
            max_frames=max_frames, kv_capacity=kv_capacity,
            temperature=params.temperature, top_k=params.top_k, top_p=params.top_p,
            repetition_penalty=params.repetition_penalty,
            nothink=params.language_id < 0)
        t_gen = now_ms() - t0
        all_codes = np.asarray(gen.codes)
        all_n = np.asarray(gen.n_frames)
        n_clamped = np.minimum(all_n, params.max_audio_tokens).astype(np.int64)

        # vocode the whole batch in 16-lane dispatches over a shared frame
        # bucket instead of B single-utterance calls. Long-form runs
        # configured for chunked vocoding keep the per-utterance streaming
        # path.
        vcfg = self.config.vocoder
        spf = vcfg.samples_per_frame
        t0 = now_ms()
        if self.vocoder_params is None:
            self._load_vocoder()
        nmax = int(n_clamped.max()) if B else 0
        batched_audio = None
        if nmax > 0 and not (rt.vocoder_chunk_frames
                             and nmax > rt.vocoder_chunk_frames):
            Fb = pick_bucket(nmax, rt.vocoder_buckets)
            bufs = np.zeros((B, Fb, vcfg.n_codebooks), np.int32)
            for i in range(B):
                bufs[i, : n_clamped[i]] = all_codes[i, : n_clamped[i]]
            batched_audio = vocode_batched(
                self.vocoder_params, vcfg, jnp.asarray(bufs),
                jnp.asarray(np.maximum(n_clamped, 1), np.int32))
        t_dec = now_ms() - t0

        for i, r in enumerate(results):
            n = int(n_clamped[i])
            r.codes = all_codes[i, :n]
            r.n_frames = n
            r.timings.t_generate_ms = t_gen / max(B, 1)
            if n == 0:
                r.error_msg = "No speech codes generated"
                continue
            if batched_audio is not None:
                r.audio = batched_audio[i, : n * spf]
                r.timings.t_decode_ms = t_dec / max(B, 1)
            else:
                t0 = now_ms()
                r.audio = self.decode_codes(r.codes)
                r.timings.t_decode_ms = now_ms() - t0
            r.sample_rate = self.config.vocoder.sample_rate
            r.success = True
            r.timings.t_total_ms = now_ms() - t_total0
        return results

    def synthesize_queue(self, texts, params: SamplingConfig = SamplingConfig(),
                         speakers=None, *, lanes: Optional[int] = None,
                         kv_capacity: Optional[int] = None,
                         chunk_frames: int = 8, refill_slots: int = 8,
                         on_audio=None, stream_history: int = 16,
                         stream_cadence: int = 32,
                         max_audio_tokens_per_request=None,
                         admit_per_chunk: Optional[int] = None):
        """Continuous-batching synthesis of a request queue: finished lanes
        are refilled mid-flight (runtime/continuous.py), so a mix of
        unequal-length utterances keeps every lane busy instead of idling
        until the batch's longest request drains (synthesize_batch's static
        loop). Returns TTSResults in submission order.

        Defaults: lanes=min(64, len(texts)); kv_capacity sized for ~2
        request generations per session (more capacity = fewer session
        resets). Per-request PRNG keys derive from params.seed + index, so
        results are reproducible but differ from synthesize_batch's
        key-split scheme.

        on_audio(request_index, audio_chunk, finished), if given, streams
        each request's audio as it is generated (seam semantics of
        stream_decode_chunks: each vocoded window carries stream_history
        left-context frames whose samples are discarded). A request's
        FIRST decoded chunk is vocoded immediately — TTFA is ~one decode-
        chunk wall — after which audio is emitted in stream_cadence-frame
        segments (0 = every decode chunk, which re-vocodes the history
        window of every lane at every chunk). The returned TTSResults carry
        the streamed audio concatenated.

        max_audio_tokens_per_request, if given, is a per-request frame
        budget (list of ints, len(texts)) overriding params.max_audio_tokens
        — the knob a serving front end uses for per-request length limits
        (the scheduler already carries per-lane budgets).

        admit_per_chunk caps admissions per decode-chunk boundary
        (ContinuousScheduler admit_per_boundary): with on_audio, pacing a
        cold 64-lane burst spreads the first-window vocode sets across
        boundaries so early requests hear audio sooner (TTFA staircase)."""
        rt = self.config.runtime
        tcfg, ccfg = self.config.talker, self.config.code_predictor
        vcfg = self.config.vocoder
        spf = vcfg.samples_per_frame
        B = len(texts)
        if speakers is None:
            speakers = np.zeros((B, tcfg.hidden_size), np.float32)
        results = [TTSResult() for _ in texts]
        if not self._loaded:
            for r in results:
                r.error_msg = "Models not loaded"
            return results
        from .runtime.continuous import ContinuousScheduler, prefill_window_len

        t_total0 = now_ms()
        fitted = [self._fit_tokens(self.tokenizer.encode_for_tts(t))
                  for t in texts]
        Tb = max(p.shape[0] for p, _ in fitted)
        max_frames = pick_bucket(params.max_audio_tokens, rt.frame_buckets)
        if lanes is None:
            lanes = max(1, min(64, B))
        if kv_capacity is None:
            P = prefill_window_len(params.language_id < 0)
            kv_capacity = -(-(P + 2 * max_frames + chunk_frames
                              + rt.kv_margin) // 256) * 256

        # streaming keeps the SERIAL harvest loop (unless the env overrides):
        # with one chunk in flight, the first-window vocode sets queue
        # behind the next decode chunk on the device and delay the first
        # audio. Codes-only serving keeps the overlapped default.
        overlap = None
        if on_audio is not None and "QWEN3TTS_OVERLAP_HARVEST" not in os.environ:
            overlap = False
        sched = ContinuousScheduler(
            self.talker_params, self.cp_params, tcfg, ccfg, lanes=lanes,
            kv_capacity=kv_capacity, text_bucket=Tb,
            chunk_frames=chunk_frames, refill_slots=refill_slots,
            max_frames=max_frames, temperature=params.temperature,
            top_k=params.top_k, top_p=params.top_p,
            repetition_penalty=params.repetition_penalty,
            nothink=params.language_id < 0,
            admit_per_boundary=admit_per_chunk,
            overlap_harvest=overlap)
        t0 = now_ms()
        rids = []
        budgets = max_audio_tokens_per_request
        for i, (p_i, n_i) in enumerate(fitted):
            budget = (params.max_audio_tokens if budgets is None
                      else int(budgets[i]))
            rids.append(sched.submit(
                p_i, n_i, np.asarray(speakers[i], np.float32),
                params.language_id, seed=params.seed + i,
                max_frames=min(budget, max_frames)))
        rid_to_idx = {rid: i for i, rid in enumerate(rids)}

        on_chunk = None
        streamed: dict[int, list] = {}
        if on_audio is not None:
            if self.vocoder_params is None:
                self._load_vocoder()
            spf_ = vcfg.samples_per_frame
            ncb = vcfg.n_codebooks

            def _r8(n):
                return max(8, -(-n // 8) * 8)

            # Staggered-cadence emission: vocoding every lane's
            # [history + chunk] window every decode chunk re-vocodes the
            # history each time, at the least efficient window size. So:
            # a request's FIRST decoded frames are vocoded immediately
            # (TTFA unchanged), after which it emits fixed
            # `stream_cadence`-frame segments; per chunk only ~B*chunk/
            # cadence lanes vocode, each window carrying cadence new
            # frames per `stream_history` re-vocoded ones. Two compiled
            # programs total (first-emission bucket + steady bucket),
            # lanes padded to multiples of 16.
            cadence = stream_cadence if stream_cadence > 0 else 0
            Fb_first = _r8(chunk_frames)
            Fb_steady = _r8(stream_history + (cadence or chunk_frames))
            ctx_codes: dict[int, np.ndarray] = {}
            pend_codes: dict[int, np.ndarray] = {}
            emitted_count: dict[int, int] = {}

            def _vocode_wins(wins, Fb):
                """wins: (rid, window [hist+k,16], hist, k, fin); one
                dispatch set over lanes padded to a multiple of 16.
                on_audio fires PER 16-LANE GROUP as each group's audio
                lands on the host (vocode_batched_groups dispatches every
                group up front) — under a burst of first emissions the
                earliest requests hear audio after one group's wall, not
                the whole set's."""
                L = -(-len(wins) // 16) * 16
                bufs = np.zeros((L, Fb, ncb), np.int32)
                nf = np.ones((L,), np.int32)
                for g, (_, window, *_rest) in enumerate(wins):
                    bufs[g, : window.shape[0]] = window
                    nf[g] = max(window.shape[0], 1)
                for g0, g1, audio in vocode_batched_groups(
                        self.vocoder_params, vcfg, jnp.asarray(bufs),
                        jnp.asarray(nf)):
                    for g in range(g0, min(g1, len(wins))):
                        rid, window, hist, k, fin = wins[g]
                        chunk_audio = audio[g - g0, hist * spf_: (hist + k) * spf_]
                        streamed.setdefault(rid, []).append(chunk_audio)
                        on_audio(rid_to_idx[rid], chunk_audio, fin)

            def on_chunk(events):
                first_wins, steady_wins = [], []
                for rid, rows, finished in events:
                    pend = pend_codes.get(rid)
                    pend = (rows if pend is None else
                            np.concatenate([pend, rows], axis=0))
                    emits = []   # (k, is_first)
                    avail = pend.shape[0]
                    if emitted_count.get(rid, 0) == 0 and avail:
                        k = min(avail, Fb_first)
                        emits.append((k, True))
                        avail -= k
                    if cadence:
                        while avail >= cadence:
                            emits.append((cadence, False))
                            avail -= cadence
                        if finished:
                            while avail > 0:
                                k = min(avail, cadence)
                                emits.append((k, False))
                                avail -= k
                    elif avail:
                        emits.append((avail, False))
                        avail = 0
                    off = 0
                    for k, is_first in emits:
                        seg = pend[off: off + k]
                        off += k
                        ctx = ctx_codes.get(rid)
                        hist = 0 if is_first else (
                            0 if ctx is None else
                            min(stream_history, ctx.shape[0]))
                        window = (seg if hist == 0 else
                                  np.concatenate([ctx[-hist:], seg], axis=0))
                        fin = finished and off == pend.shape[0]
                        (first_wins if is_first else steady_wins).append(
                            (rid, window, hist, k, fin))
                        grown = (seg if ctx is None else
                                 np.concatenate([ctx, seg], axis=0))
                        ctx_codes[rid] = grown[-stream_history:]
                        emitted_count[rid] = emitted_count.get(rid, 0) + k
                    pend_codes[rid] = pend[off:]
                    if finished:
                        pend_codes.pop(rid, None)
                        ctx_codes.pop(rid, None)
                        if not emits:   # zero-frame finish: still signal
                            streamed.setdefault(rid, []).append(
                                np.zeros((0,), np.float32))
                            on_audio(rid_to_idx[rid],
                                     np.zeros((0,), np.float32), True)
                if first_wins:
                    _vocode_wins(first_wins, Fb_first)
                if steady_wins:
                    _vocode_wins(steady_wins, Fb_steady)

        out = sched.run(on_chunk=on_chunk)
        t_gen = now_ms() - t0

        all_codes = [out[rid] for rid in rids]
        n_clamped = np.array(
            [min(c.shape[0],
                 params.max_audio_tokens if budgets is None else int(budgets[i]))
             for i, c in enumerate(all_codes)],
            np.int64)

        if self.vocoder_params is None:
            self._load_vocoder()
        t0 = now_ms()
        nmax = int(n_clamped.max()) if B else 0
        batched_audio = None
        if (on_audio is None and nmax > 0
                and not (rt.vocoder_chunk_frames
                         and nmax > rt.vocoder_chunk_frames)):
            Fb = pick_bucket(nmax, rt.vocoder_buckets)
            bufs = np.zeros((B, Fb, vcfg.n_codebooks), np.int32)
            for i in range(B):
                bufs[i, : n_clamped[i]] = all_codes[i][: n_clamped[i]]
            batched_audio = vocode_batched(
                self.vocoder_params, vcfg, jnp.asarray(bufs),
                jnp.asarray(np.maximum(n_clamped, 1), np.int32))
        t_dec = now_ms() - t0

        for i, r in enumerate(results):
            n = int(n_clamped[i])
            r.codes = all_codes[i][:n]
            r.n_frames = n
            r.timings.t_generate_ms = t_gen / max(B, 1)
            if n == 0:
                r.error_msg = "No speech codes generated"
                continue
            if on_audio is not None:
                chunks = streamed.get(rids[i], [])
                r.audio = (np.concatenate(chunks)[: n * spf] if chunks
                           else np.zeros(0, np.float32))
                r.timings.t_decode_ms = 0.0   # vocoded inside t_generate
            elif batched_audio is not None:
                r.audio = batched_audio[i, : n * spf]
                r.timings.t_decode_ms = t_dec / max(B, 1)
            else:
                t0 = now_ms()
                r.audio = self.decode_codes(r.codes)
                r.timings.t_decode_ms = now_ms() - t0
            r.sample_rate = vcfg.sample_rate
            r.success = True
            r.timings.t_total_ms = now_ms() - t_total0
        return results

    def synthesize_streaming(self, text: str, params: SamplingConfig = SamplingConfig(),
                             *, chunk_frames: int = 16, history: int = 32,
                             speaker: Optional[np.ndarray] = None):
        """Streaming synthesis: yields float32 audio chunks while generation
        is still running (generation advances in chunk_frames-sized bites;
        each bite is vocoded with `history` frames of left context). The
        reference lists streaming decode as unimplemented future work
        (OPTIMIZATION.md:157-159).

        Time-to-first-audio ~= prefill + chunk_frames * per-frame cost +
        one vocoder chunk."""
        if not self._loaded:
            raise RuntimeError("Models not loaded")
        rt = self.config.runtime
        tcfg, ccfg = self.config.talker, self.config.code_predictor
        spf = self.config.vocoder.samples_per_frame
        if speaker is None:
            speaker = np.zeros((tcfg.hidden_size,), np.float32)

        tokens = self.tokenizer.encode_for_tts(text)
        padded, n_tok = self._fit_tokens(tokens)
        max_frames = pick_bucket(params.max_audio_tokens, rt.frame_buckets)
        kv_capacity = -(-(10 + max_frames + rt.kv_margin) // 256) * 256

        if self.talker_params is None:
            self._load_talker()
        if self.vocoder_params is None:
            self._load_vocoder()

        # prefill + first chunk + its vocode fused into ONE dispatch (TTFA):
        # the first audible samples cost a single device round trip
        from .runtime.e2e import start_and_vocode

        audio0, state, prefill = start_and_vocode(
            self.talker_params, self.cp_params, self.vocoder_params,
            jnp.asarray(padded), jnp.int32(n_tok),
            jnp.asarray(speaker, jnp.float32), jnp.int32(params.language_id),
            jax.random.PRNGKey(params.seed),
            talker_cfg=tcfg, cp_cfg=ccfg, vocoder_cfg=self.config.vocoder,
            chunk_frames=chunk_frames, max_frames=max_frames,
            kv_capacity=kv_capacity,
            temperature=params.temperature, top_k=params.top_k,
            top_p=params.top_p, repetition_penalty=params.repetition_penalty,
            nothink=params.language_id < 0)

        emitted = 0
        budget = min(params.max_audio_tokens, max_frames)
        n0 = min(int(state.frame), budget)
        if n0 > 0:
            yield np.asarray(audio0[: n0 * spf], np.float32)
            emitted = n0
        if bool(state.done) or n0 >= budget:
            return

        first = False  # the first chunk is already generated and yielded
        while True:
            if not first:
                state = decode_loop.generate_chunk(
                    self.talker_params, self.cp_params, prefill, state,
                    talker_cfg=tcfg, cp_cfg=ccfg,
                    chunk_frames=chunk_frames, max_frames=max_frames,
                    temperature=params.temperature, top_k=params.top_k,
                    top_p=params.top_p, repetition_penalty=params.repetition_penalty)
            first = False
            n = min(int(state.frame), budget)
            done = bool(state.done) or n >= budget
            if n > emitted:
                codes = np.asarray(state.codes[:n])
                lo = max(0, emitted - history)
                window = codes[lo:n]
                Fb = pick_bucket(len(window), rt.vocoder_buckets)
                buf = np.zeros((Fb, self.config.vocoder.n_codebooks), np.int32)
                buf[: len(window)] = window
                audio = np.asarray(vocoder_model.vocoder_decode(
                    self.vocoder_params, self.config.vocoder,
                    jnp.asarray(buf), jnp.int32(len(window))))
                yield audio[(emitted - lo) * spf: (n - lo) * spf]
                emitted = n
            if done:
                break

    def decode_codes(self, codes: np.ndarray) -> np.ndarray:
        """codes [n_frames, 16] -> waveform (bucketed, optionally chunked)."""
        vcfg = self.config.vocoder
        rt = self.config.runtime
        n = codes.shape[0]
        spf = vcfg.samples_per_frame
        chunk = rt.vocoder_chunk_frames
        if chunk and n > chunk:
            return self._decode_streaming(codes, chunk)
        Fb = pick_bucket(n, rt.vocoder_buckets)
        buf = np.zeros((Fb, vcfg.n_codebooks), np.int32)
        buf[:n] = codes
        audio = vocoder_model.vocoder_decode(
            self.vocoder_params, vcfg, jnp.asarray(buf), jnp.int32(n))
        return np.asarray(audio[: n * spf])

    def _decode_streaming(self, codes: np.ndarray, chunk: int) -> np.ndarray:
        return np.concatenate(list(self.stream_decode_chunks(codes, chunk)))

    def stream_decode_chunks(self, codes: np.ndarray, chunk: int, history: int = 16):
        """Chunked vocoder decode: every chunk is decoded with `history` left-
        context frames whose output samples are discarded. The stack is fully
        causal, so as long as `history` covers the (frame-level) receptive
        field of the conv pipeline the seams are inaudible (exactness is
        bounded by the pre-transformer's unbounded causal attention, which in
        practice decays; parity tests bound the error)."""
        vcfg = self.config.vocoder
        spf = vcfg.samples_per_frame
        n = codes.shape[0]
        Fb = pick_bucket(chunk + history, self.config.runtime.vocoder_buckets)
        start = 0
        while start < n:
            lo = max(0, start - history)
            hi = min(n, start + chunk)
            window = codes[lo:hi]
            buf = np.zeros((Fb, vcfg.n_codebooks), np.int32)
            buf[: len(window)] = window
            audio = vocoder_model.vocoder_decode(
                self.vocoder_params, vcfg, jnp.asarray(buf), jnp.int32(len(window)))
            audio = np.asarray(audio)
            yield audio[(start - lo) * spf: (hi - lo) * spf]
            start = hi

    # ------------------------------------------------------------------
    # warmup
    # ------------------------------------------------------------------

    def warmup(self, *, text_bucket: Optional[int] = None, frame_bucket: Optional[int] = None,
               clone: bool = False) -> None:
        """Pre-compile the serving-path programs for the given buckets."""
        rt = self.config.runtime
        tb = text_bucket or rt.prefill_buckets[0]
        fb = frame_bucket or rt.frame_buckets[0]
        params = SamplingConfig(max_audio_tokens=fb)
        tokens = self.tokenizer.encode_for_tts("warm up.")
        dummy = "warm up." if len(tokens) <= tb else "w"
        if clone:
            ref = np.zeros((self.config.runtime.speaker_buckets[0],), np.float32)
            self.synthesize_with_voice(dummy, ref, params)
        else:
            self.synthesize(dummy, params)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _speaker_embed_jit(params, cfg, samples, n_samples, fb, win):
    mel, n_frames = mel_mod.log_mel(samples, n_samples, cfg, fb, win)
    return se_model.speaker_encoder_forward(params, cfg, mel, n_frames)
