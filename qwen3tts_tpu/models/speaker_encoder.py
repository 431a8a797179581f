"""ECAPA-TDNN speaker encoder: log-mel -> 1024-d x-vector (voice cloning).

Covers reference component #4 (SURVEY.md §2; src/audio_tokenizer_encoder.cpp
:445-701):

  conv k=5 (reflect pad) 128->512 + ReLU
  3 x SE-Res2Net blocks (scale 8, dilations 2/3/4):
      tdnn1 k=1 + ReLU -> res2net 8x64 hierarchical k=3 dilated convs with
      reflect padding + ReLU -> tdnn2 k=1 + ReLU -> squeeze-excitation
      (global-avg -> 128 -> sigmoid 512 scale) -> + residual
  MFA concat(block1..3) 1536 -> k=1 conv + ReLU
  attentive-statistics pooling: concat[x, global mean, global std] 4608 ->
      tdnn k=1 128 + ReLU -> tanh -> conv k=1 1536 -> softmax over time ->
      weighted mean/std -> concat 3072
  fc k=1 3072 -> 1024

The whole network is one jitted function over a padded frame
bucket; every spatial conv gathers its taps through dynamic reflection
indices against the true frame count and every pooling/softmax is masked, so
padding is numerically invisible (no per-length recompiles).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SpeakerEncoderConfig

NEG_INF = -1e30  # plain float: no device allocation at import time


class SEResBlockParams(NamedTuple):
    tdnn1_w: jnp.ndarray    # [1, C, C]
    tdnn1_b: jnp.ndarray
    res2net_w: jnp.ndarray  # [scale-1, 3, B, B]
    res2net_b: jnp.ndarray  # [scale-1, B]
    tdnn2_w: jnp.ndarray    # [1, C, C]
    tdnn2_b: jnp.ndarray
    se1_w: jnp.ndarray      # [1, C, S]
    se1_b: jnp.ndarray
    se2_w: jnp.ndarray      # [1, S, C]
    se2_b: jnp.ndarray


class SpeakerEncoderParams(NamedTuple):
    conv0_w: jnp.ndarray    # [5, n_mels, C]
    conv0_b: jnp.ndarray
    blocks: tuple           # 3 x SEResBlockParams
    mfa_w: jnp.ndarray      # [1, 3C, 3C]
    mfa_b: jnp.ndarray
    asp_tdnn_w: jnp.ndarray  # [1, 9C, A]
    asp_tdnn_b: jnp.ndarray
    asp_conv_w: jnp.ndarray  # [1, A, 3C]
    asp_conv_b: jnp.ndarray
    fc_w: jnp.ndarray        # [1, 6C, E]
    fc_b: jnp.ndarray


def init_speaker_encoder_params(key: jax.Array, cfg: SpeakerEncoderConfig, dtype=jnp.float32) -> SpeakerEncoderParams:
    ks = iter(jax.random.split(key, 32))

    def w(shape, fan_in):
        return (jax.random.normal(next(ks), shape, jnp.float32) / jnp.sqrt(fan_in)).astype(dtype)

    C, B, S, A = cfg.hidden_dim, cfg.branch_dim, cfg.se_dim, cfg.attention_dim
    blocks = tuple(
        SEResBlockParams(
            tdnn1_w=w((1, C, C), C), tdnn1_b=jnp.zeros((C,), dtype),
            res2net_w=w((cfg.res2net_scale - 1, 3, B, B), 3 * B),
            res2net_b=jnp.zeros((cfg.res2net_scale - 1, B), dtype),
            tdnn2_w=w((1, C, C), C), tdnn2_b=jnp.zeros((C,), dtype),
            se1_w=w((1, C, S), C), se1_b=jnp.zeros((S,), dtype),
            se2_w=w((1, S, C), S), se2_b=jnp.zeros((C,), dtype),
        )
        for _ in range(cfg.n_blocks)
    )
    return SpeakerEncoderParams(
        conv0_w=w((5, cfg.n_mels, C), 5 * cfg.n_mels), conv0_b=jnp.zeros((C,), dtype),
        blocks=blocks,
        mfa_w=w((1, cfg.mfa_dim, cfg.mfa_dim), cfg.mfa_dim), mfa_b=jnp.zeros((cfg.mfa_dim,), dtype),
        asp_tdnn_w=w((1, 3 * cfg.mfa_dim, A), 3 * cfg.mfa_dim), asp_tdnn_b=jnp.zeros((A,), dtype),
        asp_conv_w=w((1, A, cfg.mfa_dim), A), asp_conv_b=jnp.zeros((cfg.mfa_dim,), dtype),
        fc_w=w((1, 2 * cfg.mfa_dim, cfg.embedding_dim), 2 * cfg.mfa_dim),
        fc_b=jnp.zeros((cfg.embedding_dim,), dtype),
    )


def _reflect_idx(t: jnp.ndarray, n: jnp.ndarray, Tb: int) -> jnp.ndarray:
    """Reflect positions t against [0, n) (same-pad reflect, torch style)."""
    t = jnp.where(t < 0, -t, t)
    t = jnp.where(t >= n, 2 * n - 2 - t, t)
    return jnp.clip(t, 0, Tb - 1)


def _conv_reflect(x: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray, n: jnp.ndarray,
                  dilation: int = 1) -> jnp.ndarray:
    """'Same' conv on [Tb, Cin] with reflect padding computed against the true
    length n. Implemented as K gathered taps (K is 1, 3, or 5 here)."""
    K = w.shape[0]
    Tb = x.shape[0]
    if K == 1:
        y = x @ w[0]
    else:
        pad = dilation * (K - 1) // 2
        t = jnp.arange(Tb)
        y = None
        for k in range(K):
            src = _reflect_idx(t + (k * dilation - pad), n, Tb)
            contrib = x[src] @ w[k]
            y = contrib if y is None else y + contrib
    return y + b


def _masked_mean_std(x: jnp.ndarray, mask: jnp.ndarray, n: jnp.ndarray, eps: float = 1e-12):
    """Mean/std over valid time steps. std via E[x^2]-E[x]^2 clamped, matching
    the reference (audio_tokenizer_encoder.cpp:615-629)."""
    nf = n.astype(jnp.float32)
    xm = jnp.where(mask[:, None], x, 0.0)
    mean = jnp.sum(xm, axis=0) / nf
    mean_sq = jnp.sum(jnp.where(mask[:, None], x * x, 0.0), axis=0) / nf
    var = jnp.clip(mean_sq - mean * mean, eps, 1e10)
    return mean, jnp.sqrt(var)


def speaker_encoder_forward(
    params: SpeakerEncoderParams,
    cfg: SpeakerEncoderConfig,
    mel: jnp.ndarray,       # [Tb, n_mels]
    n_frames: jnp.ndarray,  # scalar: valid frames
) -> jnp.ndarray:
    """Returns the speaker embedding [embedding_dim] (float32)."""
    Tb = mel.shape[0]
    n = n_frames
    mask = jnp.arange(Tb) < n
    scale = cfg.res2net_scale
    B = cfg.branch_dim

    x = jax.nn.relu(_conv_reflect(mel.astype(jnp.float32), params.conv0_w, params.conv0_b, n))

    outputs = []
    for blk, dilation in zip(params.blocks, cfg.dilations):
        residual = x
        x = jax.nn.relu(_conv_reflect(x, blk.tdnn1_w, blk.tdnn1_b, n))

        # Res2Net hierarchy: branch 0 passthrough; branch i>=1 convolves
        # (branch_i + out_{i-1}) except branch 1 which has no carry-in.
        branches = [x[:, i * B:(i + 1) * B] for i in range(scale)]
        outs = [branches[0]]
        for i in range(1, scale):
            inp = branches[i] if i == 1 else branches[i] + outs[-1]
            y = _conv_reflect(inp, blk.res2net_w[i - 1], blk.res2net_b[i - 1], n, dilation)
            outs.append(jax.nn.relu(y))
        x = jnp.concatenate(outs, axis=-1)

        x = jax.nn.relu(_conv_reflect(x, blk.tdnn2_w, blk.tdnn2_b, n))

        # Squeeze-excitation over valid frames.
        se = jnp.sum(jnp.where(mask[:, None], x, 0.0), axis=0) / n.astype(jnp.float32)
        se = jax.nn.relu(se @ blk.se1_w[0] + blk.se1_b)
        se = jax.nn.sigmoid(se @ blk.se2_w[0] + blk.se2_b)
        x = x * se[None, :] + residual
        outputs.append(x)

    x = jnp.concatenate(outputs, axis=-1)                       # [Tb, 1536]
    x = jax.nn.relu(_conv_reflect(x, params.mfa_w, params.mfa_b, n))

    # Attentive statistics pooling.
    gmean, gstd = _masked_mean_std(x, mask, n)
    att_in = jnp.concatenate(
        [x, jnp.broadcast_to(gmean, x.shape), jnp.broadcast_to(gstd, x.shape)], axis=-1)
    att = jax.nn.relu(att_in @ params.asp_tdnn_w[0] + params.asp_tdnn_b)
    att = jnp.tanh(att)
    att = att @ params.asp_conv_w[0] + params.asp_conv_b       # [Tb, 1536]
    att = jnp.where(mask[:, None], att, NEG_INF)
    att = jax.nn.softmax(att, axis=0)

    wmean = jnp.sum(att * x, axis=0)
    diff = x - wmean[None, :]
    wvar = jnp.sum(jnp.where(mask[:, None], att * diff * diff, 0.0), axis=0)
    wstd = jnp.sqrt(jnp.clip(wvar, 1e-12, 1e10))

    pooled = jnp.concatenate([wmean, wstd])                    # [3072]
    return (pooled @ params.fc_w[0] + params.fc_b).astype(jnp.float32)
