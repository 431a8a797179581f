"""WavTokenizer-style neural-codec vocoder: 16-codebook codes -> 24 kHz audio.

Covers reference component #7 (SURVEY.md §2; src/audio_tokenizer_decoder.cpp):

  VQ dequant (usage-normalized codebooks, :40-73) -> 256->512 projections and
  sum (:648-703) -> causal pre-conv k=3 512->1024 (:705-710) -> input proj
  1024->512 -> 8-layer causal pre-transformer at width 512 with 16x64 MHA,
  RoPE theta=1e4, LayerScale, SwiGLU (:412-488) -> output proj 512->1024 ->
  2 ConvNeXt x2-upsample blocks (:490-549) -> causal conv k=7 1024->1536
  (:758-765) -> 4 decoder blocks [Snake -> ConvT x8/5/4/3 -> 3 residual blocks
  d=1/3/9] (:551-620) -> Snake -> causal conv k=7 -> tanh (:775-790).
  Total upsampling 2*2*8*5*4*3 = 1920 samples/frame.

One deliberate divergence from the C++: transposed convolutions here trim the
full (kernel - stride) padding from the RIGHT only, which is the causal
convention of the Python ground-truth pipeline and yields exactly
stride * n_frames outputs per block (the deterministic fixture is 63 frames ->
120960 = 63*1920 samples, reference/det_metadata.json). The C++ trims
(kernel - stride) from BOTH sides (:600-609), losing `stride` samples per
block and shifting phase; `trim="symmetric"` reproduces that variant.

Everything is jittable; frame counts are bucketed by the pipeline and the
whole stack is causal, so right-padding frames never corrupts valid samples.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import VocoderConfig
from ..ops.norms import layer_norm, rms_norm
from ..ops.rope import apply_rope, rope_for_positions

NEG_INF = -1e30  # plain float: no device allocation at import time


# ---------------------------------------------------------------------------
# conv helpers (activations are [T, C]; weights are [K, In, Out])
# ---------------------------------------------------------------------------


def conv1d(x: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray | None, *,
           dilation: int = 1, groups: int = 1, causal: bool = True) -> jnp.ndarray:
    """1-D conv on [T, C] with causal left padding of dilation*(K-1).

    Dense (groups=1) convs are computed as K accumulated matmuls over
    shifted views: y[t] = sum_k xp[t + d*k] @ w[k] with xp the padded input.
    (A concat form — concat_k(shifted views) @ w.reshape(K*In, Out) —
    materializes a [B, T, K*In] tensor under vmap: 28 GB at B=64/block-3
    shapes. The tap-sum keeps the peak at
    one f32 [.., T, Out] accumulator and vmaps into K clean batched matmuls.
    On an H100 (400 W) the vocoder at 256 frames ran 24.7 ms with tap
    matmuls against 41.5 ms with lax.conv at default precision, 57.4 against
    266.3 ms at float32 precision — PERF.md.)
    Grouped (depthwise) convs use lax.conv."""
    K = w.shape[0]
    pad = dilation * (K - 1)
    if groups == 1:
        T = x.shape[0]
        lpad, rpad = (pad, 0) if causal else (pad // 2, pad - pad // 2)
        xp = jnp.pad(x, ((lpad, rpad), (0, 0)))
        acc = jax.lax.dot_general(
            xp[:T], w[0], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        for k in range(1, K):
            acc = acc + jax.lax.dot_general(
                xp[dilation * k: dilation * k + T], w[k],
                (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
        y = acc.astype(x.dtype)
    else:
        padding = [(pad, 0)] if causal else [(pad // 2, pad - pad // 2)]
        y = lax.conv_general_dilated(
            x[None], w,
            window_strides=(1,),
            padding=padding,
            rhs_dilation=(dilation,),
            dimension_numbers=("NWC", "WIO", "NWC"),
            feature_group_count=groups,
        )[0]
    if b is not None:
        y = y + b
    return y


def conv_transpose1d(x: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray | None, *,
                     stride: int, trim: str = "causal") -> jnp.ndarray:
    """Transposed 1-D conv on [T, C].

    ``w`` is stored pre-flipped as [K, In, Out] such that the op equals
    torch.nn.ConvTranspose1d with weight[i, o, k] = w[K-1-k, i, o]. The raw
    output length (T-1)*stride + K is trimmed by (K - stride):
      - trim="causal": all from the right (Python ground truth) -> T*stride
      - trim="symmetric": split across both sides (C++ reference variant)

    K must divide into stride taps (K = J*stride — true for every vocoder
    convT: K=2r at stride r, K=2 at stride 2); the op is then J accumulated
    matmuls: phase algebra gives y[q*s + p] = sum_j w[K-1-p-j*s] @ x[q-j], so
    sum_j shift(x, j) @ W2[j] with W2[j][i, p*Out + o] = w[K-1-p-j*s, i, o]
    computes all s phases at once and the [T, s*Out] -> [T*s, Out] reshape is
    the interleave. (Tap-sum rather than concat_j(...) @ W2 for the same
    vmap-materialization reason as conv1d.)"""
    K = w.shape[0]
    s = stride
    cut = K - s
    assert K % s == 0, f"kernel {K} is not a multiple of stride {s}"
    T, cin = x.shape
    cout = w.shape[2]
    J = K // s
    # W2: flip K, group [J, s], move phase axis next to cout
    w2 = (w[::-1].reshape(J, s, cin, cout)
          .transpose(0, 2, 1, 3).reshape(J, cin, s * cout))
    xp = jnp.pad(x, ((J - 1, 0), (0, 0)))
    acc = jax.lax.dot_general(
        xp[J - 1:], w2[0], (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)
    for j in range(1, J):
        acc = acc + jax.lax.dot_general(
            xp[J - 1 - j: xp.shape[0] - j], w2[j],
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
    y = acc.astype(x.dtype).reshape(T * s, cout)
    # raw convT output is length T*s + cut; rows [T*s, T*s+cut) only
    # receive taps k >= s of x[T-1] and are trimmed under both modes
    if trim == "symmetric" and cut > 0:
        y = y[cut:]                    # also drop the left edge
    if b is not None:
        y = y + b
    return y


def snake(x: jnp.ndarray, alpha: jnp.ndarray, beta: jnp.ndarray) -> jnp.ndarray:
    """Snake activation x + exp(-beta) * sin^2(exp(alpha) * x), per channel
    (reference :375-402). Computed in f32."""
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    a = jnp.exp(alpha.astype(jnp.float32))
    ib = jnp.exp(-beta.astype(jnp.float32))
    s = jnp.sin(xf * a)
    return (xf + ib * s * s).astype(dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class PreTfmBlockParams(NamedTuple):
    """Stacked x n_pre_tfm_layers."""
    attn_norm: jnp.ndarray   # [L, W]
    wq: jnp.ndarray          # [L, W, Q]
    wk: jnp.ndarray          # [L, W, Q]
    wv: jnp.ndarray          # [L, W, Q]
    wo: jnp.ndarray          # [L, Q, W]
    attn_scale: jnp.ndarray  # [L, W] LayerScale
    ffn_norm: jnp.ndarray    # [L, W]
    w_gate: jnp.ndarray      # [L, W, F]
    w_up: jnp.ndarray        # [L, W, F]
    w_down: jnp.ndarray      # [L, F, W]
    ffn_scale: jnp.ndarray   # [L, W]


class ConvNeXtParams(NamedTuple):
    """Stacked x 2."""
    convt_w: jnp.ndarray     # [2, 2, C, C]
    convt_b: jnp.ndarray     # [2, C]
    dw_w: jnp.ndarray        # [2, 7, 1, C]
    dw_b: jnp.ndarray        # [2, C]
    ln_w: jnp.ndarray        # [2, C]
    ln_b: jnp.ndarray        # [2, C]
    pw1_w: jnp.ndarray       # [2, C, M]
    pw1_b: jnp.ndarray       # [2, M]
    pw2_w: jnp.ndarray       # [2, M, C]
    pw2_b: jnp.ndarray       # [2, C]
    gamma: jnp.ndarray       # [2, C]


class ResBlockParams(NamedTuple):
    """Stacked x 3 (dilations 1/3/9) within one decoder block."""
    act1_alpha: jnp.ndarray  # [3, C]
    act1_beta: jnp.ndarray
    conv1_w: jnp.ndarray     # [3, 7, C, C]
    conv1_b: jnp.ndarray     # [3, C]
    act2_alpha: jnp.ndarray
    act2_beta: jnp.ndarray
    conv2_w: jnp.ndarray     # [3, 1, C, C]
    conv2_b: jnp.ndarray     # [3, C]


class DecoderBlockParams(NamedTuple):
    snake_alpha: jnp.ndarray  # [Cin]
    snake_beta: jnp.ndarray
    convt_w: jnp.ndarray      # [2r, Cin, Cout]
    convt_b: jnp.ndarray      # [Cout]
    res: ResBlockParams


class VocoderParams(NamedTuple):
    vq_first_cb: jnp.ndarray     # [Vcb, 256] usage-normalized
    vq_rest_cb: jnp.ndarray      # [15, Vcb, 256]
    vq_first_proj: jnp.ndarray   # [256, 512]
    vq_rest_proj: jnp.ndarray    # [256, 512]
    pre_conv_w: jnp.ndarray      # [3, 512, 1024]
    pre_conv_b: jnp.ndarray      # [1024]
    pt_in_w: jnp.ndarray         # [1024, 512]
    pt_in_b: jnp.ndarray         # [512]
    pt_blocks: PreTfmBlockParams
    pt_norm: jnp.ndarray         # [512]
    pt_out_w: jnp.ndarray        # [512, 1024]
    pt_out_b: jnp.ndarray        # [1024]
    convnext: ConvNeXtParams
    dec0_w: jnp.ndarray          # [7, 1024, 1536]
    dec0_b: jnp.ndarray          # [1536]
    dec_blocks: tuple            # 4 x DecoderBlockParams (channels differ)
    final_alpha: jnp.ndarray     # [96]
    final_beta: jnp.ndarray
    out_w: jnp.ndarray           # [7, 96, 1]
    out_b: jnp.ndarray           # [1]


def init_vocoder_params(key: jax.Array, cfg: VocoderConfig, dtype=jnp.float32) -> VocoderParams:
    ks = iter(jax.random.split(key, 64))

    def w(shape, fan_in):
        return (jax.random.normal(next(ks), shape, jnp.float32) / jnp.sqrt(fan_in)).astype(dtype)

    L, W, Q, F = cfg.n_pre_tfm_layers, cfg.pre_tfm_width, cfg.pre_tfm_qkv_dim, cfg.pre_tfm_ffn_dim
    C, M = cfg.latent_dim, cfg.convnext_mlp_dim
    pt = PreTfmBlockParams(
        attn_norm=jnp.ones((L, W), dtype),
        wq=w((L, W, Q), W), wk=w((L, W, Q), W), wv=w((L, W, Q), W), wo=w((L, Q, W), Q),
        attn_scale=jnp.full((L, W), 0.1, dtype),
        ffn_norm=jnp.ones((L, W), dtype),
        w_gate=w((L, W, F), W), w_up=w((L, W, F), W), w_down=w((L, F, W), F),
        ffn_scale=jnp.full((L, W), 0.1, dtype),
    )
    cnx = ConvNeXtParams(
        convt_w=w((cfg.n_convnext, 2, C, C), 2 * C), convt_b=jnp.zeros((cfg.n_convnext, C), dtype),
        dw_w=w((cfg.n_convnext, 7, 1, C), 7), dw_b=jnp.zeros((cfg.n_convnext, C), dtype),
        ln_w=jnp.ones((cfg.n_convnext, C), dtype), ln_b=jnp.zeros((cfg.n_convnext, C), dtype),
        pw1_w=w((cfg.n_convnext, C, M), C), pw1_b=jnp.zeros((cfg.n_convnext, M), dtype),
        pw2_w=w((cfg.n_convnext, M, C), M), pw2_b=jnp.zeros((cfg.n_convnext, C), dtype),
        gamma=jnp.full((cfg.n_convnext, C), 0.5, dtype),
    )
    chans = cfg.decoder_channels
    dec_blocks = []
    for i, r in enumerate(cfg.upsample_rates):
        cin, cout = chans[i], chans[i + 1]
        dec_blocks.append(DecoderBlockParams(
            snake_alpha=jnp.zeros((cin,), dtype), snake_beta=jnp.zeros((cin,), dtype),
            convt_w=w((2 * r, cin, cout), 2 * r * cin), convt_b=jnp.zeros((cout,), dtype),
            res=ResBlockParams(
                act1_alpha=jnp.zeros((3, cout), dtype), act1_beta=jnp.zeros((3, cout), dtype),
                conv1_w=w((3, 7, cout, cout), 7 * cout), conv1_b=jnp.zeros((3, cout), dtype),
                act2_alpha=jnp.zeros((3, cout), dtype), act2_beta=jnp.zeros((3, cout), dtype),
                conv2_w=w((3, 1, cout, cout), cout), conv2_b=jnp.zeros((3, cout), dtype),
            ),
        ))
    return VocoderParams(
        vq_first_cb=w((cfg.codebook_size, cfg.codebook_dim), cfg.codebook_dim),
        vq_rest_cb=w((cfg.n_codebooks - 1, cfg.codebook_size, cfg.codebook_dim), cfg.codebook_dim),
        vq_first_proj=w((cfg.codebook_dim, cfg.hidden_dim), cfg.codebook_dim),
        vq_rest_proj=w((cfg.codebook_dim, cfg.hidden_dim), cfg.codebook_dim),
        pre_conv_w=w((3, cfg.hidden_dim, cfg.latent_dim), 3 * cfg.hidden_dim),
        pre_conv_b=jnp.zeros((cfg.latent_dim,), dtype),
        pt_in_w=w((cfg.latent_dim, W), cfg.latent_dim), pt_in_b=jnp.zeros((W,), dtype),
        pt_blocks=pt,
        pt_norm=jnp.ones((W,), dtype),
        pt_out_w=w((W, cfg.latent_dim), W), pt_out_b=jnp.zeros((cfg.latent_dim,), dtype),
        convnext=cnx,
        dec0_w=w((7, cfg.latent_dim, cfg.decoder_dim), 7 * cfg.latent_dim),
        dec0_b=jnp.zeros((cfg.decoder_dim,), dtype),
        dec_blocks=tuple(dec_blocks),
        final_alpha=jnp.zeros((chans[-1],), dtype), final_beta=jnp.zeros((chans[-1],), dtype),
        out_w=w((7, chans[-1], 1), 7 * chans[-1]), out_b=jnp.zeros((1,), dtype),
    )


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _pre_transformer(params: VocoderParams, cfg: VocoderConfig, x: jnp.ndarray,
                     n_valid) -> jnp.ndarray:
    """Causal MHA transformer on [T, W]; keys >= n_valid masked (padding)."""
    T = x.shape[0]
    Hn = cfg.n_heads
    D = cfg.pre_tfm_qkv_dim // Hn
    eps = cfg.rms_norm_eps
    positions = jnp.arange(T, dtype=jnp.int32)
    cos, sin = rope_for_positions(positions, D, cfg.rope_theta)
    pos = jnp.arange(T)
    mask = pos[None, :] <= pos[:, None]
    if n_valid is not None:
        mask = mask & (pos[None, :] < n_valid)

    def scan_fn(x, p):
        h = rms_norm(x, p.attn_norm, eps)
        q = apply_rope((h @ p.wq).reshape(T, Hn, D), cos, sin)
        k = apply_rope((h @ p.wk).reshape(T, Hn, D), cos, sin)
        v = (h @ p.wv).reshape(T, Hn, D)
        scores = jnp.einsum("qhd,khd->hqk", q, k, preferred_element_type=jnp.float32)
        scores = scores / (D ** 0.5)
        scores = jnp.where(mask[None], scores, NEG_INF)
        probs = jax.nn.softmax(scores, axis=-1)
        o = jnp.einsum("hqk,khd->qhd", probs.astype(v.dtype), v).reshape(T, Hn * D)
        x = x + (o @ p.wo) * p.attn_scale

        h = rms_norm(x, p.ffn_norm, eps)
        gate = jax.nn.silu((h @ p.w_gate).astype(jnp.float32)).astype(h.dtype)
        x = x + ((gate * (h @ p.w_up)) @ p.w_down) * p.ffn_scale
        return x, None

    x, _ = lax.scan(scan_fn, x, params.pt_blocks)
    return x


def _convnext_block(x: jnp.ndarray, p, i: int, trim: str) -> jnp.ndarray:
    """ConvNeXt x2 upsample block on [T, C] (reference :490-549)."""
    C = x.shape[-1]
    x = conv_transpose1d(x, p.convt_w[i], p.convt_b[i], stride=2, trim=trim)
    residual = x
    x = conv1d(x, p.dw_w[i], p.dw_b[i], groups=C, causal=True)
    x = layer_norm(x, p.ln_w[i], p.ln_b[i], 1e-6)
    x = x @ p.pw1_w[i] + p.pw1_b[i]
    x = jax.nn.gelu(x.astype(jnp.float32), approximate=False).astype(x.dtype)
    x = x @ p.pw2_w[i] + p.pw2_b[i]
    x = x * p.gamma[i]
    return residual + x


def _residual_block(x: jnp.ndarray, res: ResBlockParams, i: int, dilation: int) -> jnp.ndarray:
    r = x
    x = snake(x, res.act1_alpha[i], res.act1_beta[i])
    x = conv1d(x, res.conv1_w[i], res.conv1_b[i], dilation=dilation, causal=True)
    x = snake(x, res.act2_alpha[i], res.act2_beta[i])
    x = conv1d(x, res.conv2_w[i], res.conv2_b[i], causal=True)
    return r + x


def _decoder_block(x: jnp.ndarray, blk: DecoderBlockParams, rate: int,
                   dilations, trim: str) -> jnp.ndarray:
    x = snake(x, blk.snake_alpha, blk.snake_beta)
    x = conv_transpose1d(x, blk.convt_w, blk.convt_b, stride=rate, trim=trim)
    for i, d in enumerate(dilations):
        x = _residual_block(x, blk.res, i, d)
    return x


def vocoder_forward(
    params: VocoderParams,
    cfg: VocoderConfig,
    codes: jnp.ndarray,          # [T, 16] int32 (padded frames are harmless)
    n_frames=None,               # scalar or None: valid frame count (for attention mask)
    *,
    trim: str = "causal",
) -> jnp.ndarray:
    """Decode codes to a waveform [T * samples_per_frame] in [-1, 1]."""
    # VQ dequant: gather + project 256->512; rest codebooks share one
    # projection so their embeddings are summed before projecting.
    first = params.vq_first_cb[codes[:, 0]]                           # [T, 256]
    rest = params.vq_rest_cb[jnp.arange(cfg.n_codebooks - 1), codes[:, 1:]]  # [T, 15, 256]
    latent = first @ params.vq_first_proj + jnp.sum(rest, axis=1) @ params.vq_rest_proj

    # Causal pre-conv 512 -> 1024, k=3.
    x = conv1d(latent, params.pre_conv_w, params.pre_conv_b, causal=True)

    # Pre-transformer at width 512 between 1024-dim projections.
    x = x @ params.pt_in_w + params.pt_in_b
    x = _pre_transformer(params, cfg, x, n_frames)
    x = rms_norm(x, params.pt_norm, cfg.rms_norm_eps)
    x = x @ params.pt_out_w + params.pt_out_b

    # 2 ConvNeXt x2 upsample blocks.
    for i in range(cfg.n_convnext):
        x = _convnext_block(x, params.convnext, i, trim)

    # Decoder stack.
    x = conv1d(x, params.dec0_w, params.dec0_b, causal=True)
    for blk, rate in zip(params.dec_blocks, cfg.upsample_rates):
        x = _decoder_block(x, blk, rate, cfg.res_dilations, trim)

    x = snake(x, params.final_alpha, params.final_beta)
    x = conv1d(x, params.out_w, params.out_b, causal=True)
    return jnp.tanh(x.astype(jnp.float32))[:, 0]


@functools.partial(jax.jit, static_argnames=("cfg", "trim"))
def vocoder_decode(params: VocoderParams, cfg: VocoderConfig, codes: jnp.ndarray,
                   n_frames: jnp.ndarray, *, trim: str = "causal") -> jnp.ndarray:
    """Jitted entry; one compilation per frame bucket (codes.shape[0])."""
    return vocoder_forward(params, cfg, codes, n_frames, trim=trim)
