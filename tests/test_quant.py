"""int8 weight-only quantization path."""

import jax
import jax.numpy as jnp
import numpy as np

from qwen3tts_tpu.config import tiny_pipeline_config, SamplingConfig
from qwen3tts_tpu.ops import quant
from qwen3tts_tpu.models import talker as T
from qwen3tts_tpu.models import code_predictor as CP
from qwen3tts_tpu.runtime import decode_loop as DL

CFG = tiny_pipeline_config()


def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(size=(3, 64, 48)), jnp.float32)
    qw = quant.quantize_per_channel(w)
    back = quant.dequantize(qw)
    err = np.abs(np.asarray(back) - np.asarray(w)).max()
    assert err <= float(np.abs(np.asarray(w)).max()) / 127.0 + 1e-6


def test_matmul_matches_dequantized():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(4, 64)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(64, 48)), jnp.float32)
    qw = quant.quantize_per_channel(w)
    got = quant.matmul(x, qw)
    want = x @ quant.dequantize(qw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_quantized_generation_stays_close():
    tp = T.init_talker_params(jax.random.PRNGKey(11), CFG.talker, jnp.float32)
    cp = CP.init_code_predictor_params(jax.random.PRNGKey(12), CFG.code_predictor, jnp.float32)
    tpq = tp._replace(blocks=quant.quantize_block_params(tp.blocks))
    cpq = cp._replace(blocks=quant.quantize_block_params(cp.blocks))

    tokens = np.zeros((16,), np.int32)
    tokens[:11] = np.arange(2, 13)
    kw = dict(talker_cfg=CFG.talker, cp_cfg=CFG.code_predictor, max_frames=6,
              kv_capacity=24, temperature=0.0, top_k=0, repetition_penalty=1.05)
    args = (jnp.asarray(tokens), jnp.int32(11),
            jnp.zeros((CFG.talker.hidden_size,), jnp.float32), jnp.int32(2050),
            jax.random.PRNGKey(0))
    base = DL.generate_from_tokens(tp, cp, *args, **kw)
    quantized = DL.generate_from_tokens(tpq, cpq, *args, **kw)
    assert int(quantized.n_frames) > 0

    # AR decoding diverges exponentially once any argmax flips, so code-level
    # agreement is meaningless with unstructured random weights. The right
    # closeness metric (the one the reference also uses, README.md:259) is
    # the prefill-logits direction: quantized vs full-precision first-frame
    # hidden state must be nearly parallel.
    from qwen3tts_tpu.models.talker import build_prefill, talker_prefill, make_kv_cache
    pf = build_prefill(tp, CFG.talker, args[0], args[1], args[2], args[3])
    kv = make_kv_cache(CFG.talker, 24, jnp.float32)
    _, logits_fp, _ = talker_prefill(tp, CFG.talker, pf.prefill_embd, kv)
    _, logits_q, _ = talker_prefill(tpq, CFG.talker, pf.prefill_embd, kv)
    a, b = np.asarray(logits_fp, np.float64), np.asarray(logits_q, np.float64)
    cosine = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cosine > 0.995, f"quantized prefill logits cosine {cosine}"


def test_quantized_pipeline_end_to_end():
    import dataclasses
    cfg = dataclasses.replace(CFG, runtime=dataclasses.replace(CFG.runtime, quant="int8"))
    from qwen3tts_tpu.pipeline import Qwen3TTS
    tts = Qwen3TTS(cfg)
    assert tts.load_models(synthetic=True, seed=3)
    r = tts.synthesize("Hello.", SamplingConfig(temperature=0.0, top_k=0, max_audio_tokens=4))
    assert r.success, r.error_msg
    assert len(r.audio) == r.n_frames * 1920


def test_w4_roundtrip_error_bound():
    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.normal(size=(3, 64, 48)), jnp.float32)
    qw = quant.quantize_w4(w)
    assert qw.q.shape == (3, 32, 48) and qw.q.dtype == jnp.int8
    assert qw.scale.shape == (3, 2, 48) and qw.zero.shape == (3, 2, 48)
    back = np.asarray(quant.dequantize4(qw))
    wn = np.asarray(w)
    # affine per-group bound: |err| <= (max-min)/15 / 2 (nearest rounding)
    for h, sl in enumerate((slice(0, 32), slice(32, 64))):
        g = wn[:, sl]
        rng_g = (np.maximum(g.max(axis=1, keepdims=True), 0.0)
                 - np.minimum(g.min(axis=1, keepdims=True), 0.0))
        err = np.abs(back[:, sl] - g)
        assert (err <= rng_g / 15.0 * 0.5 + 1e-6).all()


def test_w4_multigroup_roundtrip_error_bound():
    """K=128 with 32-wide groups -> 4 scale groups; the error bound holds
    PER GROUP (this is what the old 2-group split-half format could not do)."""
    rng = np.random.default_rng(7)
    w = np.asarray(rng.normal(size=(128, 48)), np.float32)
    # inject per-region outliers: group-wise scales localize their damage
    w[3, :] *= 40.0
    w[100, :] *= 25.0
    qw = quant.quantize_w4(jnp.asarray(w))
    assert qw.q.shape == (64, 48) and qw.scale.shape == (4, 48)
    back = np.asarray(quant.dequantize4(qw))
    for g in range(4):
        sl = slice(g * 32, (g + 1) * 32)
        gv = w[sl]
        rng_g = (np.maximum(gv.max(axis=0, keepdims=True), 0.0)
                 - np.minimum(gv.min(axis=0, keepdims=True), 0.0))
        err = np.abs(back[sl] - gv)
        assert (err <= rng_g / 15.0 * 0.5 + 1e-6).all(), f"group {g}"


def test_w4_group_scales_beat_half_scales():
    """With outlier rows, 32-wide groups must reconstruct much better than
    the K/2-halves quantization (the r1 q4 tier's 0.81-cosine failure mode)."""
    rng = np.random.default_rng(8)
    w = np.asarray(rng.normal(size=(256, 64)), np.float32)
    w[5, :] *= 30.0     # one outlier row per half: both K/2-half scales blow
    w[200, :] *= 30.0   # up, but only 2 of the 8 32-wide groups do
    qw_g = quant.quantize_w4(jnp.asarray(w))                    # gs=32
    qw_h = quant.quantize_w4(jnp.asarray(w), group_size=128)    # halves
    err_g = np.abs(np.asarray(quant.dequantize4(qw_g)) - w).mean()
    err_h = np.abs(np.asarray(quant.dequantize4(qw_h)) - w).mean()
    assert err_g < 0.5 * err_h, (err_g, err_h)


def test_w4_matmul_multigroup_matches_dequantized():
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.normal(size=(3, 128)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(128, 64)), jnp.float32)
    qw = quant.quantize_w4(w)
    assert qw.scale.shape == (4, 64)
    got = quant.matmul(x, qw)
    want = x @ quant.dequantize4(qw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_w4_matmul_matches_dequantized():
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(4, 64)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(64, 48)), jnp.float32)
    qw = quant.quantize_w4(w)
    got = quant.matmul(x, qw)
    want = x @ quant.dequantize4(qw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_w4_pipeline_end_to_end():
    import dataclasses
    cfg = dataclasses.replace(CFG, runtime=dataclasses.replace(CFG.runtime, quant="q4"))
    from qwen3tts_tpu.pipeline import Qwen3TTS
    tts = Qwen3TTS(cfg)
    assert tts.load_models(synthetic=True, seed=3)
    r = tts.synthesize("Hello.", SamplingConfig(temperature=0.0, top_k=0, max_audio_tokens=4))
    assert r.success, r.error_msg
    assert len(r.audio) == r.n_frames * 1920
    assert np.isfinite(np.asarray(r.audio)).all()
