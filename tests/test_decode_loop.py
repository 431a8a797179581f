"""End-to-end greedy generation parity: the on-device loop vs NumPy ref.

The strongest correctness check available without real weights: with identical
synthetic float32 weights, the jitted lax.while_loop generate() must emit the
exact same integer code sequence as a from-scratch NumPy float64 loop that
recomputes the whole sequence every frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import code_predictor as CP
from qwen3tts_tpu.models import talker as T
from qwen3tts_tpu.runtime import decode_loop as DL

import reference_impl as ref

CFG = tiny_pipeline_config()
TCFG, CCFG = CFG.talker, CFG.code_predictor


@pytest.fixture(scope="module")
def params():
    tp = T.init_talker_params(jax.random.PRNGKey(11), TCFG, jnp.float32)
    cp = CP.init_code_predictor_params(jax.random.PRNGKey(12), CCFG, jnp.float32)
    return tp, cp


def _run_jax(tp, cp, tokens, n_tok, max_frames, **kw):
    Tb = 16
    padded = np.zeros((Tb,), np.int32)
    padded[:n_tok] = tokens[:n_tok]
    return DL.generate_from_tokens(
        tp, cp, jnp.asarray(padded), jnp.int32(n_tok),
        jnp.zeros((TCFG.hidden_size,), jnp.float32), jnp.int32(TCFG.english_language_id),
        jax.random.PRNGKey(0),
        talker_cfg=TCFG, cp_cfg=CCFG, max_frames=max_frames,
        kv_capacity=10 + max_frames + 8, **kw)


def test_greedy_generation_matches_numpy_reference(params):
    tp, cp = params
    tokens = np.array([3, 7, 11, 42, 43, 44, 45, 5, 3, 7, 11], np.int32)  # 11 tokens
    res = _run_jax(tp, cp, tokens, len(tokens), max_frames=6,
                   temperature=0.0, top_k=0, repetition_penalty=1.05)
    want = ref.generate_greedy(tp, cp, TCFG, CCFG, tokens,
                               np.zeros(TCFG.hidden_size), TCFG.english_language_id, 6)
    n = int(res.n_frames)
    assert n == want.shape[0]
    got = np.asarray(res.codes[:n])
    mismatch = (got != want).mean() if n else 0.0
    # f32 vs f64 rounding can flip an argmax at a near-tie; demand near-exact.
    assert mismatch <= 0.05, f"code mismatch rate {mismatch:.3f}\n{got}\n{want}"


def test_codes_within_vocab_and_padding_zero(params):
    tp, cp = params
    tokens = np.arange(2, 13, dtype=np.int32)
    res = _run_jax(tp, cp, tokens, len(tokens), max_frames=8,
                   temperature=0.9, top_k=50, repetition_penalty=1.05)
    codes = np.asarray(res.codes)
    n = int(res.n_frames)
    assert (codes[:n, 0] >= 0).all() and (codes[:n, 0] < TCFG.codec_vocab_size - 1024).all()
    assert (codes[:n, 1:] >= 0).all() and (codes[:n, 1:] < CCFG.vocab_size).all()
    assert (codes[n:] == 0).all()


def test_sampled_generation_is_reproducible(params):
    tp, cp = params
    tokens = np.arange(2, 13, dtype=np.int32)
    a = _run_jax(tp, cp, tokens, len(tokens), max_frames=5,
                 temperature=0.9, top_k=50, repetition_penalty=1.05)
    b = _run_jax(tp, cp, tokens, len(tokens), max_frames=5,
                 temperature=0.9, top_k=50, repetition_penalty=1.05)
    np.testing.assert_array_equal(np.asarray(a.codes), np.asarray(b.codes))


def test_text_bucket_padding_is_invisible(params):
    """Same text padded into a larger bucket must generate identical codes."""
    tp, cp = params
    tokens = np.arange(2, 13, dtype=np.int32)
    kw = dict(talker_cfg=TCFG, cp_cfg=CCFG, max_frames=5, kv_capacity=23,
              temperature=0.0, top_k=0, repetition_penalty=1.05)
    outs = []
    for Tb in (16, 32):
        padded = np.zeros((Tb,), np.int32)
        padded[:len(tokens)] = tokens
        outs.append(DL.generate_from_tokens(
            tp, cp, jnp.asarray(padded), jnp.int32(len(tokens)),
            jnp.zeros((TCFG.hidden_size,), jnp.float32), jnp.int32(2050),
            jax.random.PRNGKey(0), **kw))
    np.testing.assert_array_equal(np.asarray(outs[0].codes), np.asarray(outs[1].codes))


def test_start_and_vocode_single_dispatch():
    """runtime/e2e.start_and_vocode (prefill + first chunk + vocoder in one
    program) matches generate_start + a separate vocoder call."""
    import numpy as np

    from qwen3tts_tpu.config import tiny_pipeline_config
    from qwen3tts_tpu.models import code_predictor as CP
    from qwen3tts_tpu.models import talker as T
    from qwen3tts_tpu.models import vocoder as V
    from qwen3tts_tpu.runtime import decode_loop as DL
    from qwen3tts_tpu.runtime.e2e import start_and_vocode

    CFG = tiny_pipeline_config()
    tp = T.init_talker_params(jax.random.PRNGKey(1), CFG.talker, jnp.float32)
    cp = CP.init_code_predictor_params(
        jax.random.PRNGKey(2), CFG.code_predictor, jnp.float32)
    vp = V.init_vocoder_params(jax.random.PRNGKey(3), CFG.vocoder, jnp.float32)
    tokens = np.zeros((16,), np.int32)
    tokens[:11] = np.arange(2, 13)
    args = (jnp.asarray(tokens), jnp.int32(11),
            jnp.zeros((CFG.talker.hidden_size,), jnp.float32),
            jnp.int32(2050), jax.random.PRNGKey(0))
    kw = dict(talker_cfg=CFG.talker, cp_cfg=CFG.code_predictor,
              chunk_frames=4, max_frames=8, kv_capacity=32,
              temperature=0.0, top_k=0, repetition_penalty=1.05,
              allow_eos=False)

    audio, state, prefill = start_and_vocode(
        tp, cp, vp, *args, vocoder_cfg=CFG.vocoder, **kw)
    state_ref, _ = DL.generate_start(tp, cp, *args, **kw)
    np.testing.assert_array_equal(np.asarray(state.codes),
                                  np.asarray(state_ref.codes))
    want = V.vocoder_forward(vp, CFG.vocoder, state_ref.codes[:4], jnp.int32(4))
    np.testing.assert_allclose(np.asarray(audio), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    assert np.isfinite(np.asarray(audio)).all()


@pytest.mark.parametrize("quant", [False, True])
def test_chunked_sampled_matches_one_shot(params, quant):
    """Streaming: the loop state handed across generate_init ->
    generate_chunk dispatch boundaries must reproduce the one-shot run
    exactly, sampled mode, plain and int8 weights."""
    tp, cp = params
    if quant:
        from qwen3tts_tpu.ops.quant import quantize_block_params

        tp = tp._replace(blocks=quantize_block_params(tp.blocks))
        cp = cp._replace(blocks=quantize_block_params(cp.blocks))
    Tb, maxF, KV = 16, 4, 32
    tokens = np.zeros((Tb,), np.int32)
    tokens[:12] = np.arange(2, 14)
    args = (jnp.asarray(tokens), jnp.int32(12),
            jnp.zeros((TCFG.hidden_size,), jnp.float32), jnp.int32(2050),
            jax.random.PRNGKey(5))
    samp = dict(temperature=0.8, top_k=50, top_p=0.95,
                repetition_penalty=1.05)

    one_shot = DL.generate_from_tokens(
        tp, cp, *args, talker_cfg=TCFG, cp_cfg=CCFG, max_frames=maxF,
        kv_capacity=KV, **samp)

    state, prefill = DL.generate_init(
        tp, cp, *args, talker_cfg=TCFG, cp_cfg=CCFG, max_frames=maxF,
        kv_capacity=KV)
    while not bool(state.done) and int(state.frame) < maxF:
        state = DL.generate_chunk(
            tp, cp, prefill, state, talker_cfg=TCFG, cp_cfg=CCFG,
            chunk_frames=2, max_frames=maxF, **samp)
    assert int(state.frame) == int(one_shot.n_frames)
    np.testing.assert_array_equal(np.asarray(state.codes),
                                  np.asarray(one_shot.codes))


def test_loop_dynamic_sampling_params_no_recompile(params):
    """Loop-level VERDICT r1 #5 guarantee: changing temperature / top_p /
    repetition_penalty VALUES between generate_from_tokens calls reuses the
    same compiled program (they ride as traced scalars)."""
    tp, cp = params
    tokens = jnp.asarray([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 0, 0, 0, 0, 0, 0],
                         jnp.int32)
    kw = dict(talker_cfg=TCFG, cp_cfg=CCFG, max_frames=3, kv_capacity=32,
              top_k=8, nothink=False, allow_eos=False)
    args = (tokens, jnp.int32(10), jnp.zeros((TCFG.hidden_size,), jnp.float32),
            jnp.int32(TCFG.english_language_id), jax.random.PRNGKey(0))
    DL.generate_from_tokens(
        tp, cp, *args, temperature=0.7, top_p=0.9, repetition_penalty=1.05,
        **kw)
    n0 = DL._generate_from_tokens_jit._cache_size()
    DL.generate_from_tokens(
        tp, cp, *args, temperature=1.3, top_p=0.5, repetition_penalty=1.4,
        **kw)
    assert DL._generate_from_tokens_jit._cache_size() == n0


def test_batched_budgets_truncate_exactly(params):
    """Per-lane `budgets` (EOS emulation for the static batched path —
    benchmark_arrivals' online static server): every lane must emit
    exactly its budget, and those codes must equal the unbudgeted run's
    first budget frames lane-for-lane (the budget latch only masks
    emissions, it never perturbs another lane's sampling)."""
    tp, cp = params
    B, Tb, maxF = 3, 16, 6
    rng = np.random.default_rng(3)
    tokens = np.zeros((B, Tb), np.int32)
    for b in range(B):
        tokens[b, :11] = rng.integers(2, 50, size=11)
    args = (jnp.asarray(tokens), jnp.full((B,), 11, jnp.int32),
            jnp.zeros((B, TCFG.hidden_size), jnp.float32),
            jnp.full((B,), 2050, jnp.int32),
            jax.random.split(jax.random.PRNGKey(4), B))
    kw = dict(talker_cfg=TCFG, cp_cfg=CCFG, max_frames=maxF, kv_capacity=32,
              temperature=0.9, top_k=5, repetition_penalty=1.05,
              allow_eos=False)
    full = DL.generate_from_tokens_batched(tp, cp, *args, **kw)
    budgets = np.array([2, 6, 4], np.int32)
    capped = DL.generate_from_tokens_batched(
        tp, cp, *args, budgets=jnp.asarray(budgets), **kw)
    np.testing.assert_array_equal(np.asarray(capped.n_frames), budgets)
    for b in range(B):
        np.testing.assert_array_equal(
            np.asarray(capped.codes[b, : budgets[b]]),
            np.asarray(full.codes[b, : budgets[b]]))


def _lanes(B, Tb=16, seed=3):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((B, Tb), np.int32)
    n_tok = rng.integers(10, Tb, size=B).astype(np.int32)
    for b in range(B):
        tokens[b, : n_tok[b]] = rng.integers(2, 90, size=n_tok[b])
    return tokens, n_tok


@pytest.mark.parametrize("tier", ["f32", "int8"])
@pytest.mark.parametrize("sampling", [
    dict(temperature=0.0, top_k=0),
    dict(temperature=0.9, top_k=5),
    dict(temperature=0.8, top_k=50, top_p=0.7),
])
def test_batched_loop_matches_single_stream(params, tier, sampling):
    """Lane b of the batched loop (shared write column, one-hot cb0
    embedding, vmapped predictor and carried talker step, per-lane key
    chains) emits exactly generate_from_tokens(keys[b])'s codes and frame
    count — greedy and sampled, with EOS live."""
    tp, cp = params
    if tier == "int8":
        from qwen3tts_tpu.ops.quant import quantize_block_params

        tp = tp._replace(blocks=quantize_block_params(tp.blocks))
        cp = cp._replace(blocks=quantize_block_params(cp.blocks))
    B, maxF, KV = 3, 6, 32
    tokens, n_tok = _lanes(B)
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    kw = dict(talker_cfg=TCFG, cp_cfg=CCFG, max_frames=maxF, kv_capacity=KV,
              repetition_penalty=1.05, **sampling)
    speaker = np.zeros((B, TCFG.hidden_size), np.float32)
    batched = DL.generate_from_tokens_batched(
        tp, cp, jnp.asarray(tokens), jnp.asarray(n_tok), jnp.asarray(speaker),
        jnp.full((B,), 2050, jnp.int32), keys, **kw)
    for b in range(B):
        one = DL.generate_from_tokens(
            tp, cp, jnp.asarray(tokens[b]), jnp.int32(n_tok[b]),
            jnp.asarray(speaker[b]), jnp.int32(2050), keys[b], **kw)
        assert int(batched.n_frames[b]) == int(one.n_frames)
        np.testing.assert_array_equal(np.asarray(batched.codes[b]),
                                      np.asarray(one.codes), err_msg=f"lane {b}")
        np.testing.assert_allclose(np.asarray(batched.hidden[b]),
                                   np.asarray(one.hidden), rtol=1e-5, atol=1e-5)


def test_batched_rest_embedding_sum_matches_single(params):
    """_rest_embd_sum over [B, 15] codes == per-lane [15] sums."""
    _, cp = params
    rest = jnp.asarray(np.random.default_rng(0).integers(
        0, CCFG.vocab_size, size=(4, CCFG.n_steps)), jnp.int32)
    got = DL._rest_embd_sum(cp, CCFG, rest)
    for b in range(4):
        np.testing.assert_allclose(np.asarray(got[b]),
                                   np.asarray(DL._rest_embd_sum(cp, CCFG, rest[b])),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_vmapped_predictor_lane_equals_single(params, temperature):
    """The batched loop vmaps predict_codes with each lane's key; lane b
    must equal the single-stream call with that key."""
    from qwen3tts_tpu.models import code_predictor as cp_model

    tp, cp = params
    rng = np.random.default_rng(1)
    h = jnp.asarray(rng.normal(size=(3, CCFG.hidden_size)), jnp.float32)
    e = tp.codec_embd[jnp.asarray([4, 77, 1500])]
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    kw = dict(temperature=temperature, top_k=20)
    got = jax.vmap(lambda hh, ee, kk: cp_model.predict_codes(
        cp, CCFG, hh, ee, kk, **kw))(h, e, keys)
    for b in range(3):
        one = cp_model.predict_codes(cp, CCFG, h[b], e[b], keys[b], **kw)
        np.testing.assert_array_equal(np.asarray(got[b]), np.asarray(one))
