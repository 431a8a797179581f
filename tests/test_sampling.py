"""Sampling-op semantics vs the reference CLI rules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qwen3tts_tpu.ops import sampling as S


def test_suppression_masks_tail_except_eos():
    logits = jnp.zeros((3072,))
    out = np.asarray(S.apply_suppression(logits, 2048, 2150))
    assert (out[:2048] == 0).all()
    assert out[2150] == 0
    masked = np.delete(out[2048:], 2150 - 2048)
    assert (masked <= -1e29).all()


def test_repetition_penalty_hf_semantics():
    logits = jnp.array([2.0, -2.0, 1.0, -1.0])
    seen = jnp.array([True, True, False, False])
    out = np.asarray(S.apply_repetition_penalty(logits, seen, 1.25))
    np.testing.assert_allclose(out, [2.0 / 1.25, -2.0 * 1.25, 1.0, -1.0], rtol=1e-6)


def test_top_k_threshold_keeps_ties():
    logits = jnp.array([5.0, 4.0, 4.0, 1.0, 0.0])
    out = np.asarray(S.apply_top_k(logits, 2))
    # threshold = 2nd largest = 4.0; both 4.0s survive (reference partial_sort
    # semantics: only values strictly below threshold are masked)
    assert out[0] == 5.0 and out[1] == 4.0 and out[2] == 4.0
    assert out[3] <= -1e29 and out[4] <= -1e29


def test_top_p_keeps_crossing_token():
    logits = jnp.log(jnp.array([0.5, 0.3, 0.15, 0.05]))
    out = np.asarray(S.apply_top_p(logits, 0.7))
    assert np.isfinite(out[0]) and np.isfinite(out[1])
    assert out[2] <= -1e29 and out[3] <= -1e29


def test_greedy_matches_argmax_and_temperature_zero():
    key = jax.random.PRNGKey(0)
    logits = jnp.array([0.1, 3.0, 2.9, -1.0])
    tok = S.sample_token(key, logits, temperature=0.0, top_k=0)
    assert int(tok) == 1


def test_sampling_respects_topk_support():
    key = jax.random.PRNGKey(0)
    logits = jnp.array([10.0, 9.0, -5.0, -6.0, -7.0])
    toks = [int(S.sample_token(jax.random.fold_in(key, i), logits,
                               temperature=1.0, top_k=2)) for i in range(64)]
    assert set(toks) <= {0, 1}
    assert len(set(toks)) == 2  # both supported tokens appear


def test_sampling_distribution_roughly_matches_softmax():
    key = jax.random.PRNGKey(42)
    logits = jnp.array([1.0, 0.0, -1.0])
    n = 4000
    keys = jax.random.split(key, n)
    toks = jax.vmap(lambda k: S.sample_token(k, logits, temperature=1.0, top_k=0))(keys)
    counts = np.bincount(np.asarray(toks), minlength=3) / n
    probs = np.asarray(jax.nn.softmax(logits))
    np.testing.assert_allclose(counts, probs, atol=0.05)


@pytest.mark.parametrize("top_p", [0.3, 0.8])
def test_xla_top_p_bsearch_matches_sort_formulation(top_p):
    """ops/sampling.apply_top_p (binary search) == the sort-based nucleus
    definition (keep tokens whose preceding cumulative mass < top_p)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(5, 257)).astype(np.float32) * 3.0
    got = np.asarray(S.apply_top_p(jnp.asarray(logits), top_p))
    for r in range(logits.shape[0]):
        row = logits[r].astype(np.float64)
        order = np.argsort(-row)
        probs = np.exp(row - row.max())
        probs /= probs.sum()
        cum = np.cumsum(probs[order])
        keep_sorted = (cum - probs[order]) < top_p
        keep = np.zeros(row.shape, bool)
        keep[order[keep_sorted]] = True
        masked = got[r] <= S.NEG_INF / 2
        np.testing.assert_array_equal(~masked, keep, err_msg=f"row {r}")


@pytest.mark.parametrize("top_k", [1, 3, 10])
def test_sampled_tokens_stay_in_top_k(top_k):
    rng = np.random.default_rng(top_k)
    logits = jnp.asarray(rng.normal(size=(64,)) * 2.0, jnp.float32)
    allowed = set(np.argsort(-np.asarray(logits))[:top_k].tolist())
    keys = jax.random.split(jax.random.PRNGKey(top_k), 200)
    toks = jax.vmap(lambda k: S.sample_token(k, logits, temperature=1.5,
                                             top_k=top_k))(keys)
    assert set(np.asarray(toks).tolist()) <= allowed


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiny_top_p_is_greedy(seed):
    rng = np.random.default_rng(seed)
    logits = jnp.asarray(rng.normal(size=(97,)) * 2.0, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), 32)
    toks = jax.vmap(lambda k: S.sample_token(k, logits, temperature=1.0,
                                             top_k=0, top_p=1e-6))(keys)
    assert (np.asarray(toks) == int(jnp.argmax(logits))).all()


def test_sampling_values_never_recompile():
    """temperature / top_p ride as traced scalars within a stage class."""
    f = jax.jit(lambda k, l, t, p: S.sample_token(
        k, l, temperature=t, top_k=5, top_p=p, greedy=False, use_top_p=True))
    logits = jnp.linspace(-1.0, 1.0, 33)
    f(jax.random.PRNGKey(0), logits, 0.7, 0.9)
    n = f._cache_size()
    for t, p in ((1.3, 0.5), (0.2, 0.99), (2.0, 0.1)):
        f(jax.random.PRNGKey(1), logits, t, p)
    assert f._cache_size() == n


@pytest.mark.parametrize("temperature,top_p", [(0.0, 1.0), (0.9, 1.0), (0.9, 0.7)])
def test_batched_lanes_equal_single_stream(temperature, top_p):
    """Lane b of a vmapped sampler with keys[b] draws what a single call
    with keys[b] draws (the batched decode loops rely on this)."""
    rng = np.random.default_rng(5)
    rows = jnp.asarray(rng.normal(size=(6, 50)) * 2.0, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), 6)
    batched = jax.vmap(lambda k, r: S.sample_token(
        k, r, temperature=temperature, top_k=8, top_p=top_p))(keys, rows)
    for b in range(6):
        one = S.sample_token(keys[b], rows[b], temperature=temperature,
                             top_k=8, top_p=top_p)
        assert int(batched[b]) == int(one)


@pytest.mark.parametrize("temperature,top_p,want", [
    (0.0, 1.0, (True, False)), (-1.0, 0.5, (True, True)),
    (0.9, 1.0, (False, False)), (0.9, 0.95, (False, True)),
    (jnp.float32(0.9), jnp.float32(1.0), (False, True)),  # traced: dynamic
])
def test_sampling_flags(temperature, top_p, want):
    assert S.sampling_flags(temperature, top_p) == want
