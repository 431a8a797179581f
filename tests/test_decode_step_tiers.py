"""The XLA talker decode step at every weight tier, single stream and
vmapped lanes, against the NumPy float64 reference (tests/reference_impl.py)
run on the same (dequantized) weights.

Tolerances: the f32 and weight-only quantized tiers compute in f32, so only
f32 rounding separates them from the f64 reference (rtol 2e-3). The bf16
tier also rounds activations to bf16 at every layer boundary (8 bits of
mantissa, relative error ~4e-3 per op): 4e-2 of the logits' scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import talker as T
from qwen3tts_tpu.ops.quant import (QuantLinear, QuantLinear4, dequantize,
                                    dequantize4, quantize_talker_blocks)

import reference_impl as ref

TCFG = tiny_pipeline_config().talker
TIERS = ["f32", "bf16", "int8", "q4", "q4pure"]
TOL = {"f32": 2e-3, "bf16": 4e-2, "int8": 2e-3, "q4": 2e-3, "q4pure": 2e-3}
CAPACITY = 40


@pytest.fixture(scope="module")
def base():
    return T.init_talker_params(jax.random.PRNGKey(5), TCFG, jnp.float32)


def _tier(params, tier):
    if tier == "f32":
        return params
    if tier == "bf16":
        return jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    return params._replace(blocks=quantize_talker_blocks(params.blocks, tier))


def _dequantized(params):
    def f(x):
        if isinstance(x, QuantLinear):
            return np.asarray(dequantize(x, jnp.float32))
        if isinstance(x, QuantLinear4):
            return np.asarray(dequantize4(x, jnp.float32))
        return np.asarray(jnp.asarray(x, jnp.float32))
    return jax.tree.map(f, params, is_leaf=lambda x: isinstance(
        x, (QuantLinear, QuantLinear4)))


def _step_logits(params, seq, strategy):
    """Feed seq [n, H] one step at a time from position 0; return the last
    step's logits."""
    dtype = params.codec_embd.dtype
    kv = T.make_kv_cache(TCFG, CAPACITY, dtype)

    def body(carry, e):
        kv, n = carry
        _, logits, kv = T.talker_step(params, TCFG, e.astype(dtype), n, kv,
                                      strategy=strategy)
        return (kv, n + 1), logits

    _, logits = lax.scan(body, (kv, jnp.int32(0)), seq)
    return logits[-1]


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("position", [0, 7, 31])
@pytest.mark.parametrize("tier", TIERS)
def test_decode_step_matches_reference(base, tier, position, lanes):
    params = _tier(base, tier)
    rng = np.random.default_rng(100 * position + lanes)
    seqs = (rng.normal(size=(lanes, position + 1, TCFG.hidden_size))
            * 0.3).astype(np.float32)
    if tier == "bf16":   # the reference sees the values the step sees
        seqs = np.asarray(jnp.asarray(seqs, jnp.bfloat16), np.float32)
    if lanes == 1:
        got = jax.jit(lambda p, s: _step_logits(p, s, "auto"))(
            params, jnp.asarray(seqs[0]))[None]
    else:   # the batched loop's shape: vmapped lanes, carried cache
        got = jax.jit(jax.vmap(lambda s, p=params: _step_logits(
            p, s, "carried")))(jnp.asarray(seqs))
    ref_params = _dequantized(params)
    for b in range(lanes):
        _, want = ref.talker_logits_full(ref_params, TCFG, seqs[b])
        want = want[-1]
        tol = TOL[tier]
        np.testing.assert_allclose(
            np.asarray(got[b], np.float64), want, rtol=tol,
            atol=tol * float(np.abs(want).max()), err_msg=f"lane {b}")
