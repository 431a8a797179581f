"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Verifies that tp/dp-sharded batched generation compiles, runs, and produces
the same greedy codes as the unsharded single-device path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import code_predictor as CP
from qwen3tts_tpu.models import talker as T
from qwen3tts_tpu.parallel import mesh as mesh_mod
from qwen3tts_tpu.parallel import shardings
from qwen3tts_tpu.runtime import decode_loop as DL

CFG = tiny_pipeline_config()
TCFG, CCFG = CFG.talker, CFG.code_predictor


@pytest.fixture(scope="module")
def params():
    tp = T.init_talker_params(jax.random.PRNGKey(11), TCFG, jnp.float32)
    cp = CP.init_code_predictor_params(jax.random.PRNGKey(12), CCFG, jnp.float32)
    return tp, cp


def _batch_inputs(B, Tb=16):
    rng = np.random.default_rng(0)
    tokens = np.zeros((B, Tb), np.int32)
    n_tok = np.full((B,), 11, np.int32)
    for b in range(B):
        tokens[b, :11] = rng.integers(2, 100, size=11)
    speaker = rng.normal(size=(B, TCFG.hidden_size)).astype(np.float32) * 0.1
    lang = np.full((B,), 2050, np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    return tokens, n_tok, speaker, lang, keys


KW = dict(talker_cfg=TCFG, cp_cfg=CCFG, max_frames=4, kv_capacity=22,
          temperature=0.0, top_k=0, repetition_penalty=1.05)


def test_batched_matches_single(params):
    tp, cp = params
    tokens, n_tok, speaker, lang, keys = _batch_inputs(3)
    batched = DL.generate_from_tokens_batched(
        tp, cp, jnp.asarray(tokens), jnp.asarray(n_tok), jnp.asarray(speaker),
        jnp.asarray(lang), keys, **KW)
    for b in range(3):
        single = DL.generate_from_tokens(
            tp, cp, jnp.asarray(tokens[b]), jnp.asarray(n_tok[b]),
            jnp.asarray(speaker[b]), jnp.asarray(lang[b]), keys[b], **KW)
        assert int(batched.n_frames[b]) == int(single.n_frames)
        np.testing.assert_array_equal(np.asarray(batched.codes[b]), np.asarray(single.codes))


@pytest.mark.parametrize("dp,tp_size", [(1, 2), (2, 2), (4, 2), (2, 4), (1, 8)])
def test_sharded_generation_matches_unsharded(params, dp, tp_size):
    tp_params, cp_params = params
    mesh = mesh_mod.make_mesh(dp, tp_size)
    B = max(2, dp)
    tokens, n_tok, speaker, lang, keys = _batch_inputs(B)

    base = DL.generate_from_tokens_batched(
        tp_params, cp_params, jnp.asarray(tokens), jnp.asarray(n_tok),
        jnp.asarray(speaker), jnp.asarray(lang), keys, **KW)

    tps = shardings.shard_params(tp_params, shardings.talker_specs(), mesh)
    cps = shardings.shard_params(cp_params, shardings.code_predictor_specs(), mesh)
    dsh = NamedSharding(mesh, P("dp"))
    rep = NamedSharding(mesh, P())
    sharded = DL.generate_from_tokens_batched(
        tps, cps,
        jax.device_put(jnp.asarray(tokens), dsh),
        jax.device_put(jnp.asarray(n_tok), dsh),
        jax.device_put(jnp.asarray(speaker), dsh),
        jax.device_put(jnp.asarray(lang), dsh),
        jax.device_put(keys, dsh),
        **KW)

    np.testing.assert_array_equal(np.asarray(base.n_frames), np.asarray(sharded.n_frames))
    np.testing.assert_array_equal(np.asarray(base.codes), np.asarray(sharded.codes))


@pytest.mark.parametrize("dp,tp_size", [(2, 2), (4, 2)])
def test_sharded_continuous_serving_matches_unsharded(params, dp, tp_size):
    """Multi-chip continuous batching: the scheduler with dp-sharded lane
    state + tp-sharded weights produces exactly the unsharded scheduler's
    codes on the same request queue (mid-flight refills, splices, and
    capacity handling included)."""
    from qwen3tts_tpu.runtime.continuous import ContinuousScheduler

    tp_params, cp_params = params
    reqs = []
    rng = np.random.default_rng(4)
    for i, budget in enumerate([3, 5, 2, 4, 3, 2]):
        nt = int(rng.integers(10, 15))
        reqs.append((rng.integers(2, 90, nt).astype(np.int32), nt, budget))

    def run(tps, cps, mesh):
        sched = ContinuousScheduler(
            tps, cps, TCFG, CCFG, lanes=max(2, dp), kv_capacity=30,
            text_bucket=16, chunk_frames=2, refill_slots=2, max_frames=6,
            temperature=0.0, top_k=0, repetition_penalty=1.05,
            allow_eos=False, mesh=mesh)
        rids = [sched.submit(t, n, np.zeros((TCFG.hidden_size,)), 2050,
                             seed=100 + i, max_frames=b)
                for i, (t, n, b) in enumerate(reqs)]
        out = sched.run()
        return [out[r] for r in rids]

    base = run(tp_params, cp_params, None)
    mesh = mesh_mod.make_mesh(dp, tp_size)
    tps = shardings.shard_params(tp_params, shardings.talker_specs(), mesh)
    cps = shardings.shard_params(cp_params, shardings.code_predictor_specs(), mesh)
    got = run(tps, cps, mesh)
    for b, g in zip(base, got):
        np.testing.assert_array_equal(b, g)


@pytest.mark.parametrize("quant", ["int8", "w4", "q4"])
def test_sharded_quantized_generation_matches_unsharded(params, quant):
    """Production int8/w4 configurations must shard too: QuantLinear and
    QuantLinear4 leaves take the matrix spec on q and scales, with
    non-dividing scale dims falling back to replicated. q4 is the shipped
    mixed tier (attention int8, FFN u4; the code predictor stays int8)."""
    from qwen3tts_tpu.ops.quant import (
        quantize_block_params, quantize_block_params_mixed,
        quantize_block_params_w4)

    tp_params, cp_params = params
    qfn = {"int8": quantize_block_params, "w4": quantize_block_params_w4,
           "q4": quantize_block_params_mixed}[quant]
    tq = tp_params._replace(blocks=qfn(tp_params.blocks))
    cq = cp_params._replace(blocks=(quantize_block_params if quant == "q4"
                                    else qfn)(cp_params.blocks))

    mesh = mesh_mod.make_mesh(2, 2)
    B = 2
    tokens, n_tok, speaker, lang, keys = _batch_inputs(B)

    base = DL.generate_from_tokens_batched(
        tq, cq, jnp.asarray(tokens), jnp.asarray(n_tok),
        jnp.asarray(speaker), jnp.asarray(lang), keys, **KW)

    tps = shardings.shard_params(tq, shardings.talker_specs(), mesh)
    cps = shardings.shard_params(cq, shardings.code_predictor_specs(), mesh)
    # the quantized values ARE distributed (output/head dim over tp)
    assert len({s.data.shape for s in tps.blocks.wqkv.q.addressable_shards}) == 1
    qshape = next(iter({s.data.shape for s in tps.blocks.wqkv.q.addressable_shards}))
    assert qshape[-1] == tq.blocks.wqkv.q.shape[-1] // 2

    dsh = NamedSharding(mesh, P("dp"))
    sharded = DL.generate_from_tokens_batched(
        tps, cps,
        jax.device_put(jnp.asarray(tokens), dsh),
        jax.device_put(jnp.asarray(n_tok), dsh),
        jax.device_put(jnp.asarray(speaker), dsh),
        jax.device_put(jnp.asarray(lang), dsh),
        jax.device_put(keys, dsh),
        **KW)

    np.testing.assert_array_equal(np.asarray(base.n_frames), np.asarray(sharded.n_frames))
    np.testing.assert_array_equal(np.asarray(base.codes), np.asarray(sharded.codes))


def test_tp_sharding_actually_distributes(params):
    tp_params, _ = params
    mesh = mesh_mod.make_mesh(1, 4)
    tps = shardings.shard_params(tp_params, shardings.talker_specs(), mesh)
    # fused qkv output dim is split 4 ways
    shard_shapes = {s.data.shape for s in tps.blocks.wqkv.addressable_shards}
    L, H, O = tp_params.blocks.wqkv.shape
    assert shard_shapes == {(L, H, O // 4)}


def test_batched_vocoder_under_dp_mesh():
    """The serving vocoder over dp-sharded lanes (replicated weights) equals
    the unsharded batched vocoder and stays finite."""
    from qwen3tts_tpu.models import vocoder as V

    vcfg = CFG.vocoder
    vp = V.init_vocoder_params(jax.random.PRNGKey(3), vcfg, jnp.float32)
    codes = jax.random.randint(jax.random.PRNGKey(4), (4, 8, vcfg.n_codebooks),
                               0, vcfg.codebook_size)
    n = jnp.asarray([8, 5, 3, 8], jnp.int32)
    decode = jax.jit(jax.vmap(lambda p, c, k: V.vocoder_forward(p, vcfg, c, k),
                              in_axes=(None, 0, 0)))
    base = np.asarray(decode(vp, codes, n))
    mesh = mesh_mod.make_mesh(4, 1)
    dsh = NamedSharding(mesh, P("dp"))
    got = np.asarray(decode(jax.device_put(vp, NamedSharding(mesh, P())),
                            jax.device_put(codes, dsh), jax.device_put(n, dsh)))
    assert np.isfinite(got).all()
    # one lane per device against four lanes in one program: f32 sums run
    # in another order, and Snake amplifies the rounding (~1.5e-4 seen)
    np.testing.assert_allclose(got, base, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("placement,want", [
    ("local", True), ("params_replicated", False), ("lanes_sharded", False)])
def test_mesh_programs_leave_out_the_kernel(params, monkeypatch, placement, want):
    """generate_from_tokens_batched allows the decode-attention kernel only
    when nothing spans several devices (pallas_call has no partitioning
    rule)."""
    tp_params, cp_params = params
    tokens, n_tok, speaker, lang, keys = _batch_inputs(2)
    tokens = jnp.asarray(tokens)
    mesh = mesh_mod.make_mesh(2, 1)
    if placement == "params_replicated":
        tp_params = jax.device_put(tp_params, NamedSharding(mesh, P()))
    elif placement == "lanes_sharded":
        tokens = jax.device_put(tokens, NamedSharding(mesh, P("dp")))
    seen = {}

    def spy(*args, **kw):
        seen.update(kw)

    monkeypatch.setattr(DL, "_generate_from_tokens_batched_jit", spy)
    DL.generate_from_tokens_batched(
        tp_params, cp_params, tokens, jnp.asarray(n_tok), jnp.asarray(speaker),
        jnp.asarray(lang), keys, **KW)
    assert seen["attn_kernel"] is want
