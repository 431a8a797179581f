"""Split-K decode-attention kernel (Pallas, Triton route) vs the XLA
reference, in interpret mode on the CPU; and the wrapper's choice of kernel.

Tolerances: float32 inputs run the kernel's dots at HIGHEST precision, so
the only difference is summation order (online softmax across blocks and
splits): 2e-5. bfloat16 inputs round the probabilities to bf16 before the
PV product on both paths, in different block orders: 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from qwen3tts_tpu.ops import attention as A
from qwen3tts_tpu.ops.attention import decode_attention
from qwen3tts_tpu.ops.pallas_attention import (
    decode_attention_pallas, decode_attention_pallas_layered, num_splits)


def _qkv(seed, Hq, Hkv, D, C, dtype=jnp.float32, lead=()):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.normal(size=lead + (Hq, D)), dtype)
    k = jnp.asarray(rng.normal(size=lead + (Hkv, C, D)), dtype)
    v = jnp.asarray(rng.normal(size=lead + (Hkv, C, D)), dtype)
    return q, k, v


@pytest.mark.parametrize("n_valid", [1, 5, 127, 128, 129, 200, 256])
def test_matches_xla_reference(n_valid):
    q, k, v = _qkv(n_valid, 16, 8, 128, 256)
    want = decode_attention(q, k, v, jnp.int32(n_valid))
    got = decode_attention_pallas(q, k, v, jnp.int32(n_valid), interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_garbage_beyond_valid_is_ignored():
    q, k, v = _qkv(0, 4, 2, 128, 256)
    a = decode_attention_pallas(q, k, v, jnp.int32(100), interpret=True)
    k2 = k.at[:, 100:].set(1e4)
    v2 = v.at[:, 100:].set(-1e4)
    b = decode_attention_pallas(q, k2, v2, jnp.int32(100), interpret=True)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_inputs():
    q, k, v = _qkv(3, 16, 8, 128, 128, jnp.bfloat16)
    want = decode_attention(q, k, v, jnp.int32(77))
    got = decode_attention_pallas(q, k, v, jnp.int32(77), block_k=32, interpret=True)
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_vmap_over_kernel_matches_reference():
    """Batched serving vmaps the decode attention; the Pallas batching rule
    must agree with the XLA path per lane."""
    q, k, v = _qkv(9, 16, 8, 128, 256, lead=(3,))
    n = jnp.asarray([10, 100, 256], jnp.int32)
    got = jax.vmap(lambda q, k, v, n: decode_attention_pallas(
        q, k, v, n, interpret=True))(q, k, v, n)
    want = jax.vmap(decode_attention)(q, k, v, n)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-5, atol=3e-5)


def test_layered_kernel_matches_reference():
    rng = np.random.default_rng(12)
    L, Hq, Hkv, D, C = 3, 16, 8, 128, 256
    kv = jnp.asarray(rng.normal(size=(L, 2, Hkv, C, D)), jnp.float32)
    q = jnp.asarray(rng.normal(size=(Hq, D)), jnp.float32)
    for li in range(L):
        for n in (1, 130, 256):
            want = decode_attention(q, kv[li, 0], kv[li, 1], jnp.int32(n))
            got = decode_attention_pallas_layered(
                q, kv, jnp.int32(li), jnp.int32(n), block_k=128, interpret=True)
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=2e-5, atol=2e-5)


def test_layered_kernel_under_vmap():
    rng = np.random.default_rng(13)
    B, L, Hq, Hkv, D, C = 2, 2, 16, 8, 128, 256
    kv = jnp.asarray(rng.normal(size=(B, L, 2, Hkv, C, D)), jnp.float32)
    q = jnp.asarray(rng.normal(size=(B, Hq, D)), jnp.float32)
    li = jnp.asarray([0, 1], jnp.int32)
    n = jnp.asarray([100, 256], jnp.int32)
    got = jax.vmap(lambda q, kv, li, n: decode_attention_pallas_layered(
        q, kv, li, n, block_k=128, interpret=True))(q, kv, li, n)
    want = jax.vmap(lambda q, kv, li, n: decode_attention(
        q, kv[li, 0], kv[li, 1], n))(q, kv, li, n)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5, atol=2e-5)


# --- split boundaries: n_valid on, just before and just after the edges of
# blocks and splits, for several split counts -------------------------------

@pytest.mark.parametrize("splits,n_valid", [
    (1, 96), (2, 63), (2, 64), (2, 65), (4, 31), (4, 32), (4, 33),
    (8, 16), (8, 17), (8, 128)])
def test_split_boundaries(splits, n_valid):
    q, k, v = _qkv(splits * 1000 + n_valid, 8, 4, 32, 128)
    want = decode_attention(q, k, v, jnp.int32(n_valid))
    got = decode_attention_pallas(q, k, v, jnp.int32(n_valid), block_k=16,
                                  splits=splits, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("start,n_valid", [
    (0, 50), (10, 50), (15, 17), (16, 17), (33, 128), (64, 65), (100, 128)])
def test_start_masks_stale_rows(start, n_valid):
    """Continuous batching: rows below a lane's splice point are stale."""
    q, k, v = _qkv(start + 7 * n_valid, 8, 4, 32, 128)
    want = decode_attention(q, k, v, jnp.int32(n_valid), jnp.int32(start))
    got = decode_attention_pallas(q, k, v, jnp.int32(n_valid),
                                  jnp.int32(start), block_k=16, splits=4,
                                  interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_layered_vmapped_lanes_with_start():
    """The continuous scheduler's shape: a shared layer index and write
    column (unbatched) with per-lane starts (batched)."""
    rng = np.random.default_rng(21)
    B, L, Hq, Hkv, D, C = 3, 2, 8, 4, 32, 128
    kv = jnp.asarray(rng.normal(size=(B, L, 2, Hkv, C, D)), jnp.float32)
    q = jnp.asarray(rng.normal(size=(B, Hq, D)), jnp.float32)
    starts = jnp.asarray([0, 40, 90], jnp.int32)
    got = jax.vmap(lambda q, kv, s: decode_attention_pallas_layered(
        q, kv, 1, 100, s, block_k=16, interpret=True))(q, kv, starts)
    want = jax.vmap(lambda q, kv, s: decode_attention(
        q, kv[1, 0], kv[1, 1], 100, s))(q, kv, starts)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_layered_bf16():
    rng = np.random.default_rng(22)
    L, Hq, Hkv, D, C = 2, 16, 8, 64, 128
    kv = jnp.asarray(rng.normal(size=(L, 2, Hkv, C, D)), jnp.bfloat16)
    q = jnp.asarray(rng.normal(size=(Hq, D)), jnp.bfloat16)
    want = decode_attention(q, kv[1, 0], kv[1, 1], jnp.int32(90))
    got = decode_attention_pallas_layered(q, kv, 1, jnp.int32(90), block_k=32,
                                          interpret=True)
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_output_dtype_and_shape():
    q, k, v = _qkv(5, 16, 8, 64, 128, jnp.bfloat16)
    got = decode_attention_pallas(q, k, v, jnp.int32(9), block_k=32, interpret=True)
    assert got.shape == (16, 64) and got.dtype == jnp.bfloat16


@pytest.mark.parametrize("capacity,block_k,want", [
    (1024, 64, 16), (2304, 64, 18), (4352, 64, 17), (512, 64, 8),
    (256, 16, 16)])
def test_num_splits_divides_blocks(capacity, block_k, want):
    s = num_splits(capacity, block_k)
    assert s == want
    assert (capacity // block_k) % s == 0


def test_capacity_must_tile():
    q, k, v = _qkv(1, 4, 2, 32, 100)
    with pytest.raises(AssertionError):
        decode_attention_pallas(q, k, v, jnp.int32(5), block_k=16, interpret=True)


# --- the wrapper's choice ---------------------------------------------------

@pytest.mark.parametrize("capacity,head_dim,hq,hkv,dtype,want", [
    (4352, 128, 16, 8, jnp.bfloat16, True),
    (1024, 128, 16, 8, jnp.float32, True),
    (512, 128, 16, 8, jnp.bfloat16, False),        # below MIN_KERNEL_CAPACITY
    (4100, 128, 16, 8, jnp.bfloat16, False),       # not a whole number of blocks
    (4352, 96, 16, 8, jnp.bfloat16, False),        # head_dim not a power of two
    (4352, 128, 64, 2, jnp.bfloat16, False),       # query group above 16 rows
    (4352, 128, 16, 8, jnp.float8_e4m3fn, False),  # fp8 cache
])
def test_kernel_choice_by_shape(capacity, head_dim, hq, hkv, dtype, want):
    assert A.kernel_fits(capacity, head_dim, hq, hkv, dtype) is want


def test_kernel_off_inside_multi_device_programs():
    assert A.kernel_fits(4352, 128, 16, 8, jnp.bfloat16)
    with A.kernel_allowed(False):
        assert not A.kernel_fits(4352, 128, 16, 8, jnp.bfloat16)
        with A.kernel_allowed(True):
            assert A.kernel_fits(4352, 128, 16, 8, jnp.bfloat16)
    assert A.kernel_fits(4352, 128, 16, 8, jnp.bfloat16)


def _lowered(fn, platform, *args):
    return jax.jit(fn).trace(*args).lower(lowering_platforms=(platform,)).as_text()


TRITON = "xla.gpu.triton"


@pytest.mark.parametrize("capacity,platform,allowed,want", [
    (1024, "cuda", True, True),     # the kernel, lowered for the card
    (1024, "cpu", True, False),     # other platforms lower the einsum
    (512, "cuda", True, False),     # small cache: einsum
    (1024, "cuda", False, False),   # multi-device program: einsum
])
def test_platform_lowering_of_the_talker_step(capacity, platform, allowed, want):
    """The carried talker step at a tiny width: which attention each
    platform's lowering holds (the Triton custom call or none)."""
    from qwen3tts_tpu.config import TalkerConfig
    from qwen3tts_tpu.models import talker as T

    cfg = TalkerConfig(text_vocab_size=64, text_embd_dim=16, hidden_size=32,
                       n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
                       intermediate_size=32)
    tp = T.init_talker_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    kv = T.make_kv_cache(cfg, capacity, jnp.float32)

    def step(tp, e, kv):
        with A.kernel_allowed(allowed):
            return T.talker_step(tp, cfg, e, jnp.int32(12), kv, strategy="carried")

    txt = _lowered(step, platform, tp, jnp.zeros((32,)), kv)
    assert (TRITON in txt) is want


def test_vmapped_lanes_lower_one_batched_kernel():
    """Under vmap (the batched loop) the kernel gains a grid axis: still one
    Triton call per layer step, with the lane count in its grid."""
    q, k, v = _qkv(2, 16, 8, 128, 1024, lead=(4,))
    txt = _lowered(jax.vmap(lambda q, k, v: A.decode_attention_auto(q, k, v, 300)),
                   "cuda", q, k, v)
    assert txt.count(TRITON) == 1
    assert "grid_x = 4" in txt or "grid_z = 4" in txt or "grid_y = 4" in txt


def test_spans_devices_detects_mesh_placement():
    from qwen3tts_tpu.parallel.mesh import make_mesh, spans_devices

    x = jnp.zeros((8, 4))
    assert not spans_devices(x, {"a": np.zeros(3)})
    mesh = make_mesh(2, 2)
    assert spans_devices(x, jax.device_put(x, NamedSharding(mesh, P("dp"))))
    assert spans_devices(jax.device_put(x, NamedSharding(mesh, P())))


def test_dispatch_matches_reference_on_cpu():
    """decode_attention_layered / _auto lower the einsum here and agree with
    decode_attention exactly, with and without `start`, at a capacity the
    kernel fits."""
    rng = np.random.default_rng(31)
    kv = jnp.asarray(rng.normal(size=(2, 2, 2, 1024, 16)), jnp.float32)
    q = jnp.asarray(rng.normal(size=(4, 16)), jnp.float32)
    for start in (None, 3):
        want = decode_attention(q, kv[1, 0], kv[1, 1], 40, start)
        np.testing.assert_array_equal(
            np.asarray(A.decode_attention_layered(q, kv, 1, 40, start)),
            np.asarray(want))
        np.testing.assert_array_equal(
            np.asarray(A.decode_attention_auto(q, kv[1, 0], kv[1, 1], 40, start)),
            np.asarray(want))
