"""Named-axis parameter shardings (tensor parallelism over "tp").

Partitioning policy for the Qwen3-style stacks, chosen so GSPMD's inserted
collectives ride the device interconnect (SURVEY.md §5 "distributed communication backend"):

- q/k/v projections: shard the output (head) dim  -> no comm at apply
- o projection:      shard the input (head) dim   -> one all-reduce per block
- FFN gate/up:       shard the intermediate dim   -> no comm
- FFN down:          shard the intermediate (in) dim -> one all-reduce
- codec/LM heads:    shard the vocab dim          -> logits all-gather
- embeddings, norms: replicated

KV caches inherit head-dim sharding from k/v producers. The talker's 8 KV
heads bound useful tp at 8.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.code_predictor import CodePredictorParams
from ..models.talker import TalkerParams
from ..models.transformer_core import BlockParams


def block_specs() -> BlockParams:
    # NB: wqkv/w_gateup are fused along the output axis; sharding that axis
    # over tp splits q/k/v (gate/up) unevenly across shards, and GSPMD inserts
    # the reshards needed by the post-matmul slices. Correctness is covered by
    # tests/test_parallel.py; dp remains the primary throughput axis at 0.6B.
    return BlockParams(
        attn_norm=P(),
        wqkv=P(None, None, "tp"),
        wo=P(None, "tp", None),
        q_norm=P(),
        k_norm=P(),
        ffn_norm=P(),
        w_gateup=P(None, None, "tp"),
        w_down=P(None, "tp", None),
    )


def talker_specs() -> TalkerParams:
    return TalkerParams(
        text_embd=P(),
        text_proj_fc1_w=P(None, "tp"),
        text_proj_fc1_b=P("tp"),
        text_proj_fc2_w=P("tp", None),
        text_proj_fc2_b=P(),
        codec_embd=P(),
        blocks=block_specs(),
        output_norm=P(),
        codec_head=P(None, "tp"),
    )


def code_predictor_specs() -> CodePredictorParams:
    return CodePredictorParams(
        blocks=block_specs(),
        output_norm=P(),
        embds=P(),
        heads=P(None, None, "tp"),
    )


def _fit_spec(spec: P, shape, mesh: Mesh) -> P:
    """Drop mesh axes from dims they don't evenly divide.

    Quantized leaves reuse the matrix spec for their scale rows, whose
    group dim (1 for QuantLinear, n_groups for QuantLinear4) is usually
    smaller than the mesh axis — those dims stay replicated, which is
    numerically free (scales apply after the sharded dot's all-reduce)."""
    def size(ax):
        if isinstance(ax, (tuple, list)):
            n = 1
            for a in ax:
                n *= mesh.shape[a]
            return n
        return mesh.shape[ax]

    fitted = [ax if ax is None or shape[d] % size(ax) == 0 else None
              for d, ax in enumerate(spec)]
    return P(*fitted)


def shard_params(params, specs, mesh: Mesh):
    """device_put every leaf with its NamedSharding. Quantized weights
    (QuantLinear int8, QuantLinear4 packed-int4) apply the matrix spec to
    both the quantized values and the scales (same rank; non-dividing dims
    fall back to replicated via _fit_spec)."""
    from ..ops.quantized_matmul import QuantLinear, QuantLinear4

    def put_leaf(x, s):
        return jax.device_put(x, NamedSharding(mesh, _fit_spec(s, x.shape, mesh)))

    def put(x, s):
        if isinstance(x, QuantLinear4):
            return QuantLinear4(q=put_leaf(x.q, s), scale=put_leaf(x.scale, s),
                                zero=put_leaf(x.zero, s))
        if isinstance(x, QuantLinear):
            return QuantLinear(q=put_leaf(x.q, s), scale=put_leaf(x.scale, s))
        return put_leaf(x, s)

    return jax.tree.map(put, params, specs,
                        is_leaf=lambda x: isinstance(x, (QuantLinear, QuantLinear4)))


def data_spec() -> P:
    """Batched per-utterance tensors shard their leading axis over dp."""
    return P("dp")
