"""The operations and bytes of a language-model training step, counted
from the configuration and the traffic's shapes, never from what the
program launches, and the peak they are held to: the H100 SXM data
sheet's dense bfloat16 tensor-core rate (the configuration's matmuls run
in bfloat16). ``peaks.FP32_FLOPS`` is the float32 rate outside the tensor
cores: a bfloat16 step held to it would read several times 100%.

A step is the forward, the backward (twice the forward's products) and
the optimizer over ``sequences`` x ``seq_len`` tokens. Counted: every
matmul as 2 operations a multiply-add; causal attention's scores and
weighted sum over the positions at or before each token; the routed
experts at their expected load, ``num_experts_per_tok x held / routed``
pairs a token (the load the router's uniform share gives; a real step's
held load varies around it). Not counted: norms, rotations, softmax,
activations, the loss and the optimizer's arithmetic (a fraction of a
percent).
"""

from __future__ import annotations

#: Dense bfloat16 tensor-core peak of the H100 SXM at 700 W, FLOP/s.
BF16_FLOPS = 989.4e12


def forward_flops_per_token(cfg: dict, seq_len: int) -> float:
    """The forward's operations a token, averaged over a causal sequence
    of ``seq_len`` positions."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    proj = h * nh * (nope + rd) + h * (rank + rd) + rank * nh * (nope + dv) \
        + nh * dv * h
    seen = (seq_len + 1) / 2                       # causal positions a token
    attention = 2 * proj + 2 * seen * nh * (nope + rd + dv)
    dense = 2 * 3 * h * cfg["intermediate_size"]
    w = cfg["moe_intermediate_size"]
    pairs = (cfg["num_experts_per_tok"] * cfg["n_routed_experts_held"]
             / cfg["n_routed_experts"])
    moe = (2 * h * cfg["n_routed_experts"] + pairs * 2 * 3 * h * w
           + 2 * 3 * h * w * cfg["n_shared_experts"])
    layers = cfg["layers_held"]
    dense_layers = min(cfg["first_k_dense_replace"], layers)
    head = 2 * h * cfg["vocab_size"]
    return (layers * attention + dense_layers * dense
            + (layers - dense_layers) * moe + head)


def step_flops(cfg: dict, sequences: int, seq_len: int) -> float:
    """A training step's operations: forward and backward, 3x the
    forward's."""
    return 3.0 * forward_flops_per_token(cfg, seq_len) * sequences * seq_len


def params(cfg: dict) -> int:
    """The parameters of the chip's share."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    rank, w = cfg["kv_lora_rank"], cfg["moe_intermediate_size"]
    attn = (2 * h + h * nh * (nope + rd) + h * (rank + rd) + rank
            + rank * nh * (nope + dv) + nh * dv * h)
    dense = 3 * h * cfg["intermediate_size"]
    moe = (h * cfg["n_routed_experts"]
           + cfg["n_routed_experts_held"] * 3 * h * w
           + 3 * h * w * cfg["n_shared_experts"])
    layers = cfg["layers_held"]
    dense_layers = min(cfg["first_k_dense_replace"], layers)
    return (layers * attn + dense_layers * dense
            + (layers - dense_layers) * moe + 2 * cfg["vocab_size"] * h + h)


def step_bytes(cfg: dict) -> float:
    """The least bytes a step moves in float32 parameter-sized arrays:
    the weights read once (4P), the gradients written once (4P), AdamW
    reading weights, gradients and both moments and writing weights and
    moments (28P), the sync's delta (reading the value and its baseline,
    8P), the table read and written (8P) and the merged value and its
    baseline written (8P). Activations are not counted: the step is bound
    by its operations many times over."""
    return 60.0 * params(cfg)
