"""The plain reference of ``dsv2_lite_ep8``: DeepSeek-V2-Lite's layers as
one expert-parallel chip holds them, in float32, written from the
DeepSeek-V2 paper (arXiv:2405.04434, sections 2.1-2.2) and the published
``modeling_deepseek.py``, with plain torch operations and no kernel or
module of the program: explicit attention with a causal mask, each held
expert by its own mask, AdamW and the parameter server's sync written out.
TF32 is off while it computes.

A step's loss and gradients are computed in blocks of ``block``
sequences, so that a step of 32,768 tokens fits beside nothing else.
``Reference(..., rounding="e4m3")`` is the control: every matmul input
rounded to float8 e4m3 by hand (per-tensor scale to e4m3's largest value,
the gradient passed straight through). ``fault=`` plants one fault:
``top5`` (five experts a token), ``no_shared`` (the shared experts left
out), ``rope_nope`` (the rotation applied to the nope half), ``no_kv_norm``
(``kv_a_layernorm`` skipped), ``drop_delta`` (the sync's delta dropped).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

FAULTS = ("top5", "no_shared", "rope_nope", "no_kv_norm", "drop_delta")


def shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the chip's share by the published names (experts
    of a layer stacked, gate and up projections joined)."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    rank, held = cfg["kv_lora_rank"], cfg["n_routed_experts_held"]
    w, v = cfg["moe_intermediate_size"], cfg["vocab_size"]
    out = {"embed_tokens.weight": (v, h), "norm.weight": (h,),
           "lm_head.weight": (v, h)}
    for i in range(cfg["layers_held"]):
        p = f"layers.{i}."
        out.update({
            p + "input_layernorm.weight": (h,),
            p + "post_attention_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (nh * (nope + rd), h),
            p + "self_attn.kv_a_proj_with_mqa.weight": (rank + rd, h),
            p + "self_attn.kv_a_layernorm.weight": (rank,),
            p + "self_attn.kv_b_proj.weight": (nh * (nope + dv), rank),
            p + "self_attn.o_proj.weight": (h, nh * dv)})
        if i < cfg["first_k_dense_replace"]:
            out.update({
                p + "mlp.gate_up_proj.weight": (2 * cfg["intermediate_size"], h),
                p + "mlp.down_proj.weight": (h, cfg["intermediate_size"])})
        else:
            ws = w * cfg["n_shared_experts"]
            out.update({
                p + "mlp.gate.weight": (cfg["n_routed_experts"], h),
                p + "mlp.experts.gate_up_proj": (held, 2 * w, h),
                p + "mlp.experts.down_proj": (held, h, w),
                p + "mlp.shared_experts.gate_up_proj.weight": (2 * ws, h),
                p + "mlp.shared_experts.down_proj.weight": (h, ws)})
    return out


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn(cfg: dict, t: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """YaRN's cos and sin tables (t, rope dim), float32."""
    rs, d, base = cfg["rope_scaling"], cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    f, orig = rs["factor"], rs["original_max_position_embeddings"]

    def corr(rot):
        return d * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    lo = max(math.floor(corr(rs["beta_fast"])), 0)
    hi = min(math.ceil(corr(rs["beta_slow"])), d - 1)
    if lo == hi:
        hi += 0.001
    pos = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    extrapolated = 1.0 / base ** pos
    interpolated = 1.0 / (f * base ** pos)
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    inv = interpolated * ramp + extrapolated * (1 - ramp)
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    m = _mscale(f, rs["mscale"]) / _mscale(f, rs["mscale_all_dim"])
    return ang.cos() * m, ang.sin() * m


def softmax_scale(cfg: dict) -> float:
    rs = cfg["rope_scaling"]
    m = _mscale(rs["factor"], rs["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a per-tensor scale (its largest
    magnitude to 448), the gradient passed straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


class Reference:
    """The chip's share of the model in float32 on ``device``."""

    def __init__(self, cfg: dict, device, rounding: Optional[str] = None,
                 fault: Optional[str] = None, block: int = 1) -> None:
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.device = cfg, torch.device(device)
        self.round = _e4m3 if rounding == "e4m3" else (lambda x: x)
        self.fault, self.block = fault, block
        self.k = cfg["num_experts_per_tok"] - (fault == "top5")

    # -- the model --------------------------------------------------------------
    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)

    def lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.mm(x, w.t())

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                               + self.cfg["rms_norm_eps"]) * w

    def mlp(self, x, gate_up, down):
        g, u = self.lin(x, gate_up).chunk(2, dim=-1)
        return self.lin(g * torch.sigmoid(g) * u, down)

    @staticmethod
    def rotate(x, cos, sin):
        """``x`` (s, t, d) or (t, d): the interleaved pairs de-interleaved,
        then rotated."""
        d = x.shape[-1]
        x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
        return x * cos + torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1) * sin

    def attention(self, p, pre, x, cos, sin):
        c = self.cfg
        t = x.shape[0]
        nh, nope, rd, dv = (c["num_attention_heads"], c["qk_nope_head_dim"],
                            c["qk_rope_head_dim"], c["v_head_dim"])
        q = self.lin(x, p[pre + "q_proj.weight"]).view(t, nh, nope + rd)
        q = q.transpose(0, 1)                                   # (nh, t, dq)
        kv = self.lin(x, p[pre + "kv_a_proj_with_mqa.weight"])
        latent, k_rope = kv[:, : c["kv_lora_rank"]], kv[:, c["kv_lora_rank"]:]
        if self.fault != "no_kv_norm":
            latent = self.norm(latent, p[pre + "kv_a_layernorm.weight"])
        kvb = self.lin(latent, p[pre + "kv_b_proj.weight"]).view(t, nh, nope + dv)
        kvb = kvb.transpose(0, 1)
        k_nope, v = kvb[..., :nope], kvb[..., nope:]
        q_nope, q_rope = q[..., :nope], q[..., nope:]
        if self.fault == "rope_nope":
            q_nope = self.rotate(q_nope[..., :rd], cos, sin)
            q_nope = torch.cat([q_nope, q[..., rd:nope]], dim=-1)
        q_rope = self.rotate(q_rope, cos, sin)
        k_rope = self.rotate(k_rope, cos, sin).expand(nh, t, rd)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        kf = torch.cat([k_nope, k_rope], dim=-1)
        scores = self.mm(qf, kf.transpose(1, 2)) * softmax_scale(c)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
        probs = torch.softmax(scores.masked_fill(causal, float("-inf")), -1)
        o = self.mm(probs, v).transpose(0, 1).reshape(t, nh * dv)
        return self.lin(o, p[pre + "o_proj.weight"])

    def moe(self, p, pre, x):
        """(this chip's experts' part plus the shared experts, the
        sequence's balance loss, the top-k ids)."""
        c = self.cfg
        t, e = x.shape[0], c["n_routed_experts"]
        scores = torch.softmax(self.lin(x, p[pre + "gate.weight"]), dim=-1)
        weights, ids = torch.topk(scores, self.k, dim=-1)
        weights = weights * c["routed_scaling_factor"]
        counts = torch.zeros(e, device=x.device).scatter_add_(
            0, ids.reshape(-1), torch.ones(ids.numel(), device=x.device))
        aux = (counts / (t * self.k / e) * scores.mean(0)).sum() \
            * c["aux_loss_alpha"]
        y = torch.zeros_like(x)
        first = c["experts_held_first"]
        for j in range(c["n_routed_experts_held"]):
            hit = ids == first + j                              # (t, k)
            tok = hit.any(dim=1).nonzero().reshape(-1)
            if len(tok) == 0:
                continue
            w = (weights * hit).sum(dim=1)[tok]
            out = self.mlp(x[tok], p[pre + "experts.gate_up_proj"][j],
                           p[pre + "experts.down_proj"][j])
            y = y.index_add(0, tok, out * w[:, None])
        if self.fault != "no_shared":
            y = y + self.mlp(x, p[pre + "shared_experts.gate_up_proj.weight"],
                             p[pre + "shared_experts.down_proj.weight"])
        return y, aux, ids

    def sequence_loss(self, p, seq: torch.Tensor, n_tokens: int, n_seqs: int):
        """One sequence's share of the step's loss (its cross-entropy summed
        over the step's ``n_tokens``, its balance losses over ``n_seqs``),
        its cross-entropy sum and each MoE layer's top-k ids."""
        c = self.cfg
        inp, labels = seq[:-1], seq[1:]
        cos, sin = yarn(c, len(inp), seq.device)
        h = p["embed_tokens.weight"][inp]
        aux_total, routes = h.new_zeros(()), []
        for i in range(c["layers_held"]):
            pre = f"layers.{i}."
            x = self.norm(h, p[pre + "input_layernorm.weight"])
            h = h + self.attention(p, pre + "self_attn.", x, cos, sin)
            x = self.norm(h, p[pre + "post_attention_layernorm.weight"])
            if i < c["first_k_dense_replace"]:
                h = h + self.mlp(x, p[pre + "mlp.gate_up_proj.weight"],
                                 p[pre + "mlp.down_proj.weight"])
            else:
                y, aux, ids = self.moe(p, pre + "mlp.", x)
                h = h + y
                aux_total = aux_total + aux
                routes.append(ids)
        logits = self.lin(self.norm(h, p["norm.weight"]), p["lm_head.weight"])
        ce = torch.nn.functional.cross_entropy(logits, labels, reduction="sum")
        return ce / n_tokens + aux_total / n_seqs, routes

    # -- a step -----------------------------------------------------------------
    def loss(self, p: Dict[str, torch.Tensor], tokens: torch.Tensor,
             grads: bool = False):
        """(the step's loss, the gradients or None, each MoE layer's top-k
        ids (B * T, k)) for ``tokens`` (B, T + 1), in blocks."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            b, t1 = tokens.shape
            n = b * (t1 - 1)
            names = sorted(p)
            leaves = {k: p[k].detach().requires_grad_(grads) for k in names}
            total, acc, routes = 0.0, None, []
            for lo in range(0, b, self.block):
                part, rts = 0.0, []
                with torch.set_grad_enabled(grads):
                    for s in range(lo, min(lo + self.block, b)):
                        loss, r = self.sequence_loss(leaves, tokens[s], n, b)
                        part = part + loss
                        rts.append(r)
                    if grads:
                        g = torch.autograd.grad(
                            part, [leaves[k] for k in names], allow_unused=True)
                        g = [torch.zeros_like(leaves[k]) if x is None else x
                             for k, x in zip(names, g)]
                        acc = g if acc is None else [
                            a.add_(x) for a, x in zip(acc, g)]
                total += float(part.detach())
                routes.append([torch.cat(x) for x in zip(*rts)])
            ids = [torch.cat(r) for r in zip(*routes)]
            return total, (dict(zip(names, acc)) if grads else None), ids
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    def adamw_first(self, p: Dict[str, torch.Tensor],
                    grads: Dict[str, torch.Tensor], opt: dict):
        """The global-norm clip and AdamW's first step, then the sync of one
        worker through the table (``table + (new - last)``, the table and
        ``last`` the initial value), leaf by leaf in place of ``p``.
        Yields (name, the initial value, the table's change)."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        coef = min(1.0, opt["clip"] / (float(norm) + 1e-6))
        b1, b2, lr, eps = opt["beta1"], opt["beta2"], opt["lr"], opt["eps"]
        for name in sorted(p):
            g = grads[name] * coef
            m = (1 - b1) * g
            v = (1 - b2) * g * g
            w0 = p[name]
            new = w0 * (1 - lr * opt["weight_decay"]) - (lr / (1 - b1)) * m / (
                torch.sqrt(v) / math.sqrt(1 - b2) + eps)
            table = w0 if self.fault == "drop_delta" else w0 + (new - w0)
            p[name] = table
            yield name, w0, table - w0
