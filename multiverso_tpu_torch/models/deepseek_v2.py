"""DeepSeek-V2(-Lite): multi-head latent attention and a DeepSeekMoE expert
layer, trained by ASGD through the parameter server (``ext/asgd.py``).

The equations are the DeepSeek-V2 paper's (arXiv:2405.04434, section 2.1
MLA, 2.2 DeepSeekMoE) as the published modelling code writes them
(``modeling_deepseek.py`` of ``deepseek-ai/DeepSeek-V2-Lite``):

- RMSNorm in float32 (epsilon ``rms_norm_eps``), SwiGLU MLPs (SiLU);
- layers ``< first_k_dense_replace`` a dense MLP of ``intermediate_size``,
  the others the expert layer;
- MLA without a query LoRA: ``q_proj`` to ``heads x (nope + rope)``;
  ``kv_a_proj_with_mqa`` to a ``kv_lora_rank`` latent, RMS-normed by
  ``kv_a_layernorm``, and one rope key shared by all heads; ``kv_b_proj``
  from the latent to ``heads x (k nope + v)``; causal softmax attention at
  scale ``q_head_dim ** -0.5 * mscale(factor, mscale_all_dim) ** 2``;
  ``o_proj``. The rope halves are de-interleaved before the rotation, as
  the published code does;
- YaRN rotary frequencies (``rope_scaling``: factor, original length,
  beta_fast, beta_slow, mscale, mscale_all_dim), tables in float32;
- the expert layer: a float32 softmax gate over all ``n_routed_experts``,
  greedy top-``num_experts_per_tok`` (no renormalisation under
  ``norm_topk_prob`` false, times ``routed_scaling_factor``), the routed
  experts' SwiGLU outputs summed by their gate weights, plus the shared
  experts (one MLP of ``n_shared_experts x moe_intermediate_size``), and
  the sequence-level balance loss (``seq_aux``, weight ``aux_loss_alpha``);
- untied embedding and head; the loss is next-token cross-entropy in
  float32 plus the balance losses.

Expert parallelism: the layer is told which routed experts it holds
(``experts_held = (first, count)``). It routes over all of them and
computes only its own experts' part: tokens routed elsewhere add nothing
here. The shared experts are computed in full. With the held shares of a
layer's every chip summed, and the shared experts counted once, the
result is the whole layer's.

Matmuls run in ``compute_dtype`` (bfloat16 on the card, the published
``torch_dtype``; float32 accumulation) on float32 master weights; the
residual stream, the norms, the router, the rotary tables and the loss are
float32. The held experts run as two grouped GEMMs over the tokens sorted
by expert (``torch._grouped_mm``) for bfloat16 on a card, as a loop over
the experts elsewhere. Attention is SDPA's fused causal kernel, cuDNN's
alone on a card: it takes V at its own head size.

Parameters are a flat dict of name -> float32 tensor (the names of the
published checkpoint, the experts of a layer stacked and the gate and up
projections joined), so the whole model is one tree for the table.

Sections (``obs/devtime.py``): ``MLA_ATTENTION``, ``MOE_ROUTE``,
``MOE_EXPERTS``, ``MOE_SHARED`` a layer and ``LM_OPTIM`` a step, each with
its device time (``<name>_DEVICE``, forward and backward) on a card; the
counter ``MOE_ROUTED_PAIRS`` (token-expert pairs on held experts) and the
gauge ``MOE_LOAD_MAX_RATIO`` (the largest held expert's load over the held
mean, the worst layer of the step), read from the device without waiting.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.optim.adamw import adamw

from multiverso_tpu_torch import log
from multiverso_tpu_torch.dashboard import count, gauge_set
from multiverso_tpu_torch.obs.devtime import DeviceReadout, DeviceSection

#: SDPA's backend by device: on a card cuDNN's fused causal attention
#: alone, which takes V at its own head size (128 against the query's 192),
#: so that a build without it fails instead of falling back to flash (V
#: padded to 192), the efficient kernel (7x slower) or the plain one (a
#: 1 GB score matrix a sequence a layer); elsewhere the plain one.
SDPA_BACKENDS = {"cuda": SDPBackend.CUDNN_ATTENTION, "cpu": SDPBackend.MATH}

YARN = {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
        "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
        "mscale_all_dim": 0.707}


@dataclass
class DeepseekV2Config:
    """The published configuration's keys (DeepSeek-V2-Lite's values by
    default) and the chip's share: ``num_hidden_layers`` built here and
    the routed experts held (``experts_held``)."""
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Dict[str, Any] = field(default_factory=lambda: dict(YARN))
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    scoring_func: str = "softmax"
    topk_method: str = "greedy"
    n_group: int = 1
    topk_group: int = 1
    seq_aux: bool = True
    aux_loss_alpha: float = 0.001
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    experts_held: Tuple[int, int] = (0, 64)
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self) -> None:
        if self.q_lora_rank is not None:
            log.fatal("DeepseekV2Config: a query LoRA is not supported")
        if (self.scoring_func, self.topk_method) != ("softmax", "greedy"):
            log.fatal("DeepseekV2Config: softmax scoring and greedy top-k "
                      "only, got %s/%s", self.scoring_func, self.topk_method)
        if self.norm_topk_prob or self.tie_word_embeddings:
            log.fatal("DeepseekV2Config: norm_topk_prob and tied embeddings "
                      "are not supported")
        if self.moe_layer_freq != 1:
            log.fatal("DeepseekV2Config: moe_layer_freq must be 1")
        first, n = self.experts_held
        if not (0 <= first and n >= 1 and first + n <= self.n_routed_experts):
            log.fatal("experts_held %r outside %d experts", self.experts_held,
                      self.n_routed_experts)

    @classmethod
    def from_dict(cls, d: Dict[str, Any], **overrides) -> "DeepseekV2Config":
        """From a configuration file: its published keys, and the chip's
        share where it states one (``layers_held``,
        ``n_routed_experts_held`` from ``experts_held_first``)."""
        known = {f.name for f in fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        if "layers_held" in d:
            kw["num_hidden_layers"] = int(d["layers_held"])
        if "n_routed_experts_held" in d:
            kw["experts_held"] = (int(d.get("experts_held_first", 0)),
                                  int(d["n_routed_experts_held"]))
        kw.update(overrides)
        return cls(**kw)

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        scale = self.q_head_dim ** -0.5
        mscale_all = self.rope_scaling.get("mscale_all_dim", 0)
        if mscale_all:
            m = yarn_get_mscale(self.rope_scaling["factor"], mscale_all)
            scale *= m * m
        return scale

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace


# -- the parameters ---------------------------------------------------------------

def param_shapes(c: DeepseekV2Config) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, this chip's share."""
    h, nh = c.hidden_size, c.num_attention_heads
    shapes: Dict[str, Tuple[int, ...]] = {
        "embed_tokens.weight": (c.vocab_size, h),
        "norm.weight": (h,),
        "lm_head.weight": (c.vocab_size, h),
    }
    for i in range(c.num_hidden_layers):
        p = f"layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (h,),
            p + "post_attention_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (nh * c.q_head_dim, h),
            p + "self_attn.kv_a_proj_with_mqa.weight":
                (c.kv_lora_rank + c.qk_rope_head_dim, h),
            p + "self_attn.kv_a_layernorm.weight": (c.kv_lora_rank,),
            p + "self_attn.kv_b_proj.weight":
                (nh * (c.qk_nope_head_dim + c.v_head_dim), c.kv_lora_rank),
            p + "self_attn.o_proj.weight": (h, nh * c.v_head_dim),
        })
        if not c.is_moe(i):
            shapes.update({
                p + "mlp.gate_up_proj.weight": (2 * c.intermediate_size, h),
                p + "mlp.down_proj.weight": (h, c.intermediate_size),
            })
            continue
        e, w = c.experts_held[1], c.moe_intermediate_size
        ws = w * c.n_shared_experts
        shapes.update({
            p + "mlp.gate.weight": (c.n_routed_experts, h),
            p + "mlp.experts.gate_up_proj": (e, 2 * w, h),
            p + "mlp.experts.down_proj": (e, h, w),
            p + "mlp.shared_experts.gate_up_proj.weight": (2 * ws, h),
            p + "mlp.shared_experts.down_proj.weight": (h, ws),
        })
    return shapes


def init_params(c: DeepseekV2Config, seed: int = 0,
                device: Any = "cpu") -> Dict[str, torch.Tensor]:
    """Seeded float32 weights on ``device``: norms 1, every other weight
    normal(0, ``initializer_range``) (the published initialisation)."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    out = {}
    for name, shape in sorted(param_shapes(c).items()):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if "norm" in name:
            t.fill_(1.0)
        else:
            t.normal_(0.0, c.initializer_range, generator=gen)
        out[name] = t
    return out


# -- rotary embedding (YaRN) --------------------------------------------------------

def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float,
                    length: int) -> float:
    return (dim * math.log(length / (rotations * 2 * math.pi))
            / (2 * math.log(base)))


def rope_tables(c: DeepseekV2Config, seq_len: int, device: Any
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (seq_len, qk_rope_head_dim) float32: YaRN's blend
    of interpolated and extrapolated frequencies, times its mscale ratio."""
    dim, base, rs = c.qk_rope_head_dim, float(c.rope_theta), c.rope_scaling
    factor = rs["factor"]
    orig = rs["original_max_position_embeddings"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / base ** exps
    freq_inter = 1.0 / (factor * base ** exps)
    low = max(math.floor(_correction_dim(rs["beta_fast"], dim, base, orig)), 0)
    high = min(math.ceil(_correction_dim(rs["beta_slow"], dim, base, orig)),
               dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low), 0, 1)
    extra = 1.0 - ramp
    inv_freq = freq_inter * (1 - extra) + freq_extra * extra
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    mscale = (yarn_get_mscale(factor, rs["mscale"])
              / yarn_get_mscale(factor, rs["mscale_all_dim"]))
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * mscale, emb.sin() * mscale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """``x`` (B, T, heads, d) rotated in float32: its interleaved pairs
    de-interleaved, then ``x cos + rotate_half(x) sin``."""
    b, t, h, d = x.shape
    x = x.float().view(b, t, h, d // 2, 2).transpose(-1, -2).reshape(b, t, h, d)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    half = torch.cat((-x[..., d // 2:], x[..., : d // 2]), dim=-1)
    return x * cos + half * sin


# -- the layers -------------------------------------------------------------------

class _RMSNorm(torch.autograd.Function):
    """RMSNorm in float32 that keeps only its input and the reciprocal RMS
    for the backward (the composite keeps the normed copy too: a float32
    copy of the residual stream a norm, 18 of them a step)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        rstd = torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, w, rstd)
        return x * rstd * w

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd = ctx.saved_tensors
        xhat = x * rstd
        dw = (dy * xhat).reshape(-1, x.shape[-1]).sum(0)
        g = dy * w
        dx = rstd * (g - xhat * (g * xhat).mean(-1, keepdim=True))
        return dx, dw, None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return _RMSNorm.apply(x.float(), w, eps)


def _linear(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
            ) -> torch.Tensor:
    return F.linear(x.to(dtype), w.to(dtype))


def _swiglu(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    g, u = _linear(x, gate_up, dtype).chunk(2, dim=-1)
    return _linear(F.silu(g) * u, down, dtype)


class Sections:
    """The model's timed sections and counters on one thread."""

    NAMES = ("MLA_ATTENTION", "MOE_ROUTE", "MOE_EXPERTS", "MOE_SHARED",
             "LM_OPTIM")

    def __init__(self, device: Any) -> None:
        for name in self.NAMES:
            setattr(self, name.lower(), DeviceSection(name, device))
        self.loads = DeviceReadout(_count_loads)

    def flush(self) -> None:
        for name in self.NAMES:
            getattr(self, name.lower()).flush()
        self.loads.flush()


def _count_loads(loads: torch.Tensor) -> None:
    """One step's held-expert loads (MoE layers x held experts)."""
    loads = loads.double()
    pairs = float(loads.sum())
    count("MOE_ROUTED_PAIRS", int(pairs))
    mean = loads.mean(dim=1)
    ratio = torch.where(mean > 0, loads.max(dim=1).values / mean,
                        torch.zeros_like(mean))
    gauge_set("MOE_LOAD_MAX_RATIO", float(ratio.max()) if len(ratio) else 0.0)


def mla_attention(p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor,
                  rope: Tuple[torch.Tensor, torch.Tensor],
                  c: DeepseekV2Config) -> torch.Tensor:
    """Multi-head latent attention of normed ``x`` (B, T, hidden), causal."""
    b, t, _ = x.shape
    nh, nope, rd, dv = (c.num_attention_heads, c.qk_nope_head_dim,
                        c.qk_rope_head_dim, c.v_head_dim)
    cd = c.compute_dtype
    x = x.to(cd)
    q = _linear(x, p[prefix + "q_proj.weight"], cd).view(b, t, nh, nope + rd)
    q_nope, q_pe = q.split([nope, rd], dim=-1)
    kv = _linear(x, p[prefix + "kv_a_proj_with_mqa.weight"], cd)
    latent, k_pe = kv.split([c.kv_lora_rank, rd], dim=-1)
    latent = rms_norm(latent, p[prefix + "kv_a_layernorm.weight"],
                      c.rms_norm_eps)
    kvb = _linear(latent, p[prefix + "kv_b_proj.weight"], cd).view(
        b, t, nh, nope + dv)
    k_nope, v = kvb.split([nope, dv], dim=-1)
    cos, sin = rope
    q_pe = apply_rope(q_pe, cos, sin).to(cd)
    k_pe = apply_rope(k_pe.view(b, t, 1, rd), cos, sin).to(cd)
    q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
    k = torch.cat([k_nope, k_pe.expand(b, t, nh, rd)], dim=-1).transpose(1, 2)
    with sdpa_kernel(SDPA_BACKENDS[q.device.type]):
        o = F.scaled_dot_product_attention(q, k, v.transpose(1, 2),
                                           is_causal=True,
                                           scale=c.softmax_scale)
    o = o.transpose(1, 2).reshape(b, t, nh * dv)
    return _linear(o, p[prefix + "o_proj.weight"], cd)


def route(p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor,
          c: DeepseekV2Config, batch: int):
    """The gate over all routed experts for ``x`` (N, hidden): (top-k
    weights (N, k), top-k ids (N, k), the balance loss)."""
    scores = F.linear(x.float(), p[prefix + "gate.weight"].float()).softmax(-1)
    weights, ids = torch.topk(scores, c.num_experts_per_tok, dim=-1)
    weights = weights * c.routed_scaling_factor
    if c.seq_aux and c.aux_loss_alpha > 0:
        n, e, k = x.shape[0], c.n_routed_experts, c.num_experts_per_tok
        t = n // batch
        load = torch.zeros(batch, e, device=x.device).scatter_add_(
            1, ids.view(batch, t * k),
            torch.ones(batch, t * k, device=x.device)).div_(t * k / e)
        aux = (load * scores.view(batch, t, e).mean(dim=1)).sum(dim=1).mean()
        aux = aux * c.aux_loss_alpha
    else:
        aux = scores.new_zeros(())
    return weights, ids, aux


def experts_grouped(xs: torch.Tensor, gate_up: torch.Tensor,
                    down: torch.Tensor, loads: torch.Tensor) -> torch.Tensor:
    """The held experts' SwiGLU over ``xs`` sorted by expert (``loads``
    rows each) as two grouped GEMMs (``torch._grouped_mm``, in ``xs``'s
    dtype)."""
    offs = torch.cumsum(loads, 0).to(torch.int32)
    g, u = torch._grouped_mm(xs, gate_up.to(xs.dtype).transpose(1, 2),
                             offs=offs).chunk(2, dim=-1)
    return torch._grouped_mm(F.silu(g) * u, down.to(xs.dtype).transpose(1, 2),
                             offs=offs)


def experts_loop(xs: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
                 loads: torch.Tensor) -> torch.Tensor:
    """The same as :func:`experts_grouped`, one expert at a time."""
    outs, lo = [], 0
    for e, m in enumerate(loads.tolist()):
        if m:
            outs.append(_swiglu(xs[lo:lo + m], gate_up[e], down[e], xs.dtype))
            lo += m
    return torch.cat(outs) if outs else xs.new_zeros((0, down.shape[1]))


def held_experts(p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor,
                 weights: torch.Tensor, ids: torch.Tensor,
                 c: DeepseekV2Config):
    """The held experts' part of the layer for ``x`` (N, hidden): the
    (token, slot) pairs routed to a held expert, sorted by expert, through
    the experts' SwiGLU, weighted and summed back per token (float32).
    Returns (that part, the held experts' loads). The grouped GEMMs run
    for bfloat16 on a card (a layer's held experts 5.7 ms forward and
    backward on an H100, the loop 10.3), the loop elsewhere."""
    first, held = c.experts_held
    n, k = ids.shape
    local = ids.reshape(-1) - first
    local = torch.where((local >= 0) & (local < held), local,
                        torch.full_like(local, held))
    loads = torch.bincount(local, minlength=held + 1)[:held]
    order = torch.argsort(local, stable=True)
    pairs = order[: int(loads.sum())]   # the one host read of the layer
    token = pairs // k
    xs = x.to(c.compute_dtype).index_select(0, token)
    grouped = xs.is_cuda and xs.dtype == torch.bfloat16 and len(pairs)
    out = (experts_grouped if grouped else experts_loop)(
        xs, p[prefix + "experts.gate_up_proj"], p[prefix + "experts.down_proj"],
        loads)
    w = weights.reshape(-1).index_select(0, pairs)
    y = torch.zeros(n, x.shape[1], dtype=torch.float32, device=x.device)
    return y.index_add_(0, token, out.float() * w[:, None]), loads


def moe(p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor,
        c: DeepseekV2Config, s: Sections, route_hook=None):
    """The expert layer of normed ``x`` (B, T, hidden): (this chip's part
    plus the shared experts, the balance loss, the held loads)."""
    b, t, h = x.shape
    xf = x.reshape(b * t, h)
    with s.moe_route():
        weights, ids, aux = route(p, prefix, xf, c, b)
    xc = xf.to(c.compute_dtype)     # one cast for the experts and the shared
    if route_hook is not None:
        route_hook(ids)
    with s.moe_experts():
        y, loads = held_experts(p, prefix, s.moe_experts.enter(xc),
                                weights, ids, c)
        y = s.moe_experts.leave(y)
    with s.moe_shared():
        ys = _swiglu(s.moe_shared.enter(xc),
                     p[prefix + "shared_experts.gate_up_proj.weight"],
                     p[prefix + "shared_experts.down_proj.weight"],
                     c.compute_dtype)
        ys = s.moe_shared.leave(ys)
    return (y + ys.float()).view(b, t, h), aux, loads


def forward_loss(p: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 c: DeepseekV2Config, s: Sections,
                 route_hook: Optional[Callable] = None):
    """``tokens`` (B, T + 1): the loss of predicting ``tokens[:, 1:]`` from
    ``tokens[:, :-1]``. Returns (loss, cross-entropy, the MoE layers'
    held loads (layers, held)); ``route_hook(layer, ids)`` sees each MoE
    layer's top-k ids."""
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    b, t = inp.shape
    rope = rope_tables(c, t, tokens.device)
    h = F.embedding(inp, p["embed_tokens.weight"])
    aux_total = h.new_zeros(())
    loads: List[torch.Tensor] = []
    for i in range(c.num_hidden_layers):
        pre = f"layers.{i}."
        x = rms_norm(h, p[pre + "input_layernorm.weight"], c.rms_norm_eps)
        with s.mla_attention():
            a = mla_attention(p, pre + "self_attn.", s.mla_attention.enter(x),
                              rope, c)
            a = s.mla_attention.leave(a)
        h = h + a.float()
        x = rms_norm(h, p[pre + "post_attention_layernorm.weight"],
                     c.rms_norm_eps)
        if c.is_moe(i):
            hook = None if route_hook is None else (
                lambda ids, i=i: route_hook(i, ids))
            y, aux, held = moe(p, pre + "mlp.", x, c, s, hook)
            aux_total = aux_total + aux
            loads.append(held)
        else:
            y = _swiglu(x, p[pre + "mlp.gate_up_proj.weight"],
                        p[pre + "mlp.down_proj.weight"], c.compute_dtype).float()
        h = h + y
    x = rms_norm(h, p["norm.weight"], c.rms_norm_eps)
    logits = _linear(x, p["lm_head.weight"], c.compute_dtype).float()
    ce = F.cross_entropy(logits.view(b * t, -1), labels.reshape(-1))
    held = (torch.stack(loads) if loads else
            torch.zeros((0, c.experts_held[1]), dtype=torch.long,
                        device=tokens.device))
    return ce + aux_total, ce, held


# -- training --------------------------------------------------------------------

@dataclass
class AdamWConfig:
    """DeepSeek-V2's recipe for V2-Lite: beta 0.9/0.95, weight decay 0.1,
    global gradient-norm clip 1.0; a constant learning rate."""
    lr: float = 4.2e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip: float = 1.0


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> torch.Tensor:
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm`` (``clip_grad_norm_``'s rule); returns the norm before."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.clamp(max_norm / (norm + 1e-6), max=1.0))
    return norm


def optimizer_state(c: DeepseekV2Config, device: Any) -> dict:
    """Worker-local AdamW state: zero moments and a step count a leaf."""
    shapes = param_shapes(c)

    def zeros():
        return {n: torch.zeros(s, device=device) for n, s in shapes.items()}

    return {"exp_avg": zeros(), "exp_avg_sq": zeros(),
            "step": {n: torch.zeros((), device=device) for n in shapes}}


def make_train_step(c: DeepseekV2Config, opt: AdamWConfig, device: Any,
                    grad_hook: Optional[Callable] = None,
                    route_hook: Optional[Callable] = None) -> Callable:
    """``step(state, tokens) -> (state, loss)`` for ``ext/asgd.py``: the
    loss and gradients of ``state["params"]`` on ``tokens`` (B, T + 1),
    the global clip and AdamW in place (``LM_OPTIM``). ``grad_hook(names,
    grads)`` sees the gradients before the clip; ``route_hook(layer,
    ids)`` each MoE layer's top-k ids. The step has ``flush()`` (the
    pending device times and counts) and ``sections``."""
    s = Sections(device)
    fused = torch.device(device).type == "cuda"

    def step(state: dict, tokens: torch.Tensor):
        params = state["params"]
        names = sorted(params)
        leaves = [params[n].detach().requires_grad_() for n in names]
        tensors = dict(zip(names, leaves))
        loss, _, loads = forward_loss(tensors, tokens, c, s,
                                      route_hook=step.route_hook)
        # a held expert no token reached has no gradient: zeros
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        del tensors, leaves
        s.loads.submit(loads)
        if step.grad_hook is not None:
            step.grad_hook(names, grads)
        with s.lm_optim():
            clip_by_global_norm(grads, opt.clip)
            with torch.no_grad():
                adamw([params[n] for n in names], grads,
                      [state["exp_avg"][n] for n in names],
                      [state["exp_avg_sq"][n] for n in names], [],
                      [state["step"][n] for n in names],
                      foreach=not fused, fused=fused, amsgrad=False,
                      beta1=opt.beta1, beta2=opt.beta2, lr=opt.lr,
                      weight_decay=opt.weight_decay, eps=opt.eps,
                      maximize=False)
        return state, loss.detach()

    step.grad_hook, step.route_hook = grad_hook, route_hook
    step.sections = s
    step.flush = s.flush
    return step


class LMTrainer:
    """DeepSeek-V2 trained by ASGD through one ArrayTable: ``workers``
    threads, each with its own AdamW state, a sync every ``sync_freq``
    steps (``ext/asgd.py``). ``params`` is the initial value (a tree on
    any device; the table lives on the runtime's device)."""

    def __init__(self, config: DeepseekV2Config, params: Dict[str, Any],
                 opt: Optional[AdamWConfig] = None, workers: int = 1,
                 sync_freq: int = 1) -> None:
        from multiverso_tpu_torch.ext.asgd import ASGDTrainer
        from multiverso_tpu_torch.runtime.zoo import Zoo
        self.device = Zoo.instance().device
        self.config, self.opt = config, opt or AdamWConfig()
        self.asgd = ASGDTrainer(params, workers, sync_freq)
        self.grad_hook: Optional[Callable] = None
        self.route_hook: Optional[Callable] = None
        self.states: Dict[int, dict] = {}

    def train(self, batches: Callable[[int], Any],
              on_loss: Optional[Callable[[int, torch.Tensor], None]] = None,
              timeout: Optional[float] = None) -> Dict[int, dict]:
        """Train every worker over ``batches(slot)`` (token tensors (B,
        T + 1) on the runtime's device). AdamW state carries over from one
        call to the next. ``on_loss(slot, loss)`` sees each step's loss (a
        device scalar). Returns each slot's final state."""

        def make_step(slot: int):
            step = make_train_step(self.config, self.opt, self.device,
                                   self.grad_hook, self.route_hook)

            def run(state, tokens):
                state, loss = step(state, tokens)
                if on_loss is not None:
                    on_loss(slot, loss)
                return state, loss

            run.flush = step.flush
            return run

        def local_state(slot: int) -> dict:
            if slot not in self.states:
                self.states[slot] = optimizer_state(self.config, self.device)
            return self.states[slot]

        results = self.asgd.run(make_step, batches, local_state, timeout)
        for slot, state in results.items():
            self.states[slot] = {k: v for k, v in state.items()
                                 if k != "params"}
        return results
