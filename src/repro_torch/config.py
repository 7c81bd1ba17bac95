"""Configuration system: model / shape / run configs plus reduced smoke
variants.

The port's own copy of ``repro.config`` (the JAX package's module of the
same name): the dataclasses, ``SHAPES``, :func:`resolve_run_config` and
:func:`supported_shapes` behave exactly as there, resolving through the port's
:mod:`repro_torch.core.policy`.  ``RunConfig.dtype`` names a torch dtype
(see :func:`repro_torch.device.torch_dtype`)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .core.policy import (ExecutionPolicy, OperatingPoint, PolicyTable,
                          default_table)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int            # hidden dim of each expert


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class SSMConfig:                 # Mamba-1
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None    # defaults to ceil(d_model/16)


@dataclass(frozen=True)
class RGLRUConfig:               # RecurrentGemma recurrent block
    lru_width: Optional[int] = None  # defaults to d_model
    conv_width: int = 4
    window: int = 2048               # local-attention window of attn layers
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None       # defaults to d_model // n_heads
    ffn_act: str = "swiglu"              # swiglu | relu2 | gelu
    causal: bool = True                  # encoder-only archs set False
    rope: bool = True
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    frontend: Optional[str] = None       # None | "vision" | "audio" (stubs)
    n_frontend_tokens: int = 0           # patches/frames replacing prefix ids
    max_seq_len: int = 524_288

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS accounting."""
        d, L = self.d_model, self.n_layers
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        hd = self.resolved_head_dim
        if self.ssm is not None:
            d_in = self.ssm.expand * d
            dtr = self.ssm.dt_rank or -(-d // 16)
            per_layer = (d * d_in * 2          # in_proj (x and z)
                         + d_in * self.ssm.d_conv
                         + d_in * (dtr + 2 * self.ssm.d_state)
                         + dtr * d_in
                         + d_in * self.ssm.d_state   # A
                         + d_in * d)           # out_proj
        else:
            if self.mla is not None:
                m = self.mla
                qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                per_layer += (d * m.q_lora_rank
                              + m.q_lora_rank * self.n_heads * qk_head
                              + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                              + m.kv_lora_rank * self.n_heads
                              * (m.qk_nope_head_dim + m.v_head_dim)
                              + self.n_heads * m.v_head_dim * d)
            else:
                per_layer += (d * self.n_heads * hd
                              + 2 * d * self.n_kv_heads * hd
                              + self.n_heads * hd * d)
            if self.moe is not None:
                e = self.moe
                per_layer += d * e.num_experts            # router
                mult = 3 if self.ffn_act == "swiglu" else 2
                per_layer += e.num_experts * mult * d * e.d_ff_expert
            else:
                mult = 3 if self.ffn_act == "swiglu" else 2
                per_layer += mult * d * self.d_ff
        if self.rglru is not None:
            # mixture of recurrent and local-attention layers
            r = self.rglru
            w = r.lru_width or d
            n_attn = sum(1 for i in range(L)
                         if r.pattern[i % len(r.pattern)] == "attn")
            n_rec = L - n_attn
            rec_layer = d * w * 2 + w * r.conv_width + 2 * w + w * d
            attn_layer = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                          + self.n_heads * hd * d)
            mult = 3 if self.ffn_act == "swiglu" else 2
            ffn = mult * d * self.d_ff
            return total + n_rec * (rec_layer + ffn) + n_attn * (attn_layer + ffn)
        return total + L * per_layer

    def n_active_params(self) -> int:
        """Active params per token (= n_params for dense; top-k experts for
        MoE) — used for MODEL_FLOPS = 6·N_active·D."""
        if self.moe is None:
            return self.n_params()
        e = self.moe
        mult = 3 if self.ffn_act == "swiglu" else 2
        expert_p = mult * self.d_model * e.d_ff_expert
        inactive = self.n_layers * (e.num_experts - e.top_k) * expert_p
        return self.n_params() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    mode: str                    # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    policy: ExecutionPolicy = ExecutionPolicy.COPIFTV2
    dtype: str = "bfloat16"          # activation/computation dtype
    param_dtype: str = "float32"
    remat: bool = True               # activation checkpointing per block
    fsdp: bool = False               # shard params/opt-state over 'data'
    microbatch: int = 0              # >0: gradient accumulation steps
    grad_compression: bool = False   # int8 stochastic-rounded grad allreduce
    attn_batch_shard: bool = False   # shard attention activations' batch dim
    #   over (data, model) jointly: when heads %% TP != 0 (granite 24H,
    #   minicpm 40H) the S^2 score tensors are otherwise UNSHARDED on the
    #   model axis (EXPERIMENTS.md §Perf hillclimb)
    moe_dispatch: str = "dense"      # "dense" (exact reference: every token
    #   through every expert, masked) | "grouped" (capacity-bounded dispatch,
    #   the deployable path matching kernels/moe_gemm)
    analysis_mode: bool = False      # dry-run roofline accounting: unroll all
    #   loops (layers, seq chunks, attention blocks) so XLA cost_analysis —
    #   which counts while-loop bodies ONCE — reports true totals
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0


#: the RunConfig.policy field default — used to detect caller-pinned policies
_DEFAULT_RC_POLICY = RunConfig.__dataclass_fields__["policy"].default


def resolve_run_config(rc: RunConfig, workload: str,
                       operating_point: Optional[OperatingPoint] = None,
                       policy_table: Optional[PolicyTable] = None,
                       queue_latency: Optional[int] = None,
                       traffic: Optional[str] = None
                       ) -> Tuple[RunConfig, OperatingPoint]:
    """Resolve ``workload``'s operating point once, at startup, and thread
    its policy into the run config.

    Precedence: an explicit ``operating_point`` wins verbatim; a
    caller-pinned ``rc.policy`` (any value other than the RunConfig field
    default) stays authoritative while the calibrated queue geometry still
    applies; otherwise the calibration-backed table (``policy_table`` or
    the process default honouring ``REPRO_CALIBRATION_DIR``) supplies the
    whole point, falling back to the paper's hard-coded defaults when no
    artifact exists.  ``queue_latency`` pins the machine's queue-visibility
    latency class for schema-v4 per-class selections (defaulting to the
    workload's ``WORKLOAD_QUEUE_LATENCIES`` entry, the global selection for
    classes the calibration never swept).  ``traffic`` pins an offered-load
    level (:data:`repro_torch.core.policy.TRAFFIC_LEVELS`) for schema-v5
    per-traffic ``serve-slo`` selections — it wins over the latency class
    when the artifact carries one for that level."""
    table = policy_table if policy_table is not None else default_table()
    if operating_point is not None:
        op = table.resolve(workload, override=operating_point)
    elif rc.policy is not _DEFAULT_RC_POLICY:
        op = table.resolve(workload, queue_latency=queue_latency,
                           traffic=traffic, policy=rc.policy)
    else:
        op = table.resolve(workload, queue_latency=queue_latency,
                           traffic=traffic)
    return dataclasses.replace(rc, policy=op.policy), op


def supported_shapes(cfg: ModelConfig) -> List[str]:
    """Which of the four canonical shapes an architecture runs:
    long_500k needs sub-quadratic attention; encoder-only archs have no
    autoregressive decode."""
    out = ["train_4k", "prefill_32k"]
    if cfg.causal:
        out.append("decode_32k")
        if cfg.family in ("ssm", "hybrid"):
            out.append("long_500k")
    return out
