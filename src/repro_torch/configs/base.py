"""Model configuration dataclasses for the architecture zoo.

One ``ModelConfig`` describes any member of the zoo; family-specific
sub-configs (MoE, MLA, SSM, hybrid, enc-dec) are attached when used.
Configs are immutable; derived quantities (param counts, head dims) are
properties so EXPERIMENTS tables and the roofline share one source of truth.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    AUDIO = "audio"
    VLM = "vlm"
    SSM = "ssm"
    HYBRID = "hybrid"


class AttentionKind(str, enum.Enum):
    GQA = "gqa"          # grouped-query attention (covers MHA/MQA)
    MLA = "mla"          # multi-head latent attention (DeepSeek-V2/V3)
    LOCAL = "local"      # sliding-window causal attention
    NONE = "none"        # attention-free (pure SSM)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int                    # routed experts
    top_k: int
    n_shared: int = 0                 # always-on shared experts
    d_ff_expert: int = 0              # per-expert hidden dim
    capacity_factor: float = 1.25
    router: str = "softmax"           # "softmax" | "sigmoid" (aux-loss-free)
    aux_loss_weight: float = 0.001
    router_dtype: str = "float32"
    # layers [0, first_dense) use the dense d_ff MLP instead of MoE
    first_dense: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    headdim: int = 64
    n_groups: int = 1
    conv_kernel: int = 4
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Griffin-style interleave: `pattern` repeats over the layer stack."""

    pattern: Tuple[str, ...] = ("recurrent", "recurrent", "local_attn")
    lru_width: int = 0                # 0 -> d_model
    conv_width: int = 4
    window: int = 2048


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 6
    encoder_seq: int = 1500           # whisper-base: 30 s of 20 ms frames
    frontend: str = "audio_stub"      # precomputed frame embeddings


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    attention: AttentionKind = AttentionKind.GQA
    mlp_gated: bool = True            # SwiGLU-style; False -> 2-matrix GELU MLP
    d_head: int = 0                   # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    window: int = 0                   # sliding window (LOCAL attention)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    # multimodal stub: number of frontend embedding positions in prefill
    n_frontend_tokens: int = 0
    mtp_depth: int = 0                # deepseek-v3 multi-token prediction
    # numerics / execution
    dtype: str = "bfloat16"
    remat_policy: str = "full"        # "full" | "dots" | "none"
    scan_layers: bool = True
    # citation tag from the assignment table
    source: str = ""

    # ---- derived -----------------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def sub_quadratic(self) -> bool:
        return self.family in (Family.SSM, Family.HYBRID)

    @property
    def has_decoder(self) -> bool:
        return True  # every zoo member has an autoregressive decoder

    # ---- parameter counting (used for 6ND roofline "useful flops") --------
    def _attn_params(self) -> int:
        d, h, kvh, dh = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        if self.attention == AttentionKind.MLA:
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = d * m.q_lora_rank + m.q_lora_rank * h * qk          # q down/up
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)          # kv down + k_rope
            p += m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
            p += h * m.v_head_dim * d                               # o proj
            return p
        if self.attention == AttentionKind.NONE:
            return 0
        return d * h * dh + 2 * d * kvh * dh + h * dh * d           # qkv + o

    def _mlp_params(self) -> int:
        mats = 3 if self.mlp_gated else 2
        return mats * self.d_model * self.d_ff

    def _moe_layer_params(self, active_only: bool) -> int:
        m = self.moe
        dff = m.d_ff_expert or self.d_ff
        per_expert = 3 * self.d_model * dff
        n_routed = m.top_k if active_only else m.n_experts
        return (n_routed + m.n_shared) * per_expert + self.d_model * m.n_experts

    def _ssm_layer_params(self) -> int:
        s = self.ssm
        d_in = s.expand * self.d_model
        nheads = d_in // s.headdim
        p = self.d_model * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)
        p += d_in * s.conv_kernel + d_in * self.d_model             # conv + out
        p += 2 * nheads                                              # A_log, D
        return p

    def _rglru_block_params(self) -> int:
        hy = self.hybrid
        w = hy.lru_width or self.d_model
        p = 2 * self.d_model * w                                     # two in-proj branches
        p += w * hy.conv_width                                       # temporal conv
        p += 2 * w * w // 1                                          # gates (diag-block approx: full)
        p += w                                                       # Lambda
        p += w * self.d_model                                        # out proj
        return p

    def param_count(self, active_only: bool = False) -> int:
        """Total (or MoE-active) parameter count, embeddings included."""
        d = self.d_model
        n = 0
        per_layer_norms = 2 * d
        if self.family == Family.SSM:
            n += self.n_layers * (self._ssm_layer_params() + d)
        elif self.family == Family.HYBRID:
            hy = self.hybrid
            pat = hy.pattern
            for i in range(self.n_layers):
                kind = pat[i % len(pat)]
                if kind == "recurrent":
                    n += self._rglru_block_params()
                else:
                    n += self._attn_params()
                n += self._mlp_params() + per_layer_norms
        else:
            for i in range(self.n_layers):
                n += self._attn_params() + per_layer_norms
                if self.moe is not None and i >= self.moe.first_dense:
                    n += self._moe_layer_params(active_only)
                else:
                    n += self._mlp_params()
        if self.encdec is not None:
            e = self.encdec
            enc_layer = self._attn_params() + self._mlp_params() + per_layer_norms
            cross = self._attn_params() + d
            n += e.n_encoder_layers * enc_layer
            n += self.n_layers * cross                               # decoder cross-attn
        n += self.vocab * d                                          # embed
        if not self.tie_embeddings:
            n += self.vocab * d                                      # lm head
        if self.mtp_depth:
            n += self.mtp_depth * (self._attn_params() + self._moe_layer_params(active_only)
                                   + per_layer_norms + 2 * d * d)
        n += d                                                       # final norm
        return int(n)

    def active_param_count(self) -> int:
        return self.param_count(active_only=True)

    def describe(self) -> str:
        tot = self.param_count() / 1e9
        act = self.active_param_count() / 1e9
        s = f"{self.name}: {self.family.value} {self.n_layers}L d={self.d_model} {tot:.2f}B params"
        if self.moe:
            s += f" ({act:.2f}B active)"
        return s
