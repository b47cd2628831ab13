"""Unified model configuration covering all ten assigned architectures,
and the port's own (DeepSeek-V2-Lite: MLA without a query LoRA, a dense
first layer before fine-grained and shared experts, YaRN RoPE, dropless
routing)."""
from __future__ import annotations

import dataclasses


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # --- attention ---
    attn_type: str = "gqa"         # gqa | mla | none
    sliding_window: int = 0        # 0 = full attention; >0 = SWA width
    rope_theta: float = 10000.0
    # --- YaRN RoPE (DeepSeek-V2; 0 = plain RoPE) ---
    yarn_factor: float = 0.0
    yarn_original_max_pos: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    # --- MLA (MiniCPM3 / DeepSeek-style) ---
    q_lora_rank: int = 0           # 0: the query straight from d_model (wq)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25  # 0: dropless (no token dropped)
    moe_d_ff: int = 0              # an expert's width (0: d_ff)
    moe_shared_d_ff: int = 0       # the shared experts' width, as one MLP
    moe_renormalize: bool = True   # top-k gates renormalised to sum to 1
    first_k_dense_replace: int = 0  # the first layers dense, width d_ff
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0             # N
    ssm_head_dim: int = 64         # P
    ssm_expand: int = 2            # d_inner = expand * d_model
    ssm_groups: int = 1            # G (B/C groups)
    ssm_conv_width: int = 4
    ssm_chunk: int = 256           # SSD chunk length
    # --- hybrid (Zamba2: shared attention every `hybrid_period` SSM layers) ---
    hybrid_period: int = 0
    # --- encoder-decoder (Seamless) ---
    encoder_layers: int = 0        # 0 = decoder-only
    # --- modality frontend stub ---
    frontend: str = "none"         # none | vision | audio
    frontend_tokens: int = 0       # patches / frames provided by input_specs
    # --- execution ---
    scan_unroll: int = 1   # >1: unroll layer scans (dry-run flop accounting)
    remat: bool = True     # activation-checkpoint each layer in train
    # --- §Perf beyond-paper optimization knobs (baseline = all off) ---
    attn_chunk: int = 0    # >0: online-softmax blocked attention (no SxS)
    mla_absorb: bool = False   # MLA decode: absorbed-matmul attention
    seq_parallel: bool = False  # sequence-parallel residuals (Megatron-SP)
    zero1: bool = False    # shard optimizer state over the data axis
    pin_cache_sharding: bool = False  # stop decode-cache reshard flapping
    swa_ring: bool = False  # ring-buffer KV cache sized to sliding_window
    # --- numerics ---
    dtype: str = "bfloat16"
    vocab_pad_mult: int = 2048     # pad vocab so model-axis sharding divides
    norm_eps: float = 1e-5
    citation: str = ""

    # ------------------------------ derived --------------------------- #
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad_mult)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def kv_latent_dim(self) -> int:
        """MLA cache entry width per token: compressed KV + shared rope key."""
        return self.kv_lora_rank + self.qk_rope_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def num_hybrid_groups(self) -> int:
        if not self.hybrid_period:
            return 0
        return self.num_layers // self.hybrid_period

    @property
    def hybrid_remainder(self) -> int:
        if not self.hybrid_period:
            return 0
        return self.num_layers - self.num_hybrid_groups * self.hybrid_period

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def num_moe_layers(self) -> int:
        """Layers with experts: all but the first `first_k_dense_replace`."""
        if not self.num_experts:
            return 0
        return self.num_layers - self.first_k_dense_replace

    def is_moe_layer(self, i: int) -> bool:
        return bool(self.num_experts) and i >= self.first_k_dense_replace

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline bookkeeping)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim if self.num_heads else 0
        n_attn = (self.num_heads * hd * d) * 2 + (self.num_kv_heads * hd * d) * 2
        if self.attn_type == "mla":
            qk = self.qk_nope_dim + self.qk_rope_dim
            n_q = (d * self.q_lora_rank
                   + self.q_lora_rank * self.num_heads * qk
                   if self.q_lora_rank else d * self.num_heads * qk)
            n_attn = (n_q
                      + d * (self.kv_lora_rank + self.qk_rope_dim)
                      + self.kv_lora_rank * self.num_heads
                      * (self.qk_nope_dim + self.v_head_dim)
                      + self.num_heads * self.v_head_dim * d)
        n_mlp = 3 * d * f
        if self.num_experts:
            n_mlp = (self.num_experts * 3 * d * self.expert_d_ff
                     + d * self.num_experts + 3 * d * self.moe_shared_d_ff)
        n_ssm = 0
        if self.attn_type == "none" or self.family in ("ssm", "hybrid"):
            di, g, n, h = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            n_ssm = (2 * d * di + 2 * d * g * n + d * h   # z,x,B,C,dt projections
                     + self.ssm_conv_width * (di + 2 * g * n)
                     + 3 * h + di * d + di)
        emb = v * d
        if self.family == "ssm":
            per_layer = n_ssm
        elif self.family == "hybrid":
            per_layer = n_ssm  # plus one shared attention block below
        else:
            per_layer = n_attn + n_mlp
        total = self.num_layers * per_layer + 2 * emb
        if self.num_experts and self.first_k_dense_replace:
            total += self.first_k_dense_replace * (3 * d * f - n_mlp)
        if self.family == "hybrid":
            total += n_attn + 3 * d * f  # the single shared attn+mlp block
        if self.is_encdec:
            # encoder stack + decoder cross-attention
            total += self.encoder_layers * (n_attn + n_mlp)
            total += self.num_layers * n_attn  # cross-attn per decoder layer
        return total

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE top-k) for 6·N_active·D."""
        if not self.num_experts:
            return self.param_count()
        unused = ((self.num_experts - self.experts_per_token) * 3
                  * self.d_model * self.expert_d_ff)
        return self.param_count() - self.num_moe_layers * unused


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
