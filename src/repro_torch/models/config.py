"""Model configuration covering all assigned architecture families."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    mlp_kind: str = "swiglu"    # swiglu | geglu | gelu
    qkv_bias: bool = False
    causal: bool = True
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    num_experts_padded: int = 0  # pad expert dim so it shards evenly (the
                                 # router masks padded experts to -inf)
    # --- SSM (mamba1 / mamba2) ---
    ssm_kind: str = ""          # "" | mamba1 | mamba2
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64      # mamba2 heads = d_inner // ssm_head_dim
    ssm_chunk: int = 128        # scan chunk for train/prefill
    # --- hybrid (zamba2-style shared attention block) ---
    attn_every: int = 0         # apply the shared attn+mlp block every N layers
    # the published Zamba2 block (all off: the block above, the JAX
    # package's): the layers before which a shared block runs; the blocks
    # alternate over those calls, each on RMSNorm([h, embedding]) (2d wide)
    # with no residual inside, its MLP's gate/up product plus the call's
    # own LoRA adapter, and the call's own d x d projection added to the
    # next Mamba layer's input
    hybrid_ids: tuple = ()
    shared_blocks: int = 1
    adapter_rank: int = 0
    attn_scale: float = 0.0     # the softmax scale; 0: 1 / sqrt(head_dim)
    gelu_approx: str = "tanh"   # the GeLU of geglu / gelu: "tanh" | "none"
    # --- modality frontend (stubbed per spec) ---
    frontend: str = ""          # "" | "patch" (vlm) | "frames" (audio)
    frontend_tokens: int = 0    # patches/frames per example provided as embeds
    # --- misc ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_chunk: int = 512       # kv-chunk for online-softmax attention
    loss_chunk: int = 1024      # seq-chunk for vocab-sharded CE loss
    remat: bool = True          # checkpoint each layer in the scan
    vocab_pad_multiple: int = 128  # pad embedding rows so vocab shards evenly
    fsdp: bool = False          # also place params and both moments in
                                # blocks over "data"; each layer gathers its
                                # blocks inside its (checkpointed) function
    constrain_acts: bool = False  # check that a rank's q holds its equal
                                  # block of the heads at model > 1
                                  # (layers.shard_heads); no number changes

    def __post_init__(self):
        # a configuration read from JSON gives the ids as a list
        object.__setattr__(self, "hybrid_ids", tuple(self.hybrid_ids))

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_kind == "mamba2" else 0

    @property
    def published_hybrid(self) -> bool:
        """The published Zamba2 block (``hybrid_ids`` set)."""
        return self.family == "hybrid" and bool(self.hybrid_ids)

    @property
    def attn_in(self) -> int:
        """The attention's input width: [h, embedding] in the published
        block."""
        return 2 * self.d_model if self.published_hybrid else self.d_model

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6 N D)."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_layer = 0
        if self.family in ("dense", "moe", "encoder", "vlm") or self.attn_every:
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        else:
            attn = 0
        if self.family == "moe":
            expert = 3 * d * self.d_ff
            mlp = self.num_experts * expert + self.num_shared_experts * expert
            mlp += d * self.num_experts  # router
        elif self.d_ff:
            mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
            mlp = mult * d * self.d_ff
        else:
            mlp = 0
        if self.ssm_kind:
            di, N = self.d_inner, self.ssm_state
            ssm = 2 * d * di + di * d + di * self.ssm_conv
            if self.ssm_kind == "mamba1":
                ssm += di * N + 2 * di * N + di * (di // 16) * 2  # A, B/C proj, dt proj
            else:
                ssm += 2 * di * N // self.ssm_head_dim * self.ssm_head_dim  # B/C heads
        else:
            ssm = 0
        if self.published_hybrid:
            # per-layer mamba2; the shared blocks (attention over attn_in,
            # gated MLP); per call an adapter (d r + 2 r f) and d x d
            a = self.attn_in
            block = (a * self.q_dim + 2 * a * self.kv_dim + self.q_dim * d
                     + 3 * d * self.d_ff + a + d)
            call = d * self.adapter_rank + 2 * self.adapter_rank * self.d_ff
            n += self.shared_blocks * block
            n += len(self.hybrid_ids) * (call + d * d)
            return n + (ssm + d) * L
        if self.family == "hybrid":
            # per-layer mamba2 + ONE shared attn+mlp block
            per_layer = ssm
            n += attn + 3 * d * self.d_ff
            n += per_layer * L + 2 * d * L  # norms
            return n
        per_layer = attn + mlp + ssm + 2 * d
        return n + per_layer * L

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        expert = 3 * d * self.d_ff
        mlp = (self.moe_top_k + self.num_shared_experts) * expert + d * self.num_experts
        return n + (attn + mlp + 2 * d) * L
