"""Architecture config schema + input-shape suite + registry.

Counterpart of ``repro.configs.base``, copied field for field (pure Python,
no torch): the same dataclasses, defaults, registries, parameter counts and
errors, so a config means the same model in both packages.

The CPU smoke-test variants of the transformer zoo live in the inline
``REDUCED_CONFIGS`` registry below. The paper's own GNN scenarios
(``GNN_ARCH_IDS``) keep one module each in this package; resolve those with
``get_gnn_arch`` / ``get_gnn_reduced``. The full-size transformer
hyperparameter modules were seed-era dead weight and were removed — see git
history for the published numbers.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class GlasuSplit:
    """The paper's technique applied to a transformer backbone (§DESIGN.md 4).

    The hidden dimension is vertically partitioned into ``n_clients`` feature
    shards (mapped onto the 'model' mesh axis). Cross-shard mixing (concat
    aggregation + re-projection) happens ONLY at ``sync_layers``; all other
    layers are block-diagonal (client-local, collective-free). ``local_steps``
    = Q stale-update steps per sampled batch.
    """
    n_clients: int = 4
    sync_every: int = 2            # aggregate every k-th layer (K = L/sync_every)
    local_steps: int = 1           # Q


@dataclass(frozen=True)
class ArchConfig:
    name: str
    kind: str                      # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    # --- MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0        # leading dense layers (DeepSeek: 1)
    router_aux_weight: float = 0.01
    capacity_factor: float = 1.25
    # --- attention variant
    attn: str = "gqa"              # gqa | mla | none
    kv_lora: int = 0
    d_nope: int = 0
    d_rope: int = 0
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    # --- ssm / hybrid
    block: str = "attn"            # attn | mamba2 | rwkv6
    d_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    attn_every: int = 0            # zamba2: shared attn block every N ssm layers
    ssm_chunk: int = 256
    # --- encoder-decoder
    enc_layers: int = 0
    dec_layers: int = 0
    # --- modality frontend STUB (audio/vlm): input_specs provides embeddings
    frontend: Optional[str] = None
    frontend_tokens: int = 0
    # --- training
    dtype: str = "bfloat16"
    optimizer: str = "adamw"       # adamw | adafactor | sgd
    lr: float = 3e-4
    remat: bool = True
    grad_accum: int = 1            # microbatches per step (activation memory lever)
    # --- paper technique
    glasu: Optional[GlasuSplit] = None
    # --- kernels
    use_flash: bool = False

    @property
    def is_encdec(self) -> bool:
        return self.kind in ("encdec", "audio") and self.enc_layers > 0

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate total parameter count (for MODEL_FLOPS)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        if self.block == "mamba2":
            d_inner = self.ssm_heads * self.ssm_head_dim
            per = d * (2 * d_inner + 2 * self.d_state + self.ssm_heads) + d_inner * d
            n_ssm = self.n_layers
            attn_blocks = (self.n_layers // self.attn_every) if self.attn_every else 0
            per_attn = (d * (self.n_heads + 2 * self.n_kv) * self.d_head
                        + self.n_heads * self.d_head * d + 3 * d * f)
            return per * n_ssm + (per_attn if attn_blocks else 0) + 2 * v * d
        if self.block == "rwkv6":
            d_inner = self.ssm_heads * self.ssm_head_dim
            per = 4 * d * d_inner + d_inner * d + 2 * d * f
            return per * self.n_layers + 2 * v * d
        if self.attn == "mla":
            attn = (d * self.n_heads * (self.d_nope + self.d_rope)
                    + d * (self.kv_lora + self.d_rope)
                    + self.kv_lora * self.n_heads * (self.d_nope + self.d_head)
                    + self.n_heads * self.d_head * d)
        else:
            attn = (d * (self.n_heads + 2 * self.n_kv) * self.d_head
                    + self.n_heads * self.d_head * d)
        mlp_dense = 3 * d * f
        if self.moe:
            mlp_moe = 3 * d * self.d_ff_expert * self.n_experts \
                + 3 * d * self.d_ff_expert * self.n_shared_experts
            n_moe = self.n_layers - self.n_dense_layers
            mlp_total = mlp_moe * n_moe + mlp_dense * self.n_dense_layers
        else:
            n = self.enc_layers + self.dec_layers if self.is_encdec else self.n_layers
            mlp_total = mlp_dense * n
        n = self.enc_layers + self.dec_layers if self.is_encdec else self.n_layers
        total = attn * n + mlp_total + 2 * v * d
        if self.is_encdec:
            total += attn * self.dec_layers  # cross attention
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        mlp_active = 3 * d * self.d_ff_expert * (self.top_k + self.n_shared_experts)
        mlp_all = 3 * d * self.d_ff_expert * (self.n_experts + self.n_shared_experts)
        n_moe = self.n_layers - self.n_dense_layers
        return self.param_count() - (mlp_all - mlp_active) * n_moe


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# Reduced (CPU smoke) variants of the transformer zoo, keyed by arch id.
# Values are kwargs diffs from ArchConfig defaults — everything not listed is
# the dataclass default. These were previously computed per-module as
# ``reduced()``; the full-size modules are gone, the smoke variants stay.
REDUCED_CONFIGS = {
    "seamless_m4t_large_v2": dict(name='seamless-m4t-large-v2', kind='audio', n_layers=2, d_model=256, n_heads=4, n_kv=4, d_head=64, d_ff=512, vocab=512, enc_layers=2, dec_layers=2, frontend='audio', dtype='float32', lr=0.0001, remat=False),
    "pixtral_12b": dict(name='pixtral-12b', kind='vlm', n_layers=2, d_model=256, n_heads=4, n_kv=2, d_head=64, d_ff=512, vocab=512, rope_theta=1000000.0, frontend='vision', frontend_tokens=16, dtype='float32', lr=0.0002, remat=False),
    "smollm_360m": dict(name='smollm-360m', kind='dense', n_layers=2, d_model=240, n_heads=3, n_kv=1, d_head=80, d_ff=512, vocab=512, dtype='float32', remat=False),
    "deepseek_v2_lite_16b": dict(name='deepseek-v2-lite-16b', kind='moe', n_layers=2, d_model=256, n_heads=4, n_kv=4, d_head=64, d_ff=512, vocab=512, moe=True, n_experts=4, top_k=2, n_shared_experts=1, d_ff_expert=128, n_dense_layers=1, attn='mla', kv_lora=64, d_nope=32, d_rope=16, dtype='float32', lr=0.0002, remat=False),
    "phi35_moe_42b": dict(name='phi3.5-moe-42b-a6.6b', kind='moe', n_layers=2, d_model=256, n_heads=4, n_kv=2, d_head=64, d_ff=512, vocab=512, moe=True, n_experts=4, top_k=2, d_ff_expert=128, dtype='float32', lr=0.0002, remat=False),
    "zamba2_1p2b": dict(name='zamba2-1.2b', kind='hybrid', n_layers=2, d_model=256, n_heads=4, n_kv=4, d_head=64, d_ff=512, vocab=512, block='mamba2', d_state=16, ssm_heads=8, ssm_head_dim=32, attn_every=2, ssm_chunk=32, dtype='float32', remat=False),
    "rwkv6_7b": dict(name='rwkv6-7b', kind='ssm', n_layers=2, d_model=256, n_heads=0, n_kv=0, d_head=0, d_ff=512, vocab=512, attn='none', block='rwkv6', ssm_heads=4, ssm_head_dim=64, dtype='float32', remat=False),
    "llama3_405b": dict(name='llama3-405b', kind='dense', n_layers=2, d_model=512, n_heads=8, n_kv=2, d_head=64, d_ff=1024, vocab=512, rope_theta=500000.0, dtype='float32', lr=8e-05, remat=False),
    "yi_34b": dict(name='yi-34b', kind='dense', n_layers=2, d_model=448, n_heads=7, n_kv=1, d_head=64, d_ff=1024, vocab=512, rope_theta=5000000.0, dtype='float32', lr=0.0001, remat=False),
    "granite_20b": dict(name='granite-20b', kind='dense', n_layers=2, d_model=256, n_heads=4, n_kv=1, d_head=64, d_ff=512, vocab=512, dtype='float32', lr=0.0001, remat=False),
}

ARCH_IDS = [
    "seamless_m4t_large_v2", "pixtral_12b", "smollm_360m",
    "deepseek_v2_lite_16b", "phi35_moe_42b", "zamba2_1p2b",
    "rwkv6_7b", "llama3_405b", "yi_34b", "granite_20b",
]

# Paper's own GNN configs live beside the transformer zoo. Each id is a real
# module whose CONFIG is a ``repro_torch.api.config.ExperimentConfig`` (the GNN
# experiments are full scenarios, not bare architectures); resolve them with
# ``get_gnn_arch`` / ``get_gnn_reduced``.
GNN_ARCH_IDS = ["glasu_gcnii", "glasu_gcn", "glasu_gat"]


def get_arch(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "p")
    if arch_id in REDUCED_CONFIGS:
        raise ValueError(
            f"full-size config for {arch_id!r} was removed with the seed-era "
            f"stub modules; use get_reduced({arch_id!r}) for the CPU smoke "
            f"variant, or recover the published hyperparameters from git "
            f"history")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def _gnn_module(arch_id: str):
    if arch_id not in GNN_ARCH_IDS:
        raise ValueError(f"unknown GNN arch {arch_id!r}; expected one of "
                         f"{GNN_ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_gnn_arch(arch_id: str):
    """Resolve a GNN_ARCH_IDS entry to its ExperimentConfig."""
    return _gnn_module(arch_id).CONFIG


def get_gnn_reduced(arch_id: str):
    """CPU smoke-test variant of a GNN_ARCH_IDS entry."""
    return _gnn_module(arch_id).reduced()


def get_reduced(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "p")
    try:
        return ArchConfig(**REDUCED_CONFIGS[arch_id])
    except KeyError:
        raise ValueError(f"unknown arch {arch_id!r}; expected one of "
                         f"{ARCH_IDS} (GNN scenarios resolve via "
                         f"get_gnn_reduced)") from None
