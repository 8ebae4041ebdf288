"""Model architecture configs + presets (the port's own copy of
``langstream_tpu/models/configs.py``; field semantics follow the HF
config.json conventions so the two packages describe a model identically).

``attention_impl`` keeps its three values, read for PyTorch:
``"auto"`` and ``"pallas"`` both select the kernel path (the hand-written
CUDA kernel on the card, the kernel's plain version on the CPU), ``"jnp"``
selects the gathered reference ``attention``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    max_seq_len: int = 8192
    activation: str = "silu"  # silu (llama/mixtral) | gelu (gemma)
    tie_embeddings: bool = False
    # gemma-style stabilisers
    embedding_scale: bool = False  # multiply embeddings by sqrt(d_model)
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    # MoE (mixtral-style); n_experts=0 → dense FFN
    n_experts: int = 0
    n_experts_per_tok: int = 2
    # expert capacity = ceil(T*k*factor/E) (≤0 → lossless C=T)
    moe_capacity_factor: float = 2.0
    dtype: str = "bfloat16"
    # "auto" | "pallas" → kernel path; "jnp" → gathered reference attention
    attention_impl: str = "auto"
    # KV cache storage: "model" (activation dtype) | "int8" (per-token
    # per-head symmetric quant)
    kv_cache_dtype: str = "model"
    # llama-3.1-style NTK rope scaling (HF rope_scaling type "llama3")
    rope_scaling_factor: Optional[float] = None
    rope_scaling_low_freq_factor: float = 1.0
    rope_scaling_high_freq_factor: float = 4.0
    rope_scaling_original_max_seq_len: int = 8192

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


MODEL_PRESETS: dict[str, ModelConfig] = {
    # test-size configs (CI / CPU) — dims divisible by 8
    "tiny-test": ModelConfig(
        name="tiny-test",
        vocab_size=512,
        d_model=64,
        n_layers=2,
        n_heads=8,
        n_kv_heads=4,
        d_ff=128,
        max_seq_len=1024,
    ),
    "tiny-moe-test": ModelConfig(
        name="tiny-moe-test",
        vocab_size=512,
        d_model=64,
        n_layers=2,
        n_heads=8,
        n_kv_heads=4,
        d_ff=128,
        max_seq_len=256,
        n_experts=8,
        n_experts_per_tok=2,
    ),
    "gemma-2b": ModelConfig(
        name="gemma-2b",
        vocab_size=256000,
        d_model=2048,
        n_layers=18,
        n_heads=8,
        n_kv_heads=1,
        d_ff=16384,
        head_dim=256,
        rope_theta=10000.0,
        activation="gelu",
        tie_embeddings=True,
        embedding_scale=True,
        max_seq_len=8192,
    ),
    "llama-3-8b": ModelConfig(
        name="llama-3-8b",
        vocab_size=128256,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        rope_theta=500000.0,
        rms_norm_eps=1e-5,
        max_seq_len=8192,
    ),
    "llama-3-8b-shallow": ModelConfig(
        # 8B widths with 4 layers
        name="llama-3-8b-shallow",
        vocab_size=128256,
        d_model=4096,
        n_layers=4,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        rope_theta=500000.0,
        rms_norm_eps=1e-5,
        max_seq_len=8192,
    ),
    "llama-3.1-8b": ModelConfig(
        # llama-3-8b widths + NTK rope scaling → 128k context
        name="llama-3.1-8b",
        vocab_size=128256,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        rope_theta=500000.0,
        rms_norm_eps=1e-5,
        max_seq_len=131072,
        rope_scaling_factor=8.0,
        rope_scaling_low_freq_factor=1.0,
        rope_scaling_high_freq_factor=4.0,
        rope_scaling_original_max_seq_len=8192,
    ),
    "mixtral-8x1b": ModelConfig(
        name="mixtral-8x1b",
        vocab_size=32000,
        d_model=2048,
        n_layers=24,
        n_heads=16,
        n_kv_heads=8,
        d_ff=7168,
        rope_theta=1000000.0,
        rms_norm_eps=1e-5,
        max_seq_len=32768,
        n_experts=8,
        n_experts_per_tok=2,
    ),
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b",
        vocab_size=32000,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        rope_theta=1000000.0,
        rms_norm_eps=1e-5,
        max_seq_len=32768,
        n_experts=8,
        n_experts_per_tok=2,
    ),
}


@dataclass
class GenerationOptions:
    """Per-request options. The port honours the sampling, stop and
    lifecycle knobs; the tenancy, adapter and grammar options of the JAX
    package wait for the slices that port those tiers."""

    max_new_tokens: int = 256
    temperature: float = 0.0  # 0 → greedy
    top_k: int = 0  # 0 → disabled
    top_p: float = 1.0
    stop_tokens: tuple[int, ...] = ()
    # request lifecycle (serving/engine.py): wall-clock budget in seconds
    # from submit. A request past its deadline finishes with
    # finish_reason="deadline" at the next chunk boundary (partial tokens
    # kept); one that expires while still queued fails with
    # DeadlineExceededError instead of taking a slot it can no longer use.
    deadline_s: Optional[float] = None
    # cap on the time spent waiting for a slot; exceeded → fails in queue
    max_queue_wait_s: Optional[float] = None

    @staticmethod
    def from_dict(d: dict) -> "GenerationOptions":
        stops = d.get("stop-tokens", d.get("stop_tokens", ()))
        deadline = d.get("deadline", d.get("deadline-s", d.get("deadline_s")))
        queue_wait = d.get("max-queue-wait", d.get("max-queue-wait-s", d.get("max_queue_wait_s")))
        return GenerationOptions(
            max_new_tokens=int(d.get("max-tokens", d.get("max_new_tokens", 256))),
            temperature=float(d.get("temperature", 0.0)),
            top_k=int(d.get("top-k", d.get("top_k", 0))),
            top_p=float(d.get("top-p", d.get("top_p", 1.0))),
            stop_tokens=tuple(int(t) for t in stops),
            deadline_s=float(deadline) if deadline is not None else None,
            max_queue_wait_s=float(queue_wait) if queue_wait is not None else None,
        )
