"""Calibrated per-model execution profiles (paper Table 4 / Appendix A).

The paper reports, per model on an NVIDIA A100: the average end-to-end request
latency over 500 LMSYS prompts (Table 4) and the preemption-onset batch size
under a vLLM memory limit (Table 6).  We invert those into a latency model:

    iter_time(b, tokens) = overhead + tokens * decode_ms(b)
    decode_ms(b)         = decode_ms_1 * (1 + batch_slowdown * (b - 1))
    prefill_ms(b, n)     = n * prefill_ms_per_token

``decode_ms_1`` is calibrated so that mean-length (≈168-token) responses at
batch 1 match Table 4's average latency.  The batch-slowdown coefficient
models the memory-bound decode regime (larger batches raise per-iteration
time sub-linearly; throughput still improves).

The KV memory model reproduces Appendix A: preemption begins when resident
tokens exceed ``mem_limit_frac * HBM - weights``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

#: mean response length of the workload used for calibration (tokens)
CALIBRATION_MEAN_TOKENS = 168.0
#: H100 vs A100 decode speed (HBM3/HBM2e bandwidth; decode is memory-bound)
H100_SPEEDUP = 3.35
#: paper §6.2: measured scheduling overhead (batching + predictor), ms
SCHED_OVERHEAD_MS = 11.04
A100_HBM_BYTES = 80 * 1024**3


@dataclass(frozen=True)
class ModelProfile:
    name: str
    params_b: float            # billions
    avg_latency_ms: float      # paper Table 4
    n_layers: int
    n_kv_heads: int
    head_dim: int
    preempt_batch: int         # paper Table 6 (appendix)
    mem_limit_frac: float      # paper Table 6 vLLM memory limit
    batch_slowdown: float = 0.08
    prefill_speedup: float = 8.0  # prefill is compute-bound ≈ 8x decode rate

    #: hardware speed multiplier (1.0 = the A100 the paper profiled on;
    #: the Fig-7 scaling study ran on H100s ≈ 3.35x decode bandwidth)
    speedup: float = 1.0

    def scaled(self, speedup: float) -> "ModelProfile":
        import dataclasses

        return dataclasses.replace(self, speedup=speedup)

    @property
    def decode_ms_1(self) -> float:
        return self.avg_latency_ms / CALIBRATION_MEAN_TOKENS / self.speedup

    def decode_ms(self, batch: int) -> float:
        return self.decode_ms_1 * (1.0 + self.batch_slowdown * (batch - 1))

    def prefill_ms(self, batch: int, n_tokens: int) -> float:
        return n_tokens * self.decode_ms(batch) / self.prefill_speedup

    @property
    def kv_bytes_per_token(self) -> int:
        # fp16 K and V
        return 2 * self.n_layers * self.n_kv_heads * self.head_dim * 2

    @property
    def weight_bytes(self) -> int:
        return int(self.params_b * 1e9 * 2)

    def kv_capacity_tokens(self) -> int:
        budget = self.mem_limit_frac * A100_HBM_BYTES - self.weight_bytes
        return max(int(budget // self.kv_bytes_per_token), 0)


#: paper Table 4 + Table 6 (+ model cards for dims)
PROFILES: Dict[str, ModelProfile] = {
    p.name: p
    for p in [
        ModelProfile("opt6.7", 6.7, 1315.5, n_layers=32, n_kv_heads=32,
                     head_dim=128, preempt_batch=30, mem_limit_frac=0.40),
        ModelProfile("opt13", 13.0, 2643.2, n_layers=40, n_kv_heads=40,
                     head_dim=128, preempt_batch=60, mem_limit_frac=0.40),
        ModelProfile("lam7", 7.0, 6522.2, n_layers=32, n_kv_heads=32,
                     head_dim=128, preempt_batch=40, mem_limit_frac=0.30),
        ModelProfile("lam13", 13.0, 8610.2, n_layers=40, n_kv_heads=40,
                     head_dim=128, preempt_batch=120, mem_limit_frac=0.90),
        ModelProfile("vic", 13.0, 2964.9, n_layers=40, n_kv_heads=40,
                     head_dim=128, preempt_batch=90, mem_limit_frac=0.40),
    ]
}


def avg_request_rate(profile: ModelProfile, batch_size: int) -> float:
    """Paper §6.2: AVG.RequestRate = 1000 / AVG.Latency * batchsize."""
    return 1000.0 / profile.avg_latency_ms * batch_size
