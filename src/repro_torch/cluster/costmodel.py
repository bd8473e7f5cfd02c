"""Analytic cost model for a LoRA-serving LLM inference server, calibrated
to the paper's measurements (§III-A). The cluster simulator uses it for
iteration times; the orchestrator uses it for operating points.

Calibration (derivation):
  * Fig 3 — single request, Llama-7B, input 2000: rank-128 prefill is
    2.7x rank-8. With lora overhead l(r) = x*r*base:
    (1+128x)/(1+8x) = 2.7  =>  x = 0.016 at TP=1.
  * Fig 5 — same at TP=8: ratio 1.2  =>  x(8) = 0.00169. Fitting
    x(tp) = x1 * tp^-beta gives beta = log(0.016/0.00169)/log(8) ~ 1.08
    (the LoRA BGMV/MBGMV path loses efficiency slower than 1/tp).
  * Fig 4 — Llama-70B TP=8: ratio 1.45 => x70(8) ~ 0.0039 ~ 2.3x the 7B
    value; consistent with x scaling linearly in d_model (8192/4096 = 2).
  =>  lora_factor(r, d, tp) = 0.016 * r * (d/4096) / tp^1.08
  * Fig 1 — co-serving r8 with r128 inflates the whole batch to max-rank
    cost: iteration cost uses max(rank in batch), which yields the +84%
    P95 TTFT skew in simulation.
  * Fig 3 bottom — decode (TBT) rank sensitivity is "subtle" (memory
    bound): decode lora factor is scaled by DECODE_LORA_DAMP = 0.15.
  * Beyond-paper: ``prefill_time_bucketed`` / ``decode_time_bucketed``
    charge the *sum of per-rank-bucket* costs instead of max(rank) — the
    cost-model mirror of rank-bucketed banks, used by ``SimServer`` when
    ``bank_mode="bucketed"``.
  * Fused-kernel terms (SGMV v2): the calibration above IS the fused
    single-dispatch kernel (one pass over the bank, LoRA intermediate
    resident in on-chip memory). ``fused=False`` charges what the
    legacy two-kernel / host-loop dispatchers additionally pay: the
    rank-r shrink output round-tripping HBM (write+read per token per
    target per layer) and the extra kernel launches (2 per application
    unfused, 2·n_buckets for the host-loop bucketed dispatcher, vs 1
    fused). ``steps=k`` amortizes the per-iteration scheduling floor
    ITER_OVERHEAD over a k-token fused decode dispatch
    (``ServingEngine.decode_steps``) — one host round-trip per k tokens.

  * Mesh-sharded engine terms: when ``mesh_shape=(dp, tp)`` is set the
    model charges explicit ICI ring-all-reduce time per iteration
    (``iteration_ici_time``): 2 activation all-reduces per layer plus
    the co-sharded LoRA rank-r psum per target per layer — the exact
    collectives the sharded ``ServingEngine`` issues. Zero at tp=1 and
    when ``mesh_shape`` is None (legacy abstract-TP behavior unchanged).

Hardware reference: A100 SXM 40GB (312 TF bf16, ~1.55 TB/s HBM), the
paper's Standard_ND96asr_v4 nodes. The TPU deployment path of this repo
uses the v5e constants in launch/roofline instead; the simulator keeps the
paper's GPUs so its figures are comparable with the paper's.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

A100_FLOPS = 312e12          # bf16 peak / GPU
A100_HBM = 1.55e12           # bytes/s
# Absolute-scale calibration: the paper's stack (S-LoRA on A100, Fig 3/6)
# achieves far below peak — Fig 6 shows a single TP=4 server *saturating*
# at ~4 RPS (input 512 / output 128) for rank>=64. Backing that through
# the iteration model gives an effective prefill MFU ~0.07 and decode HBM
# efficiency ~0.35 (decode-bound saturation at ~550 tok/s/server).
MFU_PREFILL = 0.07           # achieved fraction during prefill
HBM_EFF_DECODE = 0.35        # achieved fraction during decode
X1 = 0.016                   # lora factor per unit rank at TP=1, d=4096
TP_BETA = 1.08
DECODE_LORA_DAMP = 0.15
ITER_OVERHEAD = 4.0e-3       # scheduling/kernel-launch floor per iteration
DISPATCH_OVERHEAD = 5e-6     # per extra kernel launch (unfused paths)
LORA_TARGETS = 4             # q/k/v/o LoRA applications per layer
# Interconnect constants for the mesh-sharded engine mode, mirrored from
# launch/mesh.py (kept import-light: the simulator must not touch jax
# device state by importing the mesh builders).
ICI_BW = 50e9                # bytes/s per link
ICI_LATENCY = 1e-6           # seconds per hop (per collective step)


@dataclasses.dataclass(frozen=True)
class ServerModel:
    """One LLM inference server (one base-model instance, TP over tp GPUs)."""
    n_params: float = 6.7e9          # Llama-7B
    d_model: int = 4096
    tp: int = 4
    max_batch_tokens: int = 8192     # prefill token budget per iteration
    max_decode_batch: int = 64
    # Engine mesh shape (dp, tp) for the mesh-sharded serving mode. None
    # (the default) keeps the legacy single-device model: `tp` above then
    # only scales compute/bandwidth (the paper's abstract TP) and NO ICI
    # collective cost is charged. When set, the last entry is the tensor-
    # parallel degree over the "model" axis and every iteration pays the
    # explicit ring-all-reduce terms below.
    mesh_shape: tuple | None = None

    # -- mesh / interconnect ---------------------------------------------
    @property
    def tp_degree(self) -> int:
        """Tensor-parallel degree over the "model" mesh axis."""
        return self.mesh_shape[-1] if self.mesh_shape else self.tp

    @property
    def dp_degree(self) -> int:
        return self.mesh_shape[0] if self.mesh_shape else 1

    def ici_collective_time(self, nbytes: float) -> float:
        """Ring all-reduce of an ``nbytes`` buffer over the "model" axis:
        2(tp-1) hops of latency plus 2(tp-1)/tp of the buffer crossing
        ICI. Exactly zero at tp=1 (no collective is issued) and when no
        mesh is configured; strictly monotone in ``nbytes`` otherwise."""
        tp = self.tp_degree
        if self.mesh_shape is None or tp <= 1:
            return 0.0
        return (2 * (tp - 1) * ICI_LATENCY
                + (2.0 * (tp - 1) / tp) * nbytes / ICI_BW)

    def iteration_ici_time(self, n_tokens: int,
                           bucket_tokens: Mapping[int, int] | None = None
                           ) -> float:
        """Per-iteration collective cost of the mesh-sharded engine: two
        activation all-reduces per layer (attention o-proj + MLP down-
        proj, (n_tokens, d_model) bf16) plus the co-sharded LoRA rank-r
        psum — one per target per layer, sized (T_b, r_b) per bucket
        (never the full d_model delta: the expand output is already
        column-sharded like the base projection)."""
        layers = self._n_layers()
        t = 2 * layers * self.ici_collective_time(
            2.0 * n_tokens * self.d_model)
        for r, nt in (bucket_tokens or {}).items():
            if r > 0 and nt > 0:
                t += layers * LORA_TARGETS * self.ici_collective_time(
                    2.0 * nt * r)
        return t

    # -- primitives ------------------------------------------------------
    def lora_factor(self, rank: int) -> float:
        if rank <= 0:
            return 0.0
        return X1 * rank * (self.d_model / 4096.0) / (self.tp ** TP_BETA)

    def _prefill_per_token(self) -> float:
        return 2.0 * self.n_params / (self.tp * A100_FLOPS * MFU_PREFILL)

    def _n_layers(self) -> float:
        return 32 * (self.d_model / 4096.0)

    def unfused_penalty(self, bucket_tokens: Mapping[int, int]) -> float:
        """Extra seconds per iteration the legacy (pre-fused) SGMV
        dispatchers pay vs the fused single dispatch: the rank-r shrink
        intermediate round-tripping HBM (write + read, bf16, per token
        per target per layer) plus the extra kernel launches — 2 per
        LoRA application per bucket (shrink + expand, host-loop
        dispatched per bucket) where the fused path launches 1 total."""
        apps = self._n_layers() * LORA_TARGETS
        inter_bytes = sum(2 * 2 * r * nt
                          for r, nt in bucket_tokens.items()) * apps
        launches = (2 * max(1, len(bucket_tokens)) - 1) * apps
        return (inter_bytes / (self.tp * A100_HBM)
                + launches * DISPATCH_OVERHEAD)

    def prefill_time(self, n_tokens: int, max_rank: int, *,
                     fused: bool = True) -> float:
        """Seconds for one prefill iteration of `n_tokens` total tokens,
        co-batched with max adapter rank `max_rank` (everyone pays it).
        The calibration is the fused single-dispatch kernel;
        ``fused=False`` adds the legacy dispatchers' penalty."""
        base = self._prefill_per_token() * n_tokens
        t = ITER_OVERHEAD + base * (1.0 + self.lora_factor(max_rank))
        t += self.iteration_ici_time(n_tokens, {max_rank: n_tokens})
        if not fused:
            t += self.unfused_penalty({max_rank: n_tokens})
        return t

    def prefill_time_bucketed(self, bucket_tokens: Mapping[int, int], *,
                              fused: bool = True) -> float:
        """Rank-bucketed prefill: `bucket_tokens` maps bucket rank ->
        token count in that bucket. The base model pass covers all tokens
        once; each bucket's LoRA overhead applies only to its own tokens
        at its own rank (sum of per-bucket costs), instead of every token
        paying `max(rank)` — strictly cheaper than `prefill_time` for any
        batch mixing >= 2 rank buckets. ``fused=False`` models the
        host-loop dispatcher (2 launches per bucket + HBM round-trip)."""
        per_tok = self._prefill_per_token()
        total = sum(bucket_tokens.values())
        lora = sum(nt * self.lora_factor(r)
                   for r, nt in bucket_tokens.items())
        t = ITER_OVERHEAD + per_tok * (total + lora)
        t += self.iteration_ici_time(total, dict(bucket_tokens))
        if not fused:
            t += self.unfused_penalty(dict(bucket_tokens))
        return t

    def adapter_read_bytes(self, rank: int) -> float:
        """BGMV gather per request per decode iteration: A+B on 4 targets,
        every layer, bf16 — padded to the batch max rank (Punica BGMV
        semantics, §III-A.5)."""
        return (2 * 2 * LORA_TARGETS * self.d_model * rank
                * self._n_layers())

    def kv_read_bytes(self, seq_len: int = 512) -> float:
        """Per-request KV read per decode iteration: K+V, bf16, every
        layer, GQA KV width d_model/4 (8 KV heads x head_dim d/32 at the
        Llama-7B reference shape)."""
        kv_width = self.d_model / 4.0
        return 2 * 2 * self._n_layers() * kv_width * seq_len

    def decode_time(self, batch: int, max_rank: int,
                    seq_len: int = 512, *, steps: int = 1,
                    fused: bool = True) -> float:
        """Seconds for one decode iteration (1 token for every running
        request). Weight-read bound; KV + per-request max-rank adapter
        gathers grow with batch. ``steps=k`` models a k-token fused
        decode dispatch (``decode_steps``): the per-iteration scheduling
        floor is paid once per dispatch, i.e. ITER_OVERHEAD/k per
        token-iteration."""
        weight_bytes = 2.0 * self.n_params
        kv_bytes = batch * self.kv_read_bytes(seq_len)
        lora_bytes = batch * self.adapter_read_bytes(max_rank)
        base = (weight_bytes + kv_bytes + lora_bytes) / (
            self.tp * A100_HBM * HBM_EFF_DECODE)
        t = ITER_OVERHEAD / max(1, steps) + base
        t += self.iteration_ici_time(batch, {max_rank: batch})
        if not fused:
            t += self.unfused_penalty({max_rank: batch})
        return t

    def decode_time_bucketed(self, bucket_batch: Mapping[int, int],
                             seq_len: int = 512, *, steps: int = 1,
                             fused: bool = True) -> float:
        """Rank-bucketed decode: `bucket_batch` maps bucket rank ->
        number of running requests in that bucket. Each request's adapter
        gather is at its own bucket rank (sum of per-bucket reads)
        instead of the batch max. ``steps`` / ``fused`` as in
        ``decode_time``."""
        batch = sum(bucket_batch.values())
        weight_bytes = 2.0 * self.n_params
        kv_bytes = batch * self.kv_read_bytes(seq_len)
        lora_bytes = sum(cnt * self.adapter_read_bytes(r)
                         for r, cnt in bucket_batch.items())
        base = (weight_bytes + kv_bytes + lora_bytes) / (
            self.tp * A100_HBM * HBM_EFF_DECODE)
        t = ITER_OVERHEAD / max(1, steps) + base
        t += self.iteration_ici_time(batch, dict(bucket_batch))
        if not fused:
            t += self.unfused_penalty(dict(bucket_batch))
        return t

    # -- aggregates -------------------------------------------------------
    def prefill_token_rate(self, rank: int) -> float:
        """Sustained prefill tokens/s when serving only rank-`rank` load."""
        t = self.prefill_time(self.max_batch_tokens, rank)
        return self.max_batch_tokens / t

    def decode_token_rate(self, rank: int, batch: int = 32) -> float:
        return batch / self.decode_time(batch, rank)

    def operating_point(self, rank: int, headroom: float = 0.8,
                        ref_prompt: int = 512, ref_output: int = 128
                        ) -> float:
        """Max total TPS (prompt+output tokens) under SLO for a server
        dedicated to rank-`rank` load (paper: profiled a priori). Combines
        the prefill and decode phases for the reference request shape;
        `headroom` keeps queues stable (P95 under SLO needs rho<1)."""
        t_req = (ref_prompt / self.prefill_token_rate(rank)
                 + ref_output / self.decode_token_rate(rank))
        rate = (ref_prompt + ref_output) / t_req
        return headroom * rate


def profile_operating_points(server: ServerModel,
                             ranks: Iterable[int],
                             headroom: float = 0.8):
    """The paper's a-priori profiling step (§IV-A)."""
    return {r: server.operating_point(r, headroom) for r in sorted(set(ranks))}


def co_serving_slowdown(server: ServerModel, rank_a: int, rank_b: int
                        ) -> float:
    """Fig 1 reproduction: relative prefill slowdown of rank_a requests
    when co-batched with rank_b (vs a pure rank_a batch)."""
    t_mixed = server.prefill_time(server.max_batch_tokens,
                                  max(rank_a, rank_b))
    t_pure = server.prefill_time(server.max_batch_tokens, rank_a)
    return t_mixed / t_pure


MODEL_PRESETS = {
    "llama-7b": dict(n_params=6.7e9, d_model=4096),
    "llama-30b": dict(n_params=32.5e9, d_model=6656),
    "llama-70b": dict(n_params=70e9, d_model=8192),
}


def make_server(model: str = "llama-7b", tp: int = 4, **kw) -> ServerModel:
    preset = dict(MODEL_PRESETS[model])
    preset.update(kw)
    return ServerModel(tp=tp, **preset)
