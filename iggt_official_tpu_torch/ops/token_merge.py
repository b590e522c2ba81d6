"""Training-free K/V token merging for the global-attention blocks.

Counterpart of `iggt_official_tpu/ops/token_merge.py` (FastVGGT-style, see
PAPERS.md).  The tokens of many views repeat each other, so the global
blocks can attend over a merged key/value set:

- ToMe-style bipartite soft matching on cosine similarity (even positions
  are the targets, odd positions the merge candidates); protected tokens
  (camera and register tokens and the whole reference view 0) are excluded
  from both sides, so their keys and values pass through exactly;
- queries stay full-length and only K/V are merged, so the output token
  count is unchanged and nothing is unmerged;
- the plan is computed once per forward, on the trunk's input tokens, and
  every global block uses it;
- a merged key of ``s`` source tokens carries the proportional-attention
  bias ``log(s)``, which the flash kernel takes as its per-key bias.

What differs from the JAX package, and why:

- ``top_k``'s order among the chosen candidates is unspecified (in both
  frameworks), so the plan sorts them: ``src_idx`` ascends.  ``kept_idx``
  does not depend on that order; ``dst`` follows ``src_idx``.
- `merge_kv` sums each target's sources in a fixed order (the kept token,
  then its sources in ``src_idx`` order) with a segment sum over one
  permutation of the tokens, so two runs on the card give equal bytes
  (``index_add_`` / ``scatter_add_`` sum in atomic order there).
- The merged attention takes the fused protocol (`supports_fused_qk_prep`):
  it preps q and k first (the prep kernel alone on the card), merges the
  prepped K and the raw V, then calls the flash kernel with the key bias.
  The JAX package applies the same per-row prep before its merge (its merged
  attention takes prepped q/k), rounding twice in bf16 (after the LayerNorm
  and after RoPE) where the kernel rounds once.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from iggt_official_tpu_torch.ops.flash_attention import flash_attention, qk_prep


class MergePlan(NamedTuple):
    kept_idx: torch.Tensor  # (B, N - r) token indices that survive, targets first
    src_idx: torch.Tensor   # (B, r) token indices merged away, ascending
    dst: torch.Tensor       # (B, r) position in kept_idx receiving each source


def protected_tokens(S: int, P: int, patch_start_idx: int) -> np.ndarray:
    """(S * P,) bool: the whole reference view 0 and every view's camera and
    register tokens, which neither merge away nor receive merges."""
    frame_id = np.repeat(np.arange(S), P)
    pos_in_frame = np.tile(np.arange(P), S)
    return (frame_id == 0) | (pos_in_frame < patch_start_idx)


def merge_count(r: int, protect: np.ndarray) -> int:
    """``r`` clamped to the unprotected odd-position candidates (0 when every
    token is protected, as with one view)."""
    return max(0, min(r, int((~protect)[1::2].sum())))


def compute_merge_plan(x: torch.Tensor, r: int, protect: torch.Tensor) -> MergePlan:
    """Bipartite soft matching over tokens ``x`` (B, N, C), in fp32.

    ``protect`` (B, N) bool marks tokens that neither merge away nor receive
    merges.  ``r`` must lie in (0, N // 2] and not exceed the unprotected
    odd-position tokens (the caller clamps it, `merge_count`).  Each chosen
    candidate merges into its most similar target, the first one on ties."""
    B, N, _ = x.shape
    nb = (N + 1) // 2          # even positions: merge targets
    na = N // 2                # odd positions: merge candidates
    if not 0 < r <= na:
        raise ValueError(f"r={r} out of range for {na} candidates")
    x = x.float()
    xn = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-6)
    a, b = xn[:, 1::2], xn[:, 0::2]
    scores = torch.einsum("bac,bkc->bak", a, b)           # (B, na, nb)
    neg = torch.tensor(-torch.inf, device=x.device)
    scores = torch.where(protect[:, 1::2, None], neg, scores)
    # protected targets receive no merges either: their K/V stay exact
    scores = torch.where(protect[:, None, 0::2], neg, scores)

    best = scores.amax(-1)                                # (B, na)
    best_dst = scores.argmax(-1)                          # (B, na) into the b-set
    del scores
    merge_a = torch.topk(best, r, dim=-1).indices.sort(-1).values   # (B, r)

    merged = torch.zeros((B, na), dtype=torch.int32, device=x.device)
    merged.scatter_(1, merge_a, 1)
    # kept candidates in their original order (a stable sort puts 0 first)
    kept_a = torch.argsort(merged, dim=-1, stable=True)[:, : na - r]
    even = (2 * torch.arange(nb, device=x.device)).expand(B, nb)
    kept_idx = torch.cat([even, 2 * kept_a + 1], dim=1)  # (B, N - r)
    return MergePlan(kept_idx=kept_idx, src_idx=2 * merge_a + 1,
                     dst=best_dst.gather(1, merge_a))


class _Segments(NamedTuple):
    order: torch.Tensor     # (B * N,) flat token rows, each target's segment together
    sizes: torch.Tensor     # (B, N - r) int64: tokens in each target's segment


def _segments(plan: MergePlan, N: int) -> _Segments:
    """Every token once, grouped by the kept slot it lands in: slot t's
    segment is kept token t, then its sources in ``src_idx`` order."""
    kept, src, dst = (t.long() for t in plan)
    B, nk = kept.shape
    slot = torch.cat([torch.arange(nk, device=dst.device).expand(B, nk), dst], 1)
    tokens = torch.cat([kept, src], dim=1)                             # (B, N)
    order = torch.argsort(slot, dim=1, stable=True)
    rows = tokens.gather(1, order) + N * torch.arange(B, device=tokens.device)[:, None]
    sizes = torch.ones((B, nk), dtype=torch.int64, device=tokens.device)
    sizes.scatter_add_(1, dst, torch.ones_like(dst))
    return _Segments(rows.reshape(-1), sizes)


def merge_kv(k: torch.Tensor, v: torch.Tensor, plan: MergePlan,
             segments: Optional[_Segments] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge K/V (B, N, H, D) down to (B, N - r, H, D) by averaging each
    merged source into its target, in fp32; returns contiguous (k, v) in
    their dtypes and the fp32 key bias log(sizes) (B, N - r)."""
    B, N, H, D = k.shape
    seg = segments if segments is not None else _segments(plan, N)
    lengths = seg.sizes.reshape(-1)
    denom = seg.sizes.to(torch.float32)[:, :, None, None]

    def reduce(x):
        rows = x.reshape(B * N, H * D)[seg.order].float()
        # the lengths cover every token once by construction (`_segments`), so
        # torch's check of them, a host sync per call, is skipped
        total = torch.segment_reduce(rows, "sum", lengths=lengths, axis=0, unsafe=True)
        return (total.reshape(B, -1, H, D) / denom).to(x.dtype)

    return reduce(k), reduce(v), torch.log(seg.sizes.to(torch.float32))


def make_merged_attention(plan: MergePlan) -> Callable:
    """attn_fn(q, k, v, rope_cos=None, rope_sin=None, qk_norm_params=None)
    that preps q and k (`qk_prep`), merges the prepped K and V, and runs the
    flash kernel against the merged K/V with the log-size key bias.  Takes
    the fused protocol, so `layers/blocks.py::Attention` hands it raw q/k."""
    N = plan.kept_idx.shape[1] + plan.src_idx.shape[1]
    segments = _segments(plan, N)

    def attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             rope_cos: Optional[torch.Tensor] = None,
             rope_sin: Optional[torch.Tensor] = None,
             qk_norm_params: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        if rope_cos is not None or qk_norm_params is not None:
            q, k = qk_prep(q, k, rope_cos, rope_sin, qk_norm_params)
        k_m, v_m, log_s = merge_kv(k, v, plan, segments)
        return flash_attention(q, k_m, v_m, key_bias=log_s)

    attn.supports_fused_qk_prep = True
    return attn
