"""The port's token merging (`ops/token_merge.py`) against the JAX package's,
on the CPU.

Inputs come from numpy seeds; module weights from the port's seeded init,
perturbed (`test_torch_helpers.perturbed_state_dict`) and carried to JAX
with its own converter.  Tolerances:

- merge plans: equal indices.  The port sorts the chosen candidates
  (``src_idx`` ascends; ``top_k``'s order is unspecified), so JAX's
  (src_idx, dst) pairs are compared after the same sort.  A plan compares
  only where the data decide it: each test states the gap between the r-th
  and (r+1)-th best candidate scores and between each chosen candidate's
  best and second-best target, and asserts it is well above fp32 rounding
  (1e-5); a near tie there would be a property of the data, not a fault;
- `merge_kv` 1e-6 abs in fp32 (the same sums, the port's in a fixed order);
- the merged attention block 1e-5 relative in fp32 (summation order), 3e-2
  in bf16 (the test_torch_model.py bf16 limit: the kernel's plain version
  rounds q/k once after LayerNorm and RoPE, JAX twice, and JAX's CPU
  attention rounds its logits to bf16).  The prep-then-merge order is held
  by a control: merging the raw K and prepping the merged rows must miss the
  fp32 limit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggt_official_tpu.config import ModelConfig as JModelConfig
from iggt_official_tpu.layers.blocks import Attention as JAttention
from iggt_official_tpu.layers.rope import compute_rope_2d as jrope
from iggt_official_tpu.layers.rope import make_patch_positions as jpositions
from iggt_official_tpu.models.aggregator import Aggregator as JAggregator
from iggt_official_tpu.ops import token_merge as jtm
from iggt_official_tpu_torch.config import ModelConfig
from iggt_official_tpu_torch.layers import rope
from iggt_official_tpu_torch.layers.blocks import Attention
from iggt_official_tpu_torch.models.aggregator import Aggregator
from iggt_official_tpu_torch.ops import token_merge as tm
from iggt_official_tpu_torch.ops.flash_attention import flash_attention_plain, qk_prep_plain
from iggt_official_tpu_torch.utils.init import init_params

from .test_torch_helpers import jit, load_numpy, perturbed_state_dict, rel_err, to_flax

GAP = 1e-5


def _tokens(B, S, P, C, seed):
    return np.random.default_rng(seed).standard_normal((B, S * P, C)).astype(np.float32)


def _decision_gaps(x, protect, r):
    """(gap at the r-th place of the candidates' best scores, least gap
    between a chosen candidate's best and second-best target), from the
    scores in float64."""
    xn = x / np.sqrt((x.astype(np.float64) ** 2).sum(-1, keepdims=True) + 1e-6)
    s = np.einsum("bac,bkc->bak", xn[:, 1::2], xn[:, 0::2])
    s[np.broadcast_to(protect[:, 1::2, None], s.shape)] = -np.inf
    s[np.broadcast_to(protect[:, None, 0::2], s.shape)] = -np.inf
    top2 = -np.sort(-s, axis=-1)[..., :2]
    best = -np.sort(-top2[..., 0], axis=-1)
    chosen = np.argsort(-top2[..., 0], axis=-1, kind="stable")[:, :r]
    with np.errstate(invalid="ignore"):     # protected rows: -inf - -inf
        target_gap = np.take_along_axis(top2[..., 0] - top2[..., 1], chosen, 1).min()
    return float((best[:, r - 1] - best[:, r]).min()), float(target_gap)


def _jax_plan_sorted(jplan):
    order = np.argsort(np.asarray(jplan.src_idx), axis=1)
    return (np.asarray(jplan.kept_idx), np.take_along_axis(np.asarray(jplan.src_idx), order, 1),
            np.take_along_axis(np.asarray(jplan.dst), order, 1))


@pytest.mark.parametrize("S,P,C,r,seed", [(3, 21, 16, 9, 0), (4, 29, 32, 30, 1),
                                          (2, 21, 8, 7, 2)])
def test_merge_plan_matches_jax(S, P, C, r, seed):
    """Two batches of seeded tokens, view 0 and 5 special tokens per view
    protected: the port's plan equals JAX's (after the sort of the chosen
    candidates), protected tokens pass through, every source lands on an
    unprotected even token, and kept + sources partition the tokens."""
    B, psi = 2, 5
    x = _tokens(B, S, P, C, seed)
    protect = np.broadcast_to(tm.protected_tokens(S, P, psi), (B, S * P)).copy()
    assert r == tm.merge_count(r, protect[0])
    rank_gap, target_gap = _decision_gaps(x, protect, r)
    assert rank_gap > GAP and target_gap > GAP, (rank_gap, target_gap)

    plan = tm.compute_merge_plan(torch.from_numpy(x), r, torch.from_numpy(protect))
    jplan = jtm.compute_merge_plan(jnp.asarray(x), r, jnp.asarray(protect))
    for got, want in zip(plan, _jax_plan_sorted(jplan)):
        np.testing.assert_array_equal(got.numpy(), want)
    for b in range(B):
        kept, src = plan.kept_idx[b].numpy(), plan.src_idx[b].numpy()
        assert sorted(np.concatenate([kept, src])) == list(range(S * P))
        assert not protect[b, src].any()
        assert set(np.flatnonzero(protect[b])) <= set(kept)
        targets = kept[plan.dst[b].numpy()]
        assert (targets % 2 == 0).all() and not protect[b, targets].any()
        assert (np.diff(src) > 0).all()


def test_merge_count_clamps_to_the_candidates():
    """r is clamped to the unprotected odd-position tokens; one view protects
    every token (r = 0, no merge)."""
    protect = tm.protected_tokens(3, 13, 5)
    candidates = int((~protect)[1::2].sum())
    assert candidates == 8   # two views of 8 patches, 4 of them at odd positions
    assert tm.merge_count(10 ** 6, protect) == candidates
    assert tm.merge_count(3, protect) == 3
    assert tm.merge_count(100, tm.protected_tokens(1, 13, 5)) == 0
    with pytest.raises(ValueError):
        tm.compute_merge_plan(torch.zeros(1, 8, 4), 5, torch.zeros(1, 8, dtype=torch.bool))


def test_merge_kv_matches_jax():
    """fp32 K/V merged on JAX's plan (sorted): 1e-6 abs, key bias equal; the
    segments take every token once and their lengths sum to the tokens (what
    lets `merge_kv` skip torch's check of the lengths)."""
    B, S, P, H, D, r = 2, 3, 21, 2, 8, 9
    rng = np.random.default_rng(3)
    x = _tokens(B, S, P, 16, 4)
    protect = np.broadcast_to(tm.protected_tokens(S, P, 5), (B, S * P)).copy()
    kept, src, dst = _jax_plan_sorted(jtm.compute_merge_plan(jnp.asarray(x), r,
                                                             jnp.asarray(protect)))
    k, v = (rng.standard_normal((B, S * P, H, D)).astype(np.float32) for _ in range(2))
    jk, jv, jlog = jtm.merge_kv(jnp.asarray(k), jnp.asarray(v),
                                jtm.MergePlan(*(jnp.asarray(a) for a in (kept, src, dst))))
    plan = tm.MergePlan(*(torch.from_numpy(a) for a in (kept, src, dst)))
    pk, pv, plog = tm.merge_kv(torch.from_numpy(k), torch.from_numpy(v), plan)
    assert pk.is_contiguous() and pv.is_contiguous()
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(plog.numpy(), np.asarray(jlog))
    assert np.exp(plog.numpy()).sum() == B * S * P
    seg = tm._segments(plan, S * P)
    assert sorted(seg.order.tolist()) == list(range(B * S * P))
    assert seg.sizes.sum().item() == B * S * P and seg.sizes.min().item() >= 1


def _merge_then_prep(plan, positions_tables):
    """The control: merge the raw K (and V), then prep q and the merged K
    rows with the tables of the tokens they keep."""
    def attn(q, k, v, rope_cos=None, rope_sin=None, qk_norm_params=None):
        gq, bq, gk, bk = qk_norm_params
        k_m, v_m, log_s = tm.merge_kv(k, v, plan)
        idx = plan.kept_idx[:, :, None].expand(-1, -1, rope_cos.shape[-1])
        qp = qk_prep_plain(q, gq, bq, rope_cos, rope_sin)
        kp = qk_prep_plain(k_m, gk, bk, rope_cos.gather(1, idx), rope_sin.gather(1, idx))
        return flash_attention_plain(qp, kp, v_m, log_s)

    attn.supports_fused_qk_prep = True
    return attn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merged_attention_block_matches_jax(dtype):
    """A qk-norm + RoPE attention module over 3 views of 5 + 4x4 tokens with
    the merged attention of one plan, against JAX's `Attention` with
    `make_merged_attention` on the same weights; in fp32 the merge-then-prep
    control misses the limit."""
    B, S, h, w, psi, C, H, r = 1, 3, 4, 4, 5, 64, 2, 12
    P = psi + h * w
    tol = {"float32": 1e-5, "bfloat16": 3e-2}[dtype]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    model = Attention(C, H, qk_norm=True, dtype=tdt)
    init_params(model, torch.Generator().manual_seed(0))
    sd = perturbed_state_dict(model, 7)
    load_numpy(model, sd)
    x = _tokens(B, S, P, C, 8)
    protect = np.broadcast_to(tm.protected_tokens(S, P, psi), (B, S * P)).copy()
    plan = tm.compute_merge_plan(torch.from_numpy(x), r, torch.from_numpy(protect))
    jplan = jtm.MergePlan(*(jnp.asarray(t.numpy()) for t in plan))

    pos = rope.make_patch_positions(h, w, B * S, psi)
    tables = rope.compute_rope_2d(pos, C // H).map(lambda t: t.reshape(B, S * P, -1))
    jtables = jax.tree.map(lambda t: t.reshape(B, S * P, t.shape[-1]),
                           jrope(jpositions(h, w, B * S, psi), C // H))
    jmodel = JAttention(C, H, qk_norm=True, dtype=jdt,
                        attn_fn=jtm.make_merged_attention(jplan))
    ref = jit(lambda p, t: jmodel.apply(p, t, jtables))(
        to_flax(sd), jnp.asarray(x, jdt)).astype(jnp.float32)
    xt = torch.from_numpy(x).to(tdt)
    with torch.inference_mode():
        out = model(xt, tables, attn_fn=tm.make_merged_attention(plan)).float()
        control = model(xt, tables, attn_fn=_merge_then_prep(plan, tables)).float()
    err = rel_err(ref, out.numpy())
    assert err < tol, err
    if dtype == "float32":
        assert rel_err(ref, control.numpy()) > tol


def test_one_view_merge_is_a_no_op():
    """S = 1 protects every token: the aggregator's output with
    global_merge_r > 0 equals the exact one bit for bit."""
    cfg = ModelConfig().scaled(embed_dim=32, depth=1, num_heads=2, img_size=28,
                               patch_embed="conv").aggregator
    agg = Aggregator(cfg)
    init_params(agg, torch.Generator().manual_seed(0))
    img = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 1, 28, 28, 3))
                           .astype(np.float32))
    with torch.inference_mode():
        a, _ = agg(img, global_merge_r=50)
        b, _ = agg(img)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _recording_plans(monkeypatch, module):
    """Record every (tokens, r, protect) that ``module`` hands to
    `compute_merge_plan`."""
    calls = []

    def record(x, r, protect):
        calls.append((x.numpy().copy(), r, protect.numpy().copy()))
        return tm.compute_merge_plan(x, r, protect)

    monkeypatch.setattr(module, "compute_merge_plan", record)
    return calls


def test_aggregator_merge_matches_jax(monkeypatch):
    """The fp32 aggregator at 3 views of 4x5 patches merged at r = 13 (one
    plan per forward, on the trunk's input tokens, used by both global
    blocks): every token map within 1e-5 relative of JAX's."""
    from iggt_official_tpu_torch.models import aggregator as agg_module

    plans = _recording_plans(monkeypatch, agg_module)
    kw = dict(embed_dim=32, depth=2, num_heads=2, img_size=56, patch_embed="conv")
    cfg = dataclasses.replace(ModelConfig().scaled(**kw), trunk_dtype="float32")
    jcfg = dataclasses.replace(JModelConfig().scaled(**kw), trunk_dtype="float32")
    agg = Aggregator(cfg.aggregator.with_vit())
    init_params(agg, torch.Generator().manual_seed(1))
    sd = perturbed_state_dict(agg, 9)
    load_numpy(agg, sd)
    img = np.random.default_rng(5).uniform(0, 1, (1, 3, 56, 70, 3)).astype(np.float32)
    from iggt_official_tpu.ops.flash_attention import attention as jattention
    jagg = JAggregator(jcfg.aggregator.with_vit(), dtype=jnp.float32, attn_fn=jattention,
                       global_merge_r=13)
    ref, _ = jit(lambda p, x: jagg.apply(p, x))(to_flax(sd), jnp.asarray(img))
    with torch.inference_mode():
        out, _ = agg(torch.from_numpy(img), global_merge_r=13)
    (x, r, protect), = plans
    assert r == 13 and x.shape == (1, 75, 32)
    assert min(_decision_gaps(x, protect, r)) > GAP
    for a, b in zip(ref, out):
        assert rel_err(a, b.numpy()) < 1e-5
