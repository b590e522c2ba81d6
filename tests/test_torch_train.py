"""The port's training path against the JAX package's, on the CPU.

- the kernel wrappers refuse autograd; `Attention`'s unfused branch equals
  JAX's with `sdpa_xla` (fp32 1e-6 relative, bf16 2^-6 max|ref|);
  rematerialized and plain blocks give byte-equal gradients;
- the losses, value and gradient, 1e-5 relative (the part loss's blockwise
  form against the JAX function's dense one, with its push term over
  several row blocks and ids of -1);
- the schedule, the layer-decay scales and the decay mask, and three AdamW
  updates against optax (1e-6 relative);
- one training step of a scaled IGGT, fp32 and bf16 trunks, against JAX's
  `make_train_step(model)` (mesh None, remat on): loss terms, grad_norm and
  every parameter's gradient.  fp32: max |err| <= 1e-4 x max(max|g|,
  1e-5 G) per tensor, G the largest |g| over all tensors (the floor covers
  the part head's key biases, whose gradient is zero in exact arithmetic and
  rounding noise of ~1e-11 in both); readings ~6e-6.  bf16: loss terms and
  grad_norm 5e-3 relative (readings ~2e-3), the gradient 0.05 in global
  relative L2 (reading ~0.021), max |err| <= max(max|g|, 1e-3 G) per
  tensor (readings up to ~0.55 of it: the frameworks round the bf16 trunk at
  different points, ~1e-2 of the tokens, which moves the heads' ReLU
  patterns) and, for each tensor whose max|g| is above 1e-5 G (432 of
  them), a relative L2 error of at most 0.25 (readings up to 0.111, the
  trunk's qkv weights 0.013-0.019: a zeroed or halved tensor fails);
- `attention_train`, the step's route for the part head's cross-attention
  (the flash kernel's forward, the plain version's backward), refuses
  nothing under grad and gives the plain version's value and gradient;
- the loop and the CLI (the JAX smoke scenarios through the port), the
  checkpoint, resume, and the file loading into `IGGTProcessor`;
- the port's modules import no jax, JAX package, cv2, sklearn, yaml or orbax.

The JAX step's gradients are read from a transformation that stores them in
its state, so one compile of `make_train_step` gives metrics and gradients.
"""

import argparse
import concurrent.futures
import copy
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iggt_official_tpu.config import ModelConfig as JModelConfig
from iggt_official_tpu.layers import blocks as jblocks
from iggt_official_tpu.layers import rope as jrope
from iggt_official_tpu.models.vggt import IGGT as JIGGT
from iggt_official_tpu.train import losses as jlosses
from iggt_official_tpu.train import step as jstep
from iggt_official_tpu_torch.config import ModelConfig
from iggt_official_tpu_torch.layers import blocks as tblocks
from iggt_official_tpu_torch.layers import rope as trope
from iggt_official_tpu_torch.models.vggt import build_model
from iggt_official_tpu_torch.ops import flash_attention as tfa
from iggt_official_tpu_torch.ops.fused_ln import fused_layernorm
from iggt_official_tpu_torch.train import losses as tlosses
from iggt_official_tpu_torch.train import step as tstep
from iggt_official_tpu_torch.train.loop import train

from .test_torch_data import write_scannet
from .test_torch_helpers import jit, load_numpy, perturbed_state_dict, rel_err, to_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALED = dict(embed_dim=64, depth=2, num_heads=2, vit_depth=1, img_size=56)
B, S, H, W = 1, 2, 42, 56
BF16_TENSOR_REL_L2 = 0.25    # readings up to 0.111; a zeroed tensor reads 1, a halved one 0.5
CHEAP = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _configs(trunk="float32", patch_embed="conv"):
    """The scaled IGGT of both packages, its camera head cut to one trunk block
    and two iterations (the JAX step's compile time grows with the graph)."""
    def cut(cfg):
        cfg = cfg.scaled(**SCALED, patch_embed=patch_embed)
        return dataclasses.replace(cfg, trunk_dtype=trunk, camera=dataclasses.replace(
            cfg.camera, trunk_depth=1, num_iterations=2))
    return cut(ModelConfig()), cut(JModelConfig())


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.uniform(0, 1, (B, S, H, W, 3)).astype(np.float32),
            "pose_enc": rng.normal(0, 1, (B, S, 9)).astype(np.float32),
            "depth": rng.uniform(0.5, 2, (B, S, H, W, 1)).astype(np.float32),
            "world_points": rng.normal(0, 1, (B, S, H, W, 3)).astype(np.float32),
            "valid_mask": (rng.random((B, S, H, W)) < 0.8).astype(np.float32),
            "instance_ids": rng.integers(-1, 4, (B, S, H, W)).astype(np.int32)}


def _grab_grads():
    """A transformation whose state is the last gradient and whose update is
    zero: the JAX step's new opt_state is its gradient tree."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _flax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_grads_as_flax(model, sd):
    grads = {n: p.grad.detach().numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
             for n, p in model.named_parameters()}
    return _flax_leaves(to_flax({k: grads.get(k, np.zeros_like(v)) for k, v in sd.items()})
                        ["params"])


@pytest.fixture(scope="module")
def step_runs():
    """Per trunk dtype: the JAX step (lowered, compiled and run for both
    dtypes in two threads while this one runs the port) and the port's step
    on the same weights and batch; for fp32 also the port's gradients
    without remat."""
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    cfgs = {trunk: _configs(trunk) for trunk in ("float32", "bfloat16")}
    model = build_model(cfgs["float32"][0], device="cpu", seed=0, train=True)
    sd = perturbed_state_dict(model, 100)   # the same for both trunks: the init is seeded
    load_numpy(model, sd)

    def run_jax(trunk):
        state = jstep.TrainState.create(to_flax(sd)["params"], _grab_grads())
        step = jstep.make_train_step(JIGGT(cfgs[trunk][1])).lower(state, jbatch).compile(CHEAP)
        new_state, jmetrics = step(state, jbatch)
        return ({k: float(v) for k, v in jmetrics.items()},
                _flax_leaves(jax.device_get(new_state.opt_state)))

    runs, flash = {}, tfa.flash_attention
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {trunk: pool.submit(run_jax, trunk) for trunk in cfgs}
        for trunk in cfgs:
            if trunk == "bfloat16":
                model = load_numpy(build_model(cfgs[trunk][0], device="cpu", train=True), sd)
            runs[trunk] = {}
            if trunk == "float32":
                plain = copy.deepcopy(model)
                preds = plain(tbatch["images"], attn_fn=tblocks.sdpa_plain,
                              part_attn_fn=tfa.attention_train, remat=False)
                tlosses.total_loss(preds, tbatch)[0].backward()
                runs[trunk]["no_remat"] = {n: p.grad for n, p in plain.named_parameters()}
                del plain, preds
            opt = tstep.make_optimizer(model, layer_decay=0.9, num_layers=SCALED["depth"])
            calls = []

            def counting(q, k, v, key_bias=None, calls=calls):
                calls.append(tuple(q.shape))
                return flash(q, k, v, key_bias)

            tfa.flash_attention = counting
            try:
                loss, metrics = tstep.make_train_step(model, opt)(tbatch)
            finally:
                tfa.flash_attention = flash
            runs[trunk].update(
                flash_calls=calls,
                metrics={k: float(v) for k, v in metrics.items()}, loss=float(loss),
                grads=_port_grads_as_flax(model, sd),
                remat={n: p.grad for n, p in model.named_parameters()})
        for trunk, fut in futures.items():
            runs[trunk]["jmetrics"], runs[trunk]["jgrads"] = fut.result()
    return runs


@pytest.mark.parametrize("trunk", ["float32", "bfloat16"])
def test_train_step_matches_jax(step_runs, trunk):
    run = step_runs[trunk]
    jm, m = run["jmetrics"], run["metrics"]
    assert sorted(jm) == sorted(m) == sorted(
        ["loss/camera", "loss/depth", "loss/point", "loss/part", "loss/total", "grad_norm"])
    assert m["loss/total"] == run["loss"]
    for k in jm:
        tol = 5e-3 if trunk == "bfloat16" else 1e-4 if k == "grad_norm" else 1e-5
        assert abs(m[k] - jm[k]) <= tol * abs(jm[k]), (k, m[k], jm[k])
    jg, g = run["jgrads"], run["grads"]
    assert sorted(jg) == sorted(g)
    G = max(np.abs(a).max() for a in jg.values())
    tol, floor = (1e-4, 1e-5) if trunk == "float32" else (1.0, 1e-3)
    worst = 0.0
    for path, ref in jg.items():
        m_ref = float(np.abs(ref).max())
        limit = max(m_ref, floor * G)
        err = float(np.abs(g[path] - ref).max())
        worst = max(worst, err / limit)
        assert err <= tol * limit, (path, err, m_ref)
        if m_ref > floor * G:
            assert np.abs(g[path]).max() > 0, f"{path}: the JAX gradient is nonzero, ours is 0"
    if trunk == "bfloat16":
        ref = np.concatenate([a.ravel() for a in jg.values()]).astype(np.float64)
        out = np.concatenate([g[k].ravel() for k in jg]).astype(np.float64)
        assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 0.05
        # each tensor's relative L2 error, where max|g| is above 1e-5 G
        rl2 = {path: float(np.linalg.norm(g[path].astype(np.float64) - ref)
                           / np.linalg.norm(ref.astype(np.float64)))
               for path, ref in jg.items() if np.abs(ref).max() > 1e-5 * G}
        top = sorted(rl2.items(), key=lambda kv: -kv[1])[:5]
        print(f"bf16 per-tensor relative L2: {len(rl2)} tensors, worst {top}")
        assert all(v <= BF16_TENSOR_REL_L2 for v in rl2.values()), top
    print(f"{trunk}: worst per-tensor error {worst:.3g} of its limit's scale")


def test_trunk_qkv_weights_get_gradients(step_runs):
    """The kernel route would cut q/k/v out of autograd; the training route
    must not: every qkv weight of the frame and global blocks has a nonzero
    gradient."""
    g = step_runs["float32"]["grads"]
    qkv = [k for k in g if k.startswith("['aggregator']") and "['attn']['qkv']['kernel']" in k]
    assert len(qkv) == 2 * SCALED["depth"]
    assert all(np.abs(g[k]).max() > 0 for k in qkv)


def test_remat_gives_byte_equal_gradients(step_runs):
    """The training step's gradients (frame and global blocks recomputed in
    the backward pass) against a plain forward and backward: byte-equal."""
    remat, plain = step_runs["float32"]["remat"], step_runs["float32"]["no_remat"]
    assert sorted(remat) == sorted(plain)
    for n in remat:
        assert (remat[n] is None) == (plain[n] is None), n
        if remat[n] is not None:
            assert torch.equal(remat[n], plain[n]), n


def test_attention_route_is_chosen_per_call():
    """``attn_fn`` given to the forward reaches the DINOv2 blocks, the frame
    and global blocks and the part head's cross-attention (the camera head
    keeps its own); without it the kernel dispatcher runs and, under grad,
    refuses."""
    tcfg, _ = _configs("float32", patch_embed="dinov2_vitl14_reg")
    model = build_model(tcfg, device="cpu", seed=0, train=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    calls = []

    def counting(q, k, v):
        calls.append(tuple(q.shape))
        return tblocks.sdpa_plain(q, k, v)

    tlosses.total_loss(model(batch["images"], attn_fn=counting), batch)[0].backward()
    assert len(calls) == SCALED["vit_depth"] + 2 * SCALED["depth"] + 1
    grads = dict(model.named_parameters())
    for name in ("aggregator.patch_embed.blocks.0.attn.qkv.weight",
                 "aggregator.frame_blocks.0.attn.qkv.weight",
                 "aggregator.global_blocks.1.attn.qkv.weight",
                 "part_head.cross_attention_2.projq.weight"):
        assert grads[name].grad is not None and grads[name].grad.abs().max() > 0, name
    with pytest.raises(ValueError, match="requires grad"):
        model(batch["images"])


def test_attention_train_is_the_plain_version_under_autograd():
    """`attention_train` takes inputs that require grad (the wrappers refuse
    them) and gives `flash_attention_plain`'s value and gradient, on the CPU
    bit for bit; with no gradient wanted it still runs."""
    rng = np.random.default_rng(3)
    qkv = [torch.from_numpy(rng.standard_normal((2, 20, 8, 32)).astype(np.float32))
           for _ in range(3)]
    g = torch.from_numpy(rng.standard_normal((2, 20, 8, 32)).astype(np.float32))
    ours = [t.clone().requires_grad_(True) for t in qkv]
    ref = [t.clone().requires_grad_(True) for t in qkv]
    out = tfa.attention_train(*ours)
    want = tfa.flash_attention_plain(*ref)
    assert torch.equal(out, want)
    out.backward(g)
    want.backward(g)
    for a, b in zip(ours, ref):
        assert torch.equal(a.grad, b.grad)
    with torch.no_grad():
        assert torch.equal(tfa.attention_train(*qkv), want.detach())


def test_train_step_routes_the_part_head_through_attention_train(step_runs):
    """The step's part head calls the flash wrapper (through
    `attention_train`) once per forward, and nothing else does: the frame
    and global blocks train through `sdpa_plain`."""
    tcfg, _ = _configs("float32")
    p, part = tcfg.patch_size, tcfg.part
    for trunk in ("float32", "bfloat16"):
        assert step_runs[trunk]["flash_calls"] == [
            (B * S, (H // p) * (W // p), part.ca_num_heads, part.features // part.ca_num_heads)]
    g = step_runs["float32"]["grads"]
    assert np.abs(g["['part_head']['cross_attention_2']['projq']['kernel']"]).max() > 0


def _guard_calls():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 32)).astype(np.float32))
               for _ in range(3))
    cos = torch.ones(1, 8, 32)
    norm = tuple(torch.ones(32) for _ in range(4))
    x, w, b = torch.randn(4, 64), torch.ones(64), torch.zeros(64)
    return {
        "flash_attention": (lambda q, k, v, w, b: tfa.flash_attention(q, k, v), (q, k, v)),
        "flash_attention_fused": (lambda q, k, v, w, b: tfa.flash_attention_fused(
            q, k, v, cos, cos, norm), (q, k, v)),
        "qk_prep": (lambda q, k, w, b: tfa.qk_prep(q, k, cos, cos, norm)[0], (q, k)),
        "fused_layernorm": (lambda q, k, v, w, b: fused_layernorm(q, w, b), (x, w, b)),
    }


@pytest.mark.parametrize("wrapper", ["flash_attention", "flash_attention_fused", "qk_prep",
                                     "fused_layernorm"])
def test_kernel_wrappers_refuse_autograd(wrapper):
    fn, args = _guard_calls()[wrapper]
    for i in range(len(args)):
        leaf = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
        if wrapper == "fused_layernorm":
            call = lambda: fn(leaf[0], None, None, leaf[1], leaf[2])  # noqa: E731
        else:
            call = lambda: fn(*leaf, None, None)  # noqa: E731
        with pytest.raises(ValueError, match=f"{wrapper}: an input requires grad.*sdpa_plain"):
            call()
        with torch.no_grad():
            assert call().requires_grad is False
        with torch.inference_mode():
            call()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_unfused_branch_matches_jax(dtype):
    """`Attention` with qk-norm and RoPE through `sdpa_plain`: JAX's unfused
    branch with `sdpa_xla` (the prep rounded twice, not once)."""
    Bt, grid, psi, C, Hh = 2, 4, 5, 128, 2
    N = psi + grid * grid
    x = np.random.default_rng(5).standard_normal((Bt, N, C)).astype(np.float32)
    attn = tblocks.Attention(C, Hh, qk_norm=True, dtype=getattr(torch, dtype),
                             attn_fn=tblocks.sdpa_plain)
    sd = perturbed_state_dict(attn, 6)
    load_numpy(attn, sd)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    jattn = jblocks.Attention(C, Hh, qk_norm=True, dtype=getattr(jnp, dtype),
                              attn_fn=jblocks.sdpa_xla)
    rope_j = jrope.compute_rope_2d(jrope.make_patch_positions(grid, grid, Bt, psi), C // Hh)
    ref = np.asarray(jit(jattn.apply)(to_flax(sd), jnp.asarray(xt.float().numpy()).astype(
        getattr(jnp, dtype)), rope_j).astype(jnp.float32))
    rope_t = trope.compute_rope_2d(trope.make_patch_positions(grid, grid, Bt, psi), C // Hh)
    with torch.no_grad():
        out = attn(xt, rope_t).float().numpy()
    if dtype == "float32":
        assert rel_err(ref, out) < 1e-6
    else:
        assert np.abs(ref - out).max() <= 2.0 ** -6 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# losses

def _loss_inputs(seed=0, Bl=2, Sl=2, Hl=24, Wl=32, C=8):
    rng = np.random.default_rng(seed)
    return dict(
        pose_list=[rng.normal(0, 1, (Bl, Sl, 9)).astype(np.float32) for _ in range(3)],
        gt_pose=rng.normal(0, 1.5, (Bl, Sl, 9)).astype(np.float32),
        pred=rng.normal(0, 1, (Bl, Sl, Hl, Wl, 3)).astype(np.float32),
        conf=rng.uniform(1.0, 3.0, (Bl, Sl, Hl, Wl)).astype(np.float32),
        gt=rng.normal(0, 1, (Bl, Sl, Hl, Wl, 3)).astype(np.float32),
        valid=(rng.random((Bl, Sl, Hl, Wl)) < 0.7).astype(np.float32),
        feat=rng.normal(0, 1, (Bl, Sl, Hl, Wl, C)).astype(np.float32),
        ids=rng.integers(-1, 5, (Bl, Sl, Hl, Wl)).astype(np.int32))


def _check(jfn, tfn, args, argnums):
    """Value and gradient (w.r.t. ``argnums``) of a JAX loss and the port's."""
    jval, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=argnums))(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else [jnp.asarray(x) for x in a]
          for a in args])
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else [torch.from_numpy(x) for x in a]
             for a in args]
    leaves = []
    for i in argnums:
        for t in (targs[i] if isinstance(targs[i], list) else [targs[i]]):
            t.requires_grad_(True)
            leaves.append(t)
    val = tfn(*targs)
    tgrads = torch.autograd.grad(val, leaves)
    assert abs(float(val) - float(jval)) <= 1e-5 * abs(float(jval))
    for jg, tg in zip(jax.tree_util.tree_leaves(jgrads), tgrads):
        assert rel_err(np.asarray(jg), tg.numpy()) < 1e-5


def test_camera_and_conf_losses_match_jax():
    a = _loss_inputs()
    _check(jlosses.camera_loss, tlosses.camera_loss, (a["pose_list"], a["gt_pose"]), (0,))
    _check(jlosses.conf_regression_loss, tlosses.conf_regression_loss,
           (a["pred"], a["conf"], a["gt"], a["valid"]), (0, 1))
    x = np.linspace(-3, 3, 61).astype(np.float32)
    _check(lambda v: jlosses.smooth_l1(v).sum(), lambda v: tlosses.smooth_l1(v).sum(), (x,), (0,))


@pytest.mark.parametrize("block_rows", [tlosses.PART_BLOCK_ROWS, 37])
def test_part_loss_matches_the_dense_form(block_rows):
    """n = 2 x 6 x 8 = 96 valid-or-not pixels per batch entry: 37-row blocks
    split the push term over three blocks."""
    a = _loss_inputs(1)
    a["ids"][0, 0, :8] = -1
    _check(jlosses.part_embedding_loss,
           lambda f, i: tlosses.part_embedding_loss(f, i, block_rows=block_rows),
           (a["feat"], a["ids"]), (0,))


def test_total_loss_matches_jax():
    a = _loss_inputs(2)
    preds_keys = dict(depth=a["pred"][..., :1], depth_conf=a["conf"],
                      world_points=a["pred"], world_points_conf=a["conf"] + 0.5,
                      part_feat=a["feat"])
    batch = dict(pose_enc=a["gt_pose"], depth=a["gt"][..., :1], world_points=a["gt"],
                 valid_mask=a["valid"], instance_ids=a["ids"], images=a["pred"])
    names = sorted(preds_keys)

    def jfn(pose_list, *vals):
        preds = dict(zip(names, vals), pose_enc_list=pose_list)
        return jlosses.total_loss(preds, {k: jnp.asarray(v) for k, v in batch.items()})[0]

    def tfn(pose_list, *vals):
        preds = dict(zip(names, vals), pose_enc_list=pose_list)
        return tlosses.total_loss(preds, {k: torch.from_numpy(v) for k, v in batch.items()})[0]

    _check(jfn, tfn, [a["pose_list"]] + [preds_keys[n] for n in names],
           tuple(range(len(names) + 1)))


# ---------------------------------------------------------------------------
# schedule, layer decay, optimizer

def test_schedule_matches_optax():
    for base, warm, total in [(1e-4, 1000, 100_000), (1e-4, 2, 10), (3e-3, 1, 4)]:
        ref = jstep.make_schedule(base, warm, total)
        out = tstep.make_schedule(base, warm, total)
        for s in range(0, total + 3) if total < 1000 else list(range(0, 1200)) + [
                50_000, 99_999, 100_000, 100_002]:
            assert abs(out(s) - float(ref(s))) <= 1e-6 * float(ref(s)), (base, warm, total, s)


def _flax_path_of_each_name(sd):
    """port state-dict name -> JAX param path, by carrying each entry's index
    through the JAX converter."""
    marked = {k: np.full(v.shape, i, np.float64) for i, (k, v) in enumerate(sd.items())}
    names = list(sd)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(to_flax(marked)["params"])[0]:
        out[names[int(np.asarray(leaf).flat[0])]] = path
    return out


def test_layer_decay_and_decay_mask_match_jax():
    tcfg, _ = _configs("float32", patch_embed="dinov2_vitl14_reg")
    model = build_model(tcfg, device="meta")
    sd = {k: np.zeros(v.shape, np.float32) for k, v in model.state_dict().items()}
    paths = _flax_path_of_each_name(sd)
    params = to_flax(sd)["params"]
    depth = SCALED["depth"]
    jscales = _flax_leaves(jstep.layer_decay_scales(params, 0.9, depth))
    jmask = {jax.tree_util.keystr(p): not jstep._no_decay(p, leaf)
             for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    named = list(model.named_parameters())
    assert len(named) == len(jscales)
    seen = set()
    for name, p in named:
        key = jax.tree_util.keystr(paths[name])
        seen.add(key)
        assert tstep.layer_decay_scale(name, 0.9, depth) == pytest.approx(
            float(jscales[key]), rel=1e-6), name
        assert (not tstep.no_decay(name, p)) == jmask[key], name
    assert seen == set(jscales)
    ids = {tstep.layer_id(n, depth) for n, _ in named}
    assert ids == set(range(depth + 1))   # embeddings 0, blocks 1..depth, the rest depth
    assert tstep.layer_id("aggregator.patch_embed.blocks.0.attn.qkv.weight", depth) == 1
    assert tstep.layer_id("part_head.window_self_atten.patch_embed.norm.weight", depth) == depth


def test_optimizer_matches_optax():
    """Three updates on seeded gradients (global norms 0.5, 3 and 0.8: the
    second is clipped) with layer decay and the decay mask, over the
    parameters of every rule (the trunk with its DINOv2 blocks, the camera
    head, the part head's cross-attentions and window patch norms, the
    projector's BatchNorm statistics), held in float64 on the port's side so
    that its updates read exactly.  cross_attention_1 gets no gradient
    (None), so weight decay alone moves it, as optax moves it on zeros."""
    tcfg, _ = _configs("float32", patch_embed="dinov2_vitl14_reg")
    model = build_model(tcfg, device="meta")
    names = [n for n, _ in model.named_parameters()
             if n.startswith(("aggregator.", "camera_head.")) or "cross_attention" in n
             or "patch_embed.norm" in n or "running_" in n]
    rng = np.random.default_rng(3)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    sd = {n: (0.05 * rng.standard_normal(shapes[n])).astype(np.float32) for n in names}
    params = {n: torch.nn.Parameter(torch.from_numpy(sd[n]).double()) for n in names}
    kw = dict(base_lr=1e-2, weight_decay=0.05, layer_decay=0.9, num_layers=SCALED["depth"],
              warmup_steps=1, total_steps=5, grad_clip=1.0)
    opt = tstep.AdamWLayerDecay(params.items(), **kw)
    jparams = to_flax(sd)["params"]
    tx = jstep.make_optimizer(jparams, **kw)

    def jax_update(grads, state, p):
        updates, state = tx.update(grads, state, p)
        return updates, state, optax.apply_updates(p, updates)

    update = jit(jax_update)
    jstate = tx.init(jparams)
    for norm in (0.5, 3.0, 0.8):
        g = {n: rng.standard_normal(sd[n].shape).astype(np.float32) for n in names}
        for n in names:
            if "cross_attention_1" in n:
                g[n][...] = 0
        total = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))
        g = {n: (v * (norm / total)).astype(np.float32) for n, v in g.items()}
        before = {n: p.detach().clone() for n, p in params.items()}
        for n, p in params.items():
            p.grad = None if "cross_attention_1" in n else torch.from_numpy(g[n]).double()
        gnorm = float(opt.step())
        assert abs(gnorm - norm) <= 1e-6 * norm
        updates, jstate, jparams = update(to_flax(g)["params"], jstate, jparams)
        delta = {n: (params[n].detach() - before[n]).numpy() for n in names}
        got = _flax_leaves(to_flax(delta)["params"])
        want = _flax_leaves(updates)
        worst = 0.0
        for k, ref in want.items():
            scale = np.abs(ref).max()
            if scale == 0:   # no gradient and no decay: cross_attention_1's biases
                assert "cross_attention_1" in k and not got[k].any(), k
                continue
            worst = max(worst, np.abs(got[k] - ref).max() / scale)
        assert worst < 1e-6, worst
    assert opt.count == 3
    assert len({tstep.layer_decay_scale(n, 0.9, SCALED["depth"]) for n in names}) == 3


# ---------------------------------------------------------------------------
# loop, CLI, checkpoint

def _vggt_config():
    cfg = ModelConfig().scaled(embed_dim=32, depth=2, num_heads=2, img_size=28,
                               patch_embed="conv")
    return dataclasses.replace(cfg, enable_part=False, name="vggt")


@pytest.fixture(scope="module")
def loop_run(tmp_path_factory):
    """3 steps of `train` with a checkpoint at 2 and at the end, the second
    step under the profiler (``profile_step``); the run's state, logs,
    checkpoint directory and batch stream."""
    rng = np.random.default_rng(0)

    def batches():
        while True:
            yield {"images": rng.uniform(0, 1, (1, 2, 28, 28, 3)).astype(np.float32),
                   "pose_enc": rng.normal(0, 1, (1, 2, 9)).astype(np.float32),
                   "depth": rng.uniform(0.5, 2, (1, 2, 28, 28, 1)).astype(np.float32),
                   "world_points": rng.normal(0, 1, (1, 2, 28, 28, 3)).astype(np.float32),
                   "valid_mask": np.ones((1, 2, 28, 28), np.float32)}

    logs = []
    ckpt = str(tmp_path_factory.mktemp("loop") / "ckpt")
    stream = batches()
    state = train(_vggt_config(), stream, num_steps=3, device="cpu", checkpoint_dir=ckpt,
                  checkpoint_every=2, warmup_steps=1, log_every=1, print_fn=logs.append,
                  profile_step=1)
    return state, logs, ckpt, stream


def test_train_loop_smoke_and_resume(loop_run):
    """JAX `test_train_loop_smoke` through the port: 3 steps with a checkpoint
    at 2 and at the end, then a resume to 4 that continues the count."""
    state, logs, ckpt, batches = loop_run
    assert state.step == 3
    assert any("loss/total" in line for line in logs)
    assert sorted(os.listdir(ckpt)) == ["step_00000002.pt", "step_00000003.pt"]
    from iggt_official_tpu_torch.utils.checkpoint import load_training_checkpoint

    saved = load_training_checkpoint(os.path.join(ckpt, "step_00000003.pt"))
    assert saved["step"] == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved["model"][k], v), k
    opt_state = state.optimizer.state_dict()
    assert saved["optimizer"]["count"] == opt_state["count"] == 3
    for k in opt_state["mu"]:
        assert torch.equal(saved["optimizer"]["mu"][k], opt_state["mu"][k])
        assert torch.equal(saved["optimizer"]["nu"][k], opt_state["nu"][k])

    state2 = train(copy.deepcopy(state.model), batches, num_steps=4, checkpoint_dir=ckpt,
                   checkpoint_every=10, warmup_steps=1, log_every=10, print_fn=logs.append)
    assert state2.step == 4
    assert any("resumed" in line and "step 3" in line for line in logs)
    assert [h["step"] for h in state2.history] == [3]
    assert state2.history[0]["lr"] == tstep.make_schedule(1e-4, 1, 4)(3)
    assert state2.optimizer.count == 4
    assert "step_00000004.pt" in os.listdir(ckpt)


def test_profiled_step_lists_each_step_span_once(loop_run):
    """``profile_step``'s `key_averages` hold the step's four spans
    (`train/step.py`) and the model's forward span, once each."""
    counts = {e.key: e.count for e in loop_run[0].profile}
    for name in (tstep.FORWARD_SPAN, tstep.LOSS_SPAN, tstep.BACKWARD_SPAN,
                 tstep.OPTIMIZER_SPAN, "model.forward"):
        assert counts.get(name) == 1, (name, counts.get(name))


def test_train_cli_smoke_and_processor_load(tmp_path):
    """JAX `test_train_cli_smoke` through the port (`--device cpu`, the
    Scannet dir written with PIL); the checkpoint it writes loads into
    `IGGTProcessor` with nothing missing, unused or mismatched, and gives the
    trained weights."""
    from iggt_official_tpu_torch.app.demo import IGGTProcessor
    from iggt_official_tpu_torch.app.train import build_config, main

    root = write_scannet(str(tmp_path / "scannet"), W=28, H=28)
    expr = f"Scannet({root!r}, resolution=(28, 28), seed=7)"
    common = ["--dataset", expr, "--batch_size", "2", "--seq_min_len", "2",
              "--seq_max_len", "2", "--model", "vggt", "--embed_dim", "32", "--depth", "2",
              "--num_heads", "2", "--img_size", "28", "--patch_embed", "conv",
              "--warmup_steps", "1", "--n_data", "1", "--log_every", "1", "--device", "cpu"]
    ckpt = tmp_path / "ckpt"
    state = main(common + ["--steps", "2", "--checkpoint_dir", str(ckpt),
                           "--checkpoint_every", "2"])
    assert os.listdir(ckpt) == ["step_00000002.pt"]

    cfg = build_config(argparse.Namespace(embed_dim=32, depth=2, num_heads=2, img_size=28,
                                          patch_embed="conv", model="vggt"))
    proc = IGGTProcessor(model_path=str(ckpt / "step_00000002.pt"), model_cfg=cfg, device="cpu")
    report = proc.load_report
    assert report["missing"] == report["unused"] == report["shape_mismatch"] == []
    for k, v in state.model.state_dict().items():
        assert torch.equal(proc.model.state_dict()[k], v), k

    # mesh flags that need more processes than this one: a clear error, not a run
    with pytest.raises(SystemExit, match="needs 2 processes.*torchrun"):
        main(common + ["--steps", "1", "--n_seq", "2"])
    with pytest.raises(SystemExit, match="needs 2 processes.*torchrun"):
        main(common + ["--steps", "1", "--n_model", "2", "--fsdp"])


def test_port_modules_import_no_banned_package():
    """Every module of the port imported in a fresh interpreter (no conftest):
    none of jax, the JAX package, cv2, sklearn, yaml or orbax gets imported."""
    code = r"""
import importlib, pkgutil, sys
import iggt_official_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
banned = ("jax", "jaxlib", "flax", "iggt_official_tpu", "cv2", "sklearn", "yaml", "orbax")
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(len(names), bad)
sys.exit(1 if bad or len(names) < 60 else 0)
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
