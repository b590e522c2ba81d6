"""The JAX package's last modules in the port, against the JAX package on
the CPU: `SwiGLUFFN` and `Block(ffn_layer="swiglu")` (`layers/blocks.py`),
`GeoProjector` (`heads/adaptor.py`), `RuntimeConfig.use_flash_attention`
through `IGGTProcessor`, the thin public API (`sam2/amg.py::area_from_rle`,
`ops/connected_components.py::get_connected_components`), the window
attention with its bias table (`heads/window_attn.py::WindowAttention`,
`rpi_window_sa`) and the native minimum spanning forest
(`native/__init__.py::mst_from_edges`).  Weights come from the port's seeded
init, perturbed with numpy, and cross to JAX through the JAX package's
converter; the port's `utils/convert.py` carries them back."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from iggt_official_tpu import native as jnative
from iggt_official_tpu.app import demo as jdemo
from iggt_official_tpu.config import ModelConfig as JModelConfig
from iggt_official_tpu.config import RuntimeConfig as JRuntimeConfig
from iggt_official_tpu.heads import adaptor as jadaptor
from iggt_official_tpu.heads import window_attn as jwin
from iggt_official_tpu.layers import blocks as jblocks
from iggt_official_tpu.layers import rope as jrope
from iggt_official_tpu.ops import connected_components as jcc
from iggt_official_tpu.parallel.mesh import tp_spec as jtp_spec
from iggt_official_tpu.sam2 import amg as jamg
from iggt_official_tpu.utils.torch_convert import iggt_rename, torch_state_dict_to_flax
from iggt_official_tpu_torch import native
from iggt_official_tpu_torch.app import demo
from iggt_official_tpu_torch.config import ModelConfig, RuntimeConfig
from iggt_official_tpu_torch.heads import adaptor
from iggt_official_tpu_torch.heads import window_attn as twin
from iggt_official_tpu_torch.layers import blocks as tblocks
from iggt_official_tpu_torch.layers import rope as trope
from iggt_official_tpu_torch.ops import connected_components as tcc
from iggt_official_tpu_torch.ops import flash_attention as tfa
from iggt_official_tpu_torch.parallel.mesh import param_specs
from iggt_official_tpu_torch.sam2 import amg as tamg
from iggt_official_tpu_torch.utils.convert import jax_params_to_torch_state_dict

from .test_torch_helpers import jit, load_numpy, perturbed_state_dict, rel_err, to_flax

jfa = importlib.import_module("iggt_official_tpu.ops.flash_attention")

C, HEADS, GRID, PSI = 48, 3, 4, 5
# fp32: summation order only; bf16: the trunk's limit (ROADMAP, "Every
# parity test agrees to rounding")
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 7e-3}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("dim,ratio", [(48, 4.0), (1024, 4.0), (64, 2.0), (100, 3.0)])
def test_swiglu_hidden_width_matches_jax(dim, ratio):
    """(int(h * 2 / 3) + 7) // 8 * 8 of h = dim * mlp_ratio: the port's w12 /
    w3 shapes are the JAX module's kernels, transposed."""
    shapes = jax.eval_shape(jblocks.SwiGLUFFN(int(dim * ratio)).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1, dim)))["params"]
    ffn = tblocks.SwiGLUFFN(dim, int(dim * ratio))
    assert tuple(ffn.w12.weight.shape) == shapes["w12"]["kernel"].shape[::-1]
    assert tuple(ffn.w3.weight.shape) == shapes["w3"]["kernel"].shape[::-1]
    if dim == 1024:
        assert ffn.w3.in_features == tblocks.swiglu_hidden(4096) == 2736


def _blocks(dtype, qk_rope):
    blk = tblocks.Block(C, HEADS, init_values=0.01, qk_norm=qk_rope, ffn_layer="swiglu",
                        dtype=getattr(torch, dtype), attn_fn=tfa.attention)
    jblk = jblocks.Block(C, HEADS, init_values=0.01, qk_norm=qk_rope, ffn_layer="swiglu",
                         dtype=getattr(jnp, dtype), attn_fn=jfa.attention)
    return blk, jblk


@pytest.mark.parametrize("qk_rope", [True, False], ids=["qk_norm_rope", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_block_matches_jax(dtype, qk_rope):
    """A frame block (qk-norm and 2D RoPE through the fused-prep protocol)
    and a DINOv2-style one (neither), with the SwiGLU FFN."""
    B = 2
    blk, jblk = _blocks(dtype, qk_rope)
    sd = load_numpy(blk, perturbed_state_dict(blk, 21)).state_dict()
    sd = {k: v.numpy() for k, v in sd.items()}
    x = np.random.default_rng(22).standard_normal((B, PSI + GRID * GRID, C)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    trope_t = jrope_t = None
    if qk_rope:
        trope_t = trope.compute_rope_2d(trope.make_patch_positions(GRID, GRID, B, PSI), C // HEADS)
        jrope_t = jrope.compute_rope_2d(jrope.make_patch_positions(GRID, GRID, B, PSI),
                                        C // HEADS)
    ref = jit(jblk.apply)(to_flax(sd), jnp.asarray(xt.float().numpy()).astype(
        getattr(jnp, dtype)), jrope_t)
    with torch.inference_mode():
        out = blk(xt, trope_t)
    assert out.dtype == xt.dtype
    assert rel_err(ref, out.float().numpy()) < BLOCK_TOL[dtype]


def test_swiglu_block_planted_fault_fails():
    """w12's two halves swapped: silu(x2) * x1 in place of silu(x1) * x2."""
    blk, jblk = _blocks("float32", True)
    sd = {k: v.numpy() for k, v in load_numpy(blk, perturbed_state_dict(blk, 21)).state_dict()
          .items()}
    x = np.random.default_rng(22).standard_normal((1, PSI + GRID * GRID, C)).astype(np.float32)
    rope = trope.compute_rope_2d(trope.make_patch_positions(GRID, GRID, 1, PSI), C // HEADS)
    jr = jrope.compute_rope_2d(jrope.make_patch_positions(GRID, GRID, 1, PSI), C // HEADS)
    ref = jit(jblk.apply)(to_flax(sd), jnp.asarray(x), jr)
    with torch.inference_mode():
        w, b = blk.mlp.w12.weight, blk.mlp.w12.bias
        h = w.shape[0] // 2
        w.copy_(torch.cat([w[h:], w[:h]]))
        b.copy_(torch.cat([b[h:], b[:h]]))
        out = blk(torch.from_numpy(x), rope)
    assert rel_err(ref, out.numpy()) > 1e-3


def test_unknown_ffn_layer_raises_in_both_packages():
    with pytest.raises(ValueError, match="unknown ffn_layer"):
        tblocks.Block(C, HEADS, ffn_layer="moe")
    with pytest.raises(ValueError, match="unknown ffn_layer"):
        jax.eval_shape(jblocks.Block(C, HEADS, ffn_layer="moe").init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 4, C)))


def test_swiglu_weights_round_trip_and_stay_replicated():
    """JAX params -> the port's converter -> a strict load -> the JAX
    package's converter gives the same arrays; tensor parallelism splits
    `attn.proj` and leaves `mlp.w12` / `mlp.w3` replicated in both packages."""
    jblk = jblocks.Block(C, HEADS, init_values=0.01, qk_norm=True, ffn_layer="swiglu")
    params = jit(jblk.init)(jax.random.PRNGKey(3), jnp.zeros((1, 4, C)))["params"]
    params = jax.tree.map(lambda a: a + jax.random.normal(jax.random.PRNGKey(4), a.shape),
                          params)
    sd = jax_params_to_torch_state_dict(params)
    blk = tblocks.Block(C, HEADS, init_values=0.01, qk_norm=True, ffn_layer="swiglu")
    blk.load_state_dict(sd, strict=True)
    assert {"mlp.w12.weight", "mlp.w12.bias", "mlp.w3.weight", "mlp.w3.bias"} <= set(sd)
    back = torch_state_dict_to_flax({k: v.numpy() for k, v in sd.items()}, rename=iggt_rename)
    want, got = dict(_flat(params)), dict(_flat(back))
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    specs = param_specs(blk, n_data=1, n_model=2)
    assert specs["attn.proj.weight"].tp_dim == 1
    for name in ("mlp.w12.weight", "mlp.w12.bias", "mlp.w3.weight", "mlp.w3.bias"):
        assert specs[name].tp_dim is None, name
        leaf = "kernel" if name.endswith("weight") else "bias"
        assert jtp_spec(("mlp", name.split(".")[1], leaf), want[("mlp", name.split(".")[1],
                                                                   leaf)].shape, 2) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_plain_is_sdpa_xla(dtype):
    """The route `use_flash_attention=False` takes: logits in the input dtype,
    softmax in fp32, probabilities cast back, on the same q / k / v as the
    JAX package's `sdpa_xla`: fp32 within 1e-6 of max|ref|, bf16 within one
    bf16 rounding of it (2^-8)."""
    rng = np.random.default_rng(81)
    q, k, v = (rng.standard_normal((2, 37, 3, 16)).astype(np.float32) * 2 for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    ref = jit(jblocks.sdpa_xla)(*(jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
                                  for t in (tq, tk, tv)))
    out = tblocks.sdpa_plain(tq, tk, tv)
    assert out.dtype == tq.dtype and tuple(out.shape) == (2, 37, 3, 16)
    assert rel_err(ref, out.float().numpy()) <= (1e-6 if dtype == "float32" else 2 ** -8)


GEO_LEVELS = (0, 1, 2, 3)
GEO_OUT = (16, 16, 16, 16)
GEO_HW = (56, 70)


def _geo():
    proj = adaptor.GeoProjector(64, intermediate_layer_idx=GEO_LEVELS, out_channels=GEO_OUT)
    sd = perturbed_state_dict(proj, 31)
    load_numpy(proj, sd)
    rng = np.random.default_rng(32)
    P = PSI + (GEO_HW[0] // 14) * (GEO_HW[1] // 14)
    toks = [rng.standard_normal((1, 2, P, 64)).astype(np.float32) for _ in GEO_LEVELS]
    jproj = jadaptor.GeoProjector(64, intermediate_layer_idx=GEO_LEVELS, out_channels=GEO_OUT)
    ref = jit(lambda p, t: jproj.apply(p, t, GEO_HW, PSI))(to_flax(sd),
                                                           [jnp.asarray(t) for t in toks])
    return proj, sd, [torch.from_numpy(t) for t in toks], ref


def test_geo_projector_matches_jax():
    """dim_in 64, four levels at 4x / 2x / 1x / 0.5x the 4 x 5 patch grid,
    fp32 within 1e-5 of max|ref|; NHWC in both packages.  A level-0
    ConvTranspose kernel left unflipped (the layout fault a converter can
    make) fails it."""
    proj, sd, toks, ref = _geo()
    with torch.inference_mode():
        out = proj(toks, GEO_HW, PSI)
        assert sorted(out) == sorted(ref) == ["res2", "res3", "res4", "res5"]
        for k in ref:
            assert tuple(out[k].shape) == ref[k].shape, k
            assert rel_err(ref[k], out[k].numpy()) < 1e-5, k
        assert tuple(out["res2"].shape) == (2, 16, 20, 16)
        assert tuple(out["res5"].shape) == (2, 2, 3, 16)
        w = proj.resize_layers[0].weight
        w.copy_(w.flip(2, 3))
        assert rel_err(ref["res2"], proj(toks, GEO_HW, PSI)["res2"].numpy()) > 1e-3


def test_geo_projector_weights_round_trip():
    """The ConvTranspose kernels (flax (kh, kw, I, O), spatially flipped) ->
    the port's (I, O, kh, kw) -> back through the JAX package's converter,
    equal; the names are the reference's (`projects.<i>`, `resize_layers.<i>`)."""
    _, sd, _, _ = _geo()
    flax = to_flax(sd)["params"]
    assert set(flax) == {"norm", "projects_0", "projects_1", "projects_2", "projects_3",
                         "resize_0", "resize_1", "resize_3"}
    back = jax_params_to_torch_state_dict(flax)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
    assert back["resize_layers.0.weight"].shape == (16, 16, 4, 4)
    np.testing.assert_array_equal(np.asarray(flax["resize_0"]["kernel"]),
                                  sd["resize_layers.0.weight"].transpose(2, 3, 0, 1)[::-1, ::-1])


PROC_SCALED = dict(embed_dim=64, depth=2, num_heads=2, img_size=56, patch_embed="conv")
PROC_HW = (56, 70)


def _proc_config(cls, part: bool):
    """A scaled fp32 IGGT with a conv patch embed and no depth head (neither
    attends), with or without the part head."""
    return dataclasses.replace(cls().scaled(**PROC_SCALED), trunk_dtype="float32",
                               enable_depth=False, enable_part=part)


def _counting(monkeypatch, name):
    """Replace `app/demo.py`'s ``name`` by a wrapper that records each call."""
    calls, fn = [], getattr(demo, name)

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return fn(*args, **kw)

    counted.supports_fused_qk_prep = getattr(fn, "supports_fused_qk_prep", False)
    monkeypatch.setattr(demo, name, counted)
    return calls


def test_processor_without_flash_attention_matches_jax(tmp_path, monkeypatch):
    """`RuntimeConfig(use_flash_attention=False)`: the port's processor against
    the JAX processor with the same flag (which applies the model without an
    ``attn_fn``, so every `Attention` runs `sdpa_xla`), same weights, same
    2-view scene: pose_enc and world points within 1e-5 of max|ref| in fp32.
    The four `Attention`s (two frame, two global blocks) call `sdpa_plain`;
    with the flag left on, none does.  (The part head is left out here: it
    attends through the same dispatcher with the flag or without it, next
    test.)"""
    runtime = dict(image_size=(PROC_HW[1], PROC_HW[0]), use_flash_attention=False)
    scene = chip_smoke.write_scene(str(tmp_path), 2, 6, size=(90, 60))
    proc = demo.IGGTProcessor(model_cfg=_proc_config(ModelConfig, False),
                              runtime=RuntimeConfig(**runtime), device="cpu")
    sd = perturbed_state_dict(proc.model, 41)
    load_numpy(proc.model, sd)
    plain_calls = _counting(monkeypatch, "sdpa_plain")
    out = proc._run_inference(scene)
    assert len(plain_calls) == 2 * proc.cfg.aggregator.depth == 4
    proc.runtime = RuntimeConfig(image_size=runtime["image_size"])
    proc._run_inference(scene)
    assert len(plain_calls) == 4

    # the JAX processor with this test's weights, compiled with the cheap
    # codegen of the other parity tests
    cheap_jit, jax_jit = jit, jax.jit
    monkeypatch.setattr(jdemo.IGGTProcessor, "_load_model", lambda self, path: to_flax(sd))
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: jax_jit(fn, **kw) if kw else cheap_jit(fn))
    jproc = jdemo.IGGTProcessor(model_cfg=_proc_config(JModelConfig, False),
                                runtime=JRuntimeConfig(**runtime))
    ref = jproc._run_inference(scene)
    np.testing.assert_array_equal(out["images"], ref["images"])
    assert sorted(out) == sorted(ref)
    for k in ("pose_enc", "world_points", "world_points_conf"):
        assert tuple(out[k].shape) == ref[k].shape, k
        assert rel_err(ref[k], out[k].numpy()) < 1e-5, k


def test_processor_without_flash_attention_keeps_the_part_heads_dispatcher(tmp_path,
                                                                           monkeypatch):
    """With the flag off the part head's cross-attention still takes the
    kernel dispatcher (`ops/flash_attention.py::attention`), as the JAX
    package's `CrossAttention` keeps its own: one call per view chunk, while
    the blocks take `sdpa_plain`; with the flag on, the model's own
    dispatcher serves both."""
    scene = chip_smoke.write_scene(str(tmp_path), 2, 7, size=(90, 60))
    proc = demo.IGGTProcessor(model_cfg=_proc_config(ModelConfig, True),
                              runtime=RuntimeConfig(image_size=(PROC_HW[1], PROC_HW[0]),
                                                    use_flash_attention=False),
                              device="cpu")
    plain_calls = _counting(monkeypatch, "sdpa_plain")
    dispatched = _counting(monkeypatch, "attention")
    out = proc._run_inference(scene)
    assert (len(plain_calls), len(dispatched)) == (4, 1)
    assert tuple(out["part_feat"].shape) == (1, 2, *PROC_HW, 8)
    proc.runtime = RuntimeConfig(image_size=(PROC_HW[1], PROC_HW[0]))
    proc._run_inference(scene)
    assert (len(plain_calls), len(dispatched)) == (4, 1)


def _masks(shape, seed):
    rng = np.random.default_rng(seed)
    m = rng.uniform(0, 1, shape) < 0.45
    m[..., ::7, :] = False          # many components, of many sizes
    return m


def test_get_connected_components_matches_jax():
    """(N, 1, H, W) in, (labels, counts) of the same shape out; (N, H, W)
    unsqueezed; exactly the JAX package's labels and areas."""
    for shape in ((3, 1, 24, 31), (2, 17, 9)):
        m = _masks(shape, 51)
        labels, counts = tcc.get_connected_components(torch.from_numpy(m))
        jl, jc = jcc.get_connected_components(jnp.asarray(m))
        assert tuple(labels.shape) == tuple(counts.shape) == shape
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
        assert counts.max() > 1 and (labels.numpy() > 0).sum() == m.sum()


def test_area_from_rle_matches_jax():
    """Foreground pixels of the RLEs of seeded masks (both packages' own
    encoders, which agree), exactly; a mask that opens with foreground too."""
    masks = list(_masks((4, 13, 11), 52))
    masks.append(np.ones((5, 6), bool))
    for m in masks:
        rle, jrle = tamg.mask_to_rle(m), jamg.mask_to_rle(m)
        assert rle == jrle
        assert tamg.area_from_rle(rle) == jamg.area_from_rle(jrle) == int(m.sum())


def test_window_attention_with_bias_table_matches_jax():
    """`WindowAttention` over 4 x 4 windows with its relative-position bias
    (index `rpi_window_sa`, equal to JAX's): fp32 within 1e-5 of max|ref|."""
    ws, dim, heads = 4, 32, 2
    rpi = twin.rpi_window_sa(ws)
    np.testing.assert_array_equal(rpi, jwin.rpi_window_sa(ws))
    attn = twin.WindowAttention(dim, ws, heads)
    sd = perturbed_state_dict(attn, 61)
    load_numpy(attn, sd)
    x = np.random.default_rng(62).standard_normal((3, ws * ws, dim)).astype(np.float32)
    jattn = jwin.WindowAttention(dim, ws, heads)
    ref = jit(jattn.apply)(to_flax(sd), jnp.asarray(x), jnp.asarray(rpi))
    with torch.inference_mode():
        out = attn(torch.from_numpy(x), rpi)
    assert rel_err(ref, out.numpy()) < 1e-5


def test_mst_from_edges_matches_jax():
    """The native minimum spanning forest of a seeded sparse graph with two
    components: the JAX package's edges, in its order."""
    rng = np.random.default_rng(71)
    n = 300
    src = rng.integers(0, n // 2, 1500)
    dst = rng.integers(0, n // 2, 1500)
    src = np.concatenate([src, src + n // 2])
    dst = np.concatenate([dst, dst + n // 2])
    w = rng.uniform(0, 1, src.shape[0])
    sel = src != dst
    got = native.mst_from_edges(src[sel], dst[sel], w[sel], n)
    want = jnative.mst_from_edges(src[sel], dst[sel], w[sel], n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert n - 2 - 10 <= len(got[0]) <= n - 2
