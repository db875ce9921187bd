"""Each ported module against its JAX counterpart on the CPU, in float32,
on shared seeded weights carried by ``state_dict_from_jax``: layers,
position encodings, resizes, ResNet-50, RoBERTa, the deformable
transformer, the cross-modal FPN decoder and the dynamic mask head.

Tolerances: 1e-5 (rtol and atol) for shallow blocks, where the two
frameworks differ only in summation order; for the deep stacks
(ResNet-50, the transformer, the FPN) 1e-4 relative to each output's
largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tce_rvos_tpu.models import backbone_resnet as jax_resnet
from tce_rvos_tpu.models import dynamic_head as jax_dh
from tce_rvos_tpu.models import layers as jax_layers
from tce_rvos_tpu.models import position_encoding as jax_pe
from tce_rvos_tpu.models.segmentation import CrossModalFPNDecoder as JaxFPN
from tce_rvos_tpu.models.text_encoder import RobertaModel as JaxRoberta
from tce_rvos_tpu.models.transformer import DeformableTransformer as JaxTransformer
from tce_rvos_tpu.utils import interpolate as jax_interp
from tce_rvos_tpu_torch.models import dynamic_head, layers, position_encoding
from tce_rvos_tpu_torch.models.backbone_resnet import ResNet
from tce_rvos_tpu_torch.models.segmentation import CrossModalFPNDecoder
from tce_rvos_tpu_torch.models.text_encoder import RobertaModel
from tce_rvos_tpu_torch.models.transformer import DeformableTransformer
from tce_rvos_tpu_torch.utils import interpolate
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import assert_close, prefixed, random_variables, sub_state_dict

SHALLOW = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.RandomState(seed)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _load(module, flat, jax_prefix, torch_prefix):
    sd = sub_state_dict(state_dict_from_jax(prefixed(flat, jax_prefix)), torch_prefix)
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _assert_scaled(got, want, rel, name=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    assert_close(got, want, rtol=rel, atol=rel * scale, name=name)


# ---- layers ----------------------------------------------------------------

def test_group_norm():
    x = _rng(0).randn(2, 6, 5, 32).astype(np.float32) * 3 + 1
    mod = jax_layers.GroupNorm(num_groups=8)
    variables, flat = random_variables(mod.init, jnp.asarray(x))
    want = mod.apply(variables, jnp.asarray(x))
    port = layers.GroupNorm(8, 32)
    port.load_state_dict({"weight": _t(flat["params/scale"]), "bias": _t(flat["params/bias"])})
    assert_close(port(_nchw(x)).permute(0, 2, 3, 1), want, **SHALLOW)


def test_mlp():
    x = _rng(1).randn(3, 4, 16).astype(np.float32)
    mod = jax_layers.MLP(hidden_dim=16, output_dim=7, num_layers=3)
    variables, flat = random_variables(mod.init, jnp.asarray(x))
    port = _load(layers.MLP(16, 16, 7, 3), flat, "controller", "controller")
    assert_close(port(_t(x)), mod.apply(variables, jnp.asarray(x)), **SHALLOW)


def test_feature_resizer():
    x = _rng(2).randn(2, 5, 24).astype(np.float32)
    mod = jax_layers.FeatureResizer(output_dim=16)
    variables, flat = random_variables(mod.init, jnp.asarray(x))
    port = _load(layers.FeatureResizer(24, 16), flat, "resizer", "resizer")
    assert_close(port(_t(x)), mod.apply(variables, jnp.asarray(x)), **SHALLOW)


def test_multihead_attention_with_padding():
    """Key padding, including a query batch whose keys are all padding
    (the most negative finite logit keeps that row finite)."""
    rng = _rng(3)
    q, k, v = (rng.randn(3, n, 32).astype(np.float32) for n in (5, 7, 7))
    kpm = np.zeros((3, 7), bool)
    kpm[0, 5:] = True
    kpm[2, :] = True
    mod = jax_layers.MultiheadAttention(d_model=32, num_heads=4)
    args = [jnp.asarray(a) for a in (q, k, v)]
    variables, flat = random_variables(mod.init, *args, key_padding_mask=jnp.asarray(kpm))
    want = mod.apply(variables, *args, key_padding_mask=jnp.asarray(kpm))
    port = _load(layers.MultiheadAttention(32, 4), flat, "fusion_module/multihead_attn",
                 "fusion_module.multihead_attn")
    got = port(_t(q), _t(k), _t(v), key_padding_mask=_t(kpm))
    assert torch.isfinite(got).all()
    assert_close(got, want, **SHALLOW)


def test_ffn():
    x = _rng(4).randn(2, 9, 32).astype(np.float32)
    mod = jax_layers.FFN(d_ffn=48, d_model=32)
    variables, flat = random_variables(mod.init, jnp.asarray(x))
    sd = sub_state_dict(state_dict_from_jax(
        prefixed(flat, "transformer/encoder_layers_0/ffn")), "transformer.encoder.layers.0")
    lin1, lin2, norm = torch.nn.Linear(32, 48), torch.nn.Linear(48, 32), layers.layer_norm(32)
    for name, m in (("linear1", lin1), ("linear2", lin2), ("norm2", norm)):
        m.load_state_dict(sub_state_dict(sd, name))
    drop = torch.nn.Dropout(0.1).eval()  # deterministic, as the JAX apply
    assert_close(layers.ffn(_t(x), lin1, lin2, norm, drop), mod.apply(variables, jnp.asarray(x)),
                 **SHALLOW)


# ---- position encodings and resizes ------------------------------------------

def test_sine_position_encodings():
    mask2d = np.zeros((2, 6, 9), bool)
    mask2d[1, 4:, :] = True
    mask2d[1, :, 7:] = True
    assert_close(position_encoding.sine_pos_2d(_t(mask2d), 16),
                 jax_pe.sine_pos_2d(jnp.asarray(mask2d), 16), **SHALLOW)
    mask1d = np.zeros((2, 8), bool)
    mask1d[0, 5:] = True
    assert_close(position_encoding.sine_pos_1d(_t(mask1d), 32),
                 jax_pe.sine_pos_1d(jnp.asarray(mask1d), 32), **SHALLOW)


@pytest.mark.parametrize("size", [(12, 18), (3, 4), (7, 5)], ids=["up", "down", "ragged"])
def test_resizes(size):
    x = _rng(5).randn(2, 6, 9, 3).astype(np.float32)
    xt = _nchw(x)
    assert_close(interpolate.resize_nearest(xt, size).permute(0, 2, 3, 1),
                 jax_interp.resize_nearest(jnp.asarray(x), size), rtol=0, atol=0)
    for ac in (False, True):
        assert_close(interpolate.resize_bilinear(xt, size, align_corners=ac).permute(0, 2, 3, 1),
                     jax_interp.resize_bilinear(jnp.asarray(x), size, align_corners=ac),
                     **SHALLOW)
    m = x[..., 0] > 0.3
    np.testing.assert_array_equal(interpolate.resize_mask_nearest(_t(m), size).numpy(),
                                  np.asarray(jax_interp.resize_mask_nearest(jnp.asarray(m), size)))


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_aligned_bilinear(factor):
    x = _rng(6).randn(2, 5, 7, 1).astype(np.float32)
    assert_close(interpolate.aligned_bilinear(_t(x[..., 0]), factor),
                 jax_interp.aligned_bilinear(jnp.asarray(x), factor)[..., 0], **SHALLOW)


# ---- backbone and text encoder -----------------------------------------------

def test_resnet50():
    x = _rng(7).randn(2, 64, 96, 3).astype(np.float32)
    mod = jax_resnet.ResNet(layers=(3, 4, 6, 3))
    variables, flat = random_variables(mod.init, jnp.asarray(x))
    want = jax.jit(mod.apply)(variables, jnp.asarray(x))
    port = _load(ResNet(), flat, "backbone", "backbone.0.body")
    with torch.inference_mode():
        got = port(_nchw(x))
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_scaled(g.permute(0, 2, 3, 1), w, 1e-4, f"res{i + 2}")


def test_roberta():
    rng = _rng(8)
    ids = rng.randint(3, 120, (2, 8)).astype(np.int32)
    attn = np.ones((2, 8), np.int32)
    attn[1, 5:] = 0
    ids[1, 5:] = 1
    kw = dict(vocab_size=120, hidden=32, layers=2, heads=4, intermediate=64, max_positions=40)
    mod = JaxRoberta(**kw)
    variables, flat = random_variables(mod.init, jnp.asarray(ids), jnp.asarray(attn))
    want = mod.apply(variables, jnp.asarray(ids), jnp.asarray(attn))
    port = _load(RobertaModel(**kw), flat, "text_encoder", "text_encoder")
    got = port(_t(ids).long(), _t(attn).long())
    for g, w, name in zip(got, want, ("hidden", "pooled")):
        assert_close(g, w, rtol=1e-5, atol=2e-5, name=name)


# ---- transformer, FPN, dynamic head ------------------------------------------

TRANSFORMER_VARIANTS = {
    "flagship": dict(q_trans=True, f_token=2, with_box_refine=True),
    "plain": dict(q_trans=False, f_token=0, with_box_refine=False),
}


@pytest.mark.parametrize("variant", sorted(TRANSFORMER_VARIANTS))
def test_deformable_transformer(variant):
    """The flagship's FTF (2 tokens), IQT and box refinement, and the plain
    ReferFormer transformer without them; two clips of 3 frames with
    padding in the second, 4 levels."""
    switches = TRANSFORMER_VARIANTS[variant]
    rng = _rng(9)
    b, t, q, c = 2, 3, 5, 64
    n = b * t
    shapes = ((8, 12), (4, 6), (2, 3), (1, 2))
    srcs = [rng.randn(n, h, w, c).astype(np.float32) for h, w in shapes]
    masks = []
    for h, w in shapes:
        m = np.zeros((n, h, w), bool)
        m[t:, h - max(h // 4, 0):, :] = h >= 4
        masks.append(m)
    pos = [rng.randn(n, h, w, c).astype(np.float32) for h, w in shapes]
    tgt = rng.randn(b, t, q, c).astype(np.float32)
    query_embed = rng.randn(q, c).astype(np.float32)
    mod = JaxTransformer(d_model=c, nhead=2, num_encoder_layers=2, num_decoder_layers=2,
                         dim_feedforward=64, **switches)
    jargs = ([jnp.asarray(s) for s in srcs], jnp.asarray(tgt), [jnp.asarray(m) for m in masks],
             [jnp.asarray(p) for p in pos], jnp.asarray(query_embed))
    variables, flat = random_variables(mod.init, *jargs)
    want = jax.jit(mod.apply)(variables, *jargs)

    sd = state_dict_from_jax(prefixed(flat, "transformer"))
    port = DeformableTransformer(d_model=c, nhead=2, num_encoder_layers=2, num_decoder_layers=2,
                                 dim_feedforward=64, **switches)
    port.load_state_dict(sub_state_dict(sd, "transformer"), strict=True)
    port.eval()  # dropout off, as the JAX apply's deterministic default
    bbox = None
    if switches["with_box_refine"]:
        bbox = torch.nn.ModuleList(layers.MLP(c, c, 4, 3) for _ in range(2))
        bbox.load_state_dict(sub_state_dict(sd, "bbox_embed"), strict=True)
    with torch.inference_mode():
        got = port([_nchw(s) for s in srcs], _t(tgt), [_t(m) for m in masks],
                   [_t(p) for p in pos], _t(query_embed), bbox_embed=bbox)
    keys = ["hs", "memory", "init_reference", "inter_references", "inter_samples"]
    if switches["with_box_refine"]:
        keys.append("coords")
    else:
        assert got["coords"] is None and want["coords"] is None
    for k in keys:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _assert_scaled(got[k], want[k], 1e-4, k)
    for i, (g, w) in enumerate(zip(got["memory_features"], want["memory_features"])):
        _assert_scaled(g.permute(0, 2, 3, 1), w, 1e-4, f"memory_features[{i}]")


def test_cross_modal_fpn_decoder():
    rng = _rng(10)
    b, t, c, s_txt = 2, 2, 64, 6
    n = b * t
    sizes = ((32, 48), (16, 24), (8, 12), (4, 6))
    res2 = rng.randn(n, 32, 48, 24).astype(np.float32)
    masks = [np.zeros((n, h, w), bool) for h, w in sizes]
    for m in masks:
        m[t:, :, -1:] = True
    poses = [rng.randn(n, h, w, c).astype(np.float32) for h, w in sizes]
    memory = [rng.randn(n, h, w, c).astype(np.float32) for h, w in sizes[1:]]
    text = rng.randn(b, s_txt, c).astype(np.float32)
    text_mask = np.zeros((b, s_txt), bool)
    text_mask[1, 4:] = True
    text_pos = rng.randn(b, s_txt, c).astype(np.float32)
    mod = JaxFPN(conv_dim=c, mask_dim=16, dim_feedforward=64)
    feats = [(jnp.asarray(res2), jnp.asarray(masks[0]))] + [
        (jnp.zeros((n,) + hw + (8,)), jnp.asarray(m)) for hw, m in zip(sizes[1:], masks[1:])]
    jargs = (feats, jnp.asarray(text), jnp.asarray(text_mask), jnp.asarray(text_pos),
             [jnp.asarray(p) for p in poses], [jnp.asarray(m) for m in memory], t)
    variables, flat = random_variables(lambda k, *a: mod.init(k, *a, t), *jargs[:-1])
    want = jax.jit(lambda v, *a: mod.apply(v, *a, t))(variables, *jargs[:-1])
    port = _load(CrossModalFPNDecoder(c, 16, 64, res2_channels=24), flat,
                 "pixel_decoder", "pixel_decoder")
    pfeats = [(_nchw(res2), _t(masks[0]))] + [(None, _t(m)) for m in masks[1:]]
    with torch.inference_mode():
        got = port(pfeats, _t(text), _t(text_mask), _t(text_pos), [_t(p) for p in poses],
                   [_nchw(m) for m in memory], t)
    _assert_scaled(got.permute(0, 2, 3, 1), want, 1e-4)


@pytest.mark.parametrize("out_stride", [4, 2])
def test_dynamic_mask_head(out_stride):
    rng = _rng(11)
    b, t, q, c, h, w, ch, nl = 2, 3, 5, 16, 6, 10, 8, 3
    wn, bn = jax_dh.dynamic_head_param_counts(c, ch, nl, True)
    assert (wn, bn) == dynamic_head.dynamic_head_param_counts(c, ch, nl)
    feats = rng.randn(b, t, h, w, c).astype(np.float32)
    params = (rng.randn(b, t, q, sum(wn) + sum(bn)) * 0.3).astype(np.float32)
    refs = rng.rand(b, t, q, 2).astype(np.float32)
    sizes = np.asarray([[24, 40], [20, 36]], np.int32)
    kw = dict(channels=ch, num_layers=nl, mask_out_stride=out_stride)
    want = jax_dh.dynamic_mask_with_coords(jnp.asarray(feats), jnp.asarray(params),
                                           jnp.asarray(refs), jnp.asarray(sizes),
                                           rel_coord=True, **kw)
    got = dynamic_head.dynamic_mask_with_coords(
        _t(feats).permute(0, 1, 4, 2, 3), _t(params), _t(refs), _t(sizes), **kw)
    _assert_scaled(got, want, 1e-5)
