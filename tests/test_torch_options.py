"""The model options of the port, each at module level against its JAX
function on the CPU, in float32, on shared seeded weights carried by
``state_dict_from_jax``:

* ``LastLayerAsToken`` (``--f_token -1``) alone and inside the deformable
  transformer; the FPN without V-L blocks (``--vlblock``); the dynamic
  mask head without relative coordinates (``--no_rel_coord``);
* the matcher and the criterion at 65 and 78 classes, with the visibility
  cost and loss, and without the mask costs and losses;
* the class count of every dataset with and without ``--binary``;
* the command line: the six option flags give the JAX package's configs
  and criterion configs, ``--two_stage`` and ``--position_embedding
  learned`` still raise naming the flag; without ``--masks`` the objective
  is the JAX package's (no mask losses, the same matched query);
* class heads across class counts: a binary fine-tune from a 65-class
  checkpoint re-initialises only ``class_embed.*``;
* ``MultiheadAttention`` in chunks of queries and the FFN in chunks of
  rows (whole-video windows) give the unchunked outputs.

Tolerances: 1e-5 (rtol and atol) for shallow blocks, where the two
frameworks differ only in summation order; 1e-4 relative to each output's
largest magnitude for the deep stacks (the transformer, the FPN); the
losses at rtol 1e-5 and atol 1e-6, the matched queries exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tce_rvos_tpu import cli as jax_cli
from tce_rvos_tpu.config import ModelConfig as JaxModelConfig
from tce_rvos_tpu.config import _num_classes_for
from tce_rvos_tpu.models import criterion as jax_criterion
from tce_rvos_tpu.models import dynamic_head as jax_dh
from tce_rvos_tpu.models import matcher as jax_matcher
from tce_rvos_tpu.models.segmentation import CrossModalFPNDecoder as JaxFPN
from tce_rvos_tpu.models.transformer import DeformableTransformer as JaxTransformer
from tce_rvos_tpu.models.transformer import LastLayerAsToken as JaxLastLayerAsToken
from tce_rvos_tpu_torch import cli
from tce_rvos_tpu_torch.config import ModelConfig
from tce_rvos_tpu_torch.models import dynamic_head, layers
from tce_rvos_tpu_torch.models.build import build_model
from tce_rvos_tpu_torch.models.criterion import CriterionConfig, criterion, criterion_from_configs
from tce_rvos_tpu_torch.models.matcher import MatcherConfig, match
from tce_rvos_tpu_torch.models.segmentation import CrossModalFPNDecoder
from tce_rvos_tpu_torch.models.transformer import DeformableTransformer, LastLayerAsToken
from tce_rvos_tpu_torch.utils.checkpoint import convert_state_dict, drop_class_heads
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_modules import _assert_scaled, _load, _nchw, _t
from test_torch_train import _jax_criterion, _jax_match, _outputs_and_targets, _to
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import (
    OPTIONS_A,
    TINY,
    assert_close,
    prefixed,
    random_variables,
    sub_state_dict,
)

SHALLOW = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)

# ---- LastLayerAsToken (--f_token -1) -------------------------------------------------

def test_last_layer_as_token_matches_jax():
    """Two clips of 3 frames (the tokens of one clip never see the other's),
    4 levels, the coarsest 2x3 = 6 tokens a frame."""
    rng = np.random.RandomState(20)
    b, t, c = 2, 3, 32
    shapes = ((8, 12), (4, 6), (2, 3))
    s = sum(h * w for h, w in shapes)
    last_start = s - 2 * 3
    src = rng.randn(b * t, s, c).astype(np.float32)
    pos = rng.randn(b * t, s, c).astype(np.float32)
    mod = JaxLastLayerAsToken(d_model=c, d_ffn=48, n_heads=4, clip_frames=t)
    variables, flat = random_variables(lambda k, x, p: mod.init(k, x, p, last_start),
                                       jnp.asarray(src), jnp.asarray(pos))
    want = jax.jit(lambda v, x, p: mod.apply(v, x, p, last_start))(
        variables, jnp.asarray(src), jnp.asarray(pos))
    port = _load(LastLayerAsToken(c, 48, n_heads=4), flat,
                 "transformer/encoder_layers_0/inter_frame_atten",
                 "transformer.encoder.layers.0.inter_frame_atten")
    assert not any(k.startswith("norm1") for k in port.state_dict())
    with torch.inference_mode():
        got = port(_t(src), _t(pos), last_start, t)
    assert torch.equal(got[:, :last_start], _t(src[:, :last_start]))  # the finer levels pass
    assert_close(got, want, **SHALLOW)
    # scoped to the clip: clip 1's tokens do not move clip 0's
    src2 = src.copy()
    src2[t:, last_start:] += 1.0
    with torch.inference_mode():
        assert torch.equal(port(_t(src2), _t(pos), last_start, t)[:t], got[:t])


def test_transformer_with_last_layer_as_token_matches_jax():
    rng = np.random.RandomState(21)
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
    kw = dict(d_model=c, nhead=2, num_encoder_layers=2, num_decoder_layers=2,
              dim_feedforward=64, q_trans=True, f_token=-1)
    mod = JaxTransformer(**kw)
    jargs = ([jnp.asarray(x) for x in srcs], jnp.asarray(tgt), [jnp.asarray(m) for m in masks],
             [jnp.asarray(p) for p in pos], jnp.asarray(query_embed))
    variables, flat = random_variables(mod.init, *jargs)
    want = jax.jit(mod.apply)(variables, *jargs)
    port = DeformableTransformer(**kw)
    port.load_state_dict(sub_state_dict(state_dict_from_jax(prefixed(flat, "transformer")),
                                         "transformer"), strict=True)
    assert sum(".inter_frame_atten." in k for k in port.state_dict()) == 2 * 10
    with torch.inference_mode():
        got = port.eval()([_nchw(x) for x in srcs], _t(tgt), [_t(m) for m in masks],
                          [_t(p) for p in pos], _t(query_embed))
    for k in ("hs", "memory", "init_reference", "inter_references", "inter_samples"):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _assert_scaled(got[k], want[k], 1e-4, k)


# ---- the FPN without V-L blocks, the mask head without relative coordinates ---------

def test_fpn_without_vl_blocks_matches_jax():
    rng = np.random.RandomState(22)
    b, t, c, s_txt = 2, 2, 64, 6
    n = b * t
    sizes = ((32, 48), (16, 24), (8, 12), (4, 6))
    res2 = rng.randn(n, 32, 48, 24).astype(np.float32)
    masks = [np.zeros((n, h, w), bool) for h, w in sizes]
    poses = [rng.randn(n, h, w, c).astype(np.float32) for h, w in sizes]
    memory = [rng.randn(n, h, w, c).astype(np.float32) for h, w in sizes[1:]]
    text = rng.randn(b, s_txt, c).astype(np.float32)
    text_mask = np.zeros((b, s_txt), bool)
    text_pos = rng.randn(b, s_txt, c).astype(np.float32)
    mod = JaxFPN(conv_dim=c, mask_dim=16, dim_feedforward=64, vlblock=False)
    feats = [(jnp.asarray(res2), jnp.asarray(masks[0]))] + [
        (jnp.zeros((n,) + hw + (8,)), jnp.asarray(m)) for hw, m in zip(sizes[1:], masks[1:])]
    jargs = (feats, jnp.asarray(text), jnp.asarray(text_mask), jnp.asarray(text_pos),
             [jnp.asarray(p) for p in poses], [jnp.asarray(m) for m in memory])
    variables, flat = random_variables(lambda k, *a: mod.init(k, *a, t), *jargs)
    want = jax.jit(lambda v, *a: mod.apply(v, *a, t))(variables, *jargs)
    port = _load(CrossModalFPNDecoder(c, 16, 64, res2_channels=24, vlblock=False), flat,
                 "pixel_decoder", "pixel_decoder")  # strict: no cross_attn_* module
    assert not any(k.startswith("cross_attn") for k in port.state_dict())
    pfeats = [(_nchw(res2), _t(masks[0]))] + [(None, _t(m)) for m in masks[1:]]
    with torch.inference_mode():
        got = port(pfeats, _t(text), _t(text_mask), _t(text_pos), [_t(p) for p in poses],
                   [_nchw(m) for m in memory], t)
    _assert_scaled(got.permute(0, 2, 3, 1), want, 1e-4)


@pytest.mark.parametrize("rel_coord", [False, True])
def test_dynamic_mask_head_rel_coord_matches_jax(rel_coord):
    rng = np.random.RandomState(23)
    b, t, q, c, h, w, ch, nl = 2, 3, 5, 16, 6, 10, 8, 3
    wn, bn = jax_dh.dynamic_head_param_counts(c, ch, nl, rel_coord)
    assert (wn, bn) == dynamic_head.dynamic_head_param_counts(c, ch, nl, rel_coord)
    assert wn[0] == (c + 2 * rel_coord) * ch
    feats = rng.randn(b, t, h, w, c).astype(np.float32)
    params = (rng.randn(b, t, q, sum(wn) + sum(bn)) * 0.3).astype(np.float32)
    refs = rng.rand(b, t, q, 2).astype(np.float32)
    sizes = np.asarray([[24, 40], [20, 36]], np.int32)
    kw = dict(channels=ch, num_layers=nl, rel_coord=rel_coord)
    want = jax_dh.dynamic_mask_with_coords(jnp.asarray(feats), jnp.asarray(params),
                                           jnp.asarray(refs), jnp.asarray(sizes), **kw)
    got = dynamic_head.dynamic_mask_with_coords(
        _t(feats).permute(0, 1, 4, 2, 3), _t(params), _t(refs), _t(sizes), **kw)
    _assert_scaled(got, want, 1e-5)


# ---- the matcher and the criterion at K classes, with and without masks -------------

# (classes, visibility, masks)
LOSS_CASES = {"ytvos65_vis": (65, True, True), "ytvos65_nomasks": (65, False, False),
              "ytvos65_vis_nomasks": (65, True, False), "davis78": (78, False, True),
              "binary_nomasks": (1, False, False)}


def _matches_and_losses(num_classes, vis, masks, seed):
    """(JAX matched queries, port's; JAX losses, port's) of every layer."""
    kw = dict(num_classes=num_classes, use_vis=vis, use_masks=masks)
    outputs, targets = _outputs_and_targets(num_classes, seed, vis)
    want_q, got_q = [], []
    for layer in [outputs] + outputs["aux_outputs"]:
        args = [layer["pred_logits"], layer["pred_boxes"], layer["pred_masks"],
                targets["labels"], targets["boxes"], targets["masks"], targets["valid"],
                layer.get("pred_visible")]
        want_q.append(np.asarray(_jax_match(
            jax_matcher.MatcherConfig(**kw), *(None if a is None else jnp.asarray(a)
                                               for a in args))))
        got_q.append(match(MatcherConfig(**kw), *(None if a is None else _t(a)
                                                  for a in args)).numpy())
    jax_cfg = jax_criterion.CriterionConfig(**kw, matcher=jax_matcher.MatcherConfig(**kw))
    want = _jax_criterion(jax_cfg, _to(outputs, jnp.asarray), _to(targets, jnp.asarray))
    got = criterion(CriterionConfig(**kw, matcher=MatcherConfig(**kw)),
                    _to(outputs, _t), _to(targets, _t))
    return want_q, got_q, want, got


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_match_and_criterion_match_jax(case):
    num_classes, vis, masks = LOSS_CASES[case]
    for seed in range(3):
        want_q, got_q, want, got = _matches_and_losses(num_classes, vis, masks, seed)
        for w, g in zip(want_q, got_q):
            np.testing.assert_array_equal(g, w)
        assert sorted(got) == sorted(want)
        assert ("loss_vis_1" in got) == vis and ("loss_dice_1" in got) == masks
        for k in want:
            assert_close(got[k], want[k], name=k, **LOSS_TOL)


DATASETS = ("ytvos", "davis", "a2d", "jhmdb", "coco", "refcoco", "refcoco+", "refcocog",
            "mevis", "joint")


@pytest.mark.parametrize("binary", [False, True], ids=["classes", "binary"])
def test_num_classes_table_matches_jax(binary):
    for ds in DATASETS:
        want = _num_classes_for(ds, binary)
        assert ModelConfig(dataset_file=ds, binary=binary).num_classes == want, ds
        assert JaxModelConfig(dataset_file=ds, binary=binary).num_classes == want, ds


@pytest.mark.parametrize("dataset_file,num_classes", [("ytvos", 65), ("davis", 78),
                                                      ("jhmdb", 1), ("refcoco", 91)])
def test_build_model_has_the_dataset_class_heads(dataset_file, num_classes):
    cfg = ModelConfig(**{**TINY, "binary": False}, dataset_file=dataset_file,
                      with_box_refine=True, vis_loss=True)
    model = build_model(cfg, device="cpu")
    assert [h.out_features for h in model.class_embed] == [num_classes] * cfg.dec_layers
    prior = -np.log((1 - 0.01) / 0.01)
    for heads in (model.class_embed, model.visible_embed):
        for head in heads:
            assert torch.allclose(head.bias, torch.full_like(head.bias, prior))
    assert [h.out_features for h in model.visible_embed] == [1] * cfg.dec_layers


# ---- the command line --------------------------------------------------------------

OPTION_ARGV = {
    "no_binary_ytvos": [], "no_binary_davis": ["--dataset_file", "davis"],
    "no_binary_jhmdb": ["--dataset_file", "jhmdb"],
    "f_token_-1": ["--binary", "--f_token", "-1"], "vis_loss": ["--binary", "--vis_loss"],
    "contrastive": ["--binary", "--contrastive"], "vlblock": ["--binary", "--vlblock"],
    "no_rel_coord": ["--binary", "--no_rel_coord"], "masks": ["--binary", "--masks"],
    "all": ["--f_token", "-1", "--vis_loss", "--contrastive", "--vlblock", "--no_rel_coord",
            "--masks", "--with_box_refine", "--qtrans"],
}


def _parsers(argv):
    return (cli.get_args_parser().parse_args(argv),
            jax_cli.get_args_parser().parse_args(argv + ["--msda_impl", "xla"]))


@pytest.mark.parametrize("which", sorted(OPTION_ARGV))
def test_option_flags_give_the_jax_configs(which):
    args, jax_args = _parsers(OPTION_ARGV[which])
    cfg = cli.model_config_from_args(args)
    jax_cfg = jax_cli.model_config_from_args(jax_args)
    for k, v in dataclasses.asdict(cfg).items():
        assert v == getattr(jax_cfg, k), k
    assert cfg.num_classes == jax_cfg.num_classes
    tcfg = cli.train_config_from_args(args)
    want = jax_criterion.criterion_from_configs(jax_cfg, jax_cli.train_config_from_args(jax_args))
    assert criterion_from_configs(cfg, tcfg) == CriterionConfig(
        **{f.name: getattr(want, f.name) for f in dataclasses.fields(want) if f.name != "matcher"},
        matcher=MatcherConfig(**vars(want.matcher)))


@pytest.mark.parametrize("flag,argv", [("--two_stage", ["--two_stage"]),
                                       ("--position_embedding",
                                        ["--position_embedding", "learned"])])
def test_refused_flags_raise_naming_the_flag(flag, argv):
    with pytest.raises(ValueError, match=f"^{flag}: not supported by the PyTorch port"):
        cli.model_config_from_args(cli.get_args_parser().parse_args(["--binary", *argv]))


def test_without_masks_the_objective_is_the_jax_one():
    """The repaired fault: the training flags without ``--masks`` (phase 9's
    on the card before the repair) train the JAX package's objective: no
    mask focal/dice losses, no mask costs in the matcher, so the same
    matched query and the same losses."""
    argv = ["--binary", "--with_box_refine", "--f_token", "8", "--qtrans"]
    args, jax_args = _parsers(argv)
    cfg, jax_cfg = cli.model_config_from_args(args), jax_cli.model_config_from_args(jax_args)
    assert not cfg.masks and not jax_cfg.masks
    crit = criterion_from_configs(cfg, cli.train_config_from_args(args))
    jax_crit = jax_criterion.criterion_from_configs(jax_cfg,
                                                    jax_cli.train_config_from_args(jax_args))
    for seed in range(4):
        outputs, targets = _outputs_and_targets(1, seed, vis=False)
        got = criterion(crit, _to(outputs, _t), _to(targets, _t))
        want = _jax_criterion(jax_crit, _to(outputs, jnp.asarray), _to(targets, jnp.asarray))
        assert sorted(got) == sorted(want)
        assert not any(k.startswith(("loss_mask", "loss_dice")) for k in got)
        for k in want:
            assert_close(got[k], want[k], name=k, **LOSS_TOL)
        args_ = [outputs["pred_logits"], outputs["pred_boxes"], outputs["pred_masks"],
                 targets["labels"], targets["boxes"], targets["masks"], targets["valid"]]
        np.testing.assert_array_equal(
            match(crit.matcher, *(_t(a) for a in args_)).numpy(),
            np.asarray(_jax_match(jax_crit.matcher, *(jnp.asarray(a) for a in args_))))


# ---- class heads across class counts ---------------------------------------------------

def test_binary_fine_tune_from_a_65_class_checkpoint_reinitialises_only_class_heads():
    """The reference flow (train.py --binary --pretrained_weights): the 65
    class heads are dropped and re-initialised, everything else loads."""
    cfg65 = ModelConfig(**OPTIONS_A)
    sd65 = build_model(cfg65, device="cpu", seed=1).state_dict()
    reference = build_model(dataclasses.replace(cfg65, binary=True), device="cpu").state_dict()
    with pytest.raises(ValueError, match="shape mismatch class_embed.0.weight"):
        convert_state_dict(sd65, reference, verbose=False)
    out, missing, unexpected = convert_state_dict(drop_class_heads(sd65, cfg65.dec_layers),
                                                  reference, verbose=False)
    assert sorted(missing) == sorted(k for k in reference if k.startswith("class_embed."))
    assert len(missing) == 2 * cfg65.dec_layers and unexpected == []
    for k, v in out.items():
        assert torch.equal(v, reference[k] if k in missing else sd65[k]), k


# ---- attention in chunks ---------------------------------------------------------------

def test_multihead_attention_in_chunks_computes_the_same_function(monkeypatch):
    """Past ``ATTN_LOGITS_CHUNK`` logits the queries go in chunks (here 3
    rows, the last chunk ragged): the same outputs, padded keys included."""
    rng = np.random.RandomState(24)
    b, sq, sk, c, h = 2, 10, 7, 32, 4
    mha = layers.MultiheadAttention(c, h).eval()
    q, k, v = (_t(rng.randn(b, s, c).astype(np.float32)) for s in (sq, sk, sk))
    pad = torch.zeros(b, sk, dtype=torch.bool)
    pad[1, 5:] = True
    with torch.inference_mode():
        want = mha(q, k, v, pad)
        monkeypatch.setattr(layers, "ATTN_LOGITS_CHUNK", 3 * b * h * sk)
        got = mha(q, k, v, pad)
    assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_ffn_in_chunks_computes_the_same_function(monkeypatch):
    """Past ``FFN_HIDDEN_CHUNK`` hidden activations the FFN's rows go in
    chunks (here 4 rows, the last chunk ragged): the same outputs."""
    rng = np.random.RandomState(25)
    x = _t(rng.randn(2, 3, 5, 16).astype(np.float32))
    lin1, lin2 = torch.nn.Linear(16, 24), torch.nn.Linear(24, 16)
    norm, drop = layers.layer_norm(16), torch.nn.Dropout(0.1).eval()
    with torch.inference_mode():
        want = layers.ffn(x, lin1, lin2, norm, drop)
        monkeypatch.setattr(layers, "FFN_HIDDEN_CHUNK", 4 * 24)
        got = layers.ffn(x, lin1, lin2, norm, drop)
    assert got.shape == x.shape
    assert_close(got, want, rtol=1e-6, atol=1e-6)
