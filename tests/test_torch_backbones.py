"""The port's backbones against the JAX package's on the CPU, in float32,
on shared seeded weights carried by ``state_dict_from_jax``, and the weight
bridge of every family.

* Each backbone against its JAX module: Swin-T at 64x96 and at 58x90 (the
  patch embedding pads to 60x92, and the odd 15x23 and 7x11 grids pad in
  the patch merging); Video-Swin-T at T = 3 (the temporal window shrinks
  to 3, no temporal shift) and at T = 10 (8-frame windows, a shift of 4,
  T padded to 16, the 3D shift mask); X3D-XS and X3D-S (the channel
  rounding: X3D-XS is 24, 40, 72, 144); ResNet-101; ResNet-50 with DC5.
  Tolerance: rtol 1e-4 and atol 1e-4 of each feature map's largest
  magnitude.
* DC5 as the JAX package has it: every block of layer4 dilated, the first
  included (torchvision keeps the first at dilation 1).
* DropPath's keep-and-scale rule; recomputation (``use_checkpoint``) gives
  the plain backward's gradients with DropPath drawing.
* The weight bridge: every flax leaf of each family maps to the key
  ``flax_to_torch_key`` gives; the port's state_dict, as numpy, goes back
  through the JAX ``convert_state_dict`` strictly and exactly; a (C, 3, 2,
  4, 4) Kinetics-400 patch embedding loads as its temporal sum in both
  packages.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from tce_rvos_tpu.models import backbone_resnet as jax_resnet
from tce_rvos_tpu.models import swin as jax_swin
from tce_rvos_tpu.models import video_swin as jax_video_swin
from tce_rvos_tpu.models import x3d as jax_x3d
from tce_rvos_tpu.utils import checkpoint as jax_ckpt
from tce_rvos_tpu_torch.models import backbone_resnet, swin, video_swin, x3d
from tce_rvos_tpu_torch.utils import checkpoint
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax, torch_key
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import assert_close, prefixed, random_variables, sub_state_dict

BODY = "backbone.0.body"
REL = 1e-4


def _swin(name):
    return (lambda: jax_swin.SwinBackbone(spec=jax_swin.swin_spec(name)),
            lambda: swin.SwinBackbone(swin.swin_spec(name)))


def _video_swin(name):
    return (lambda: jax_video_swin.VideoSwinBackbone(spec=jax_video_swin.video_swin_spec(name)),
            lambda: video_swin.VideoSwinBackbone(video_swin.video_swin_spec(name)))


def _x3d(name):
    return (lambda: jax_x3d.X3DBackbone(spec=jax_x3d.x3d_spec(name)),
            lambda: x3d.X3DBackbone(x3d.x3d_spec(name)))


def _resnet(name, dilation):
    layers = jax_resnet.RESNET_SPECS[name]["layers"]
    return (lambda: jax_resnet.ResNet(layers=layers, dilation=dilation),
            lambda: backbone_resnet.ResNet(backbone_resnet.RESNET_SPECS[name]["layers"], dilation))


# name -> (JAX module, port module, input shape channel-last: frames
# [N, H, W, 3] or clips [b, T, H, W, 3])
CASES = {
    "swin_t_64x96": (*_swin("swin_t_p4w7"), (2, 64, 96, 3)),
    "swin_t_58x90": (*_swin("swin_t_p4w7"), (1, 58, 90, 3)),
    "video_swin_t_T3": (*_video_swin("video_swin_t_p4w7"), (1, 3, 64, 96, 3)),
    "video_swin_t_T10": (*_video_swin("video_swin_t_p4w7"), (1, 10, 64, 96, 3)),
    "x3d_xs": (*_x3d("x3d_xs"), (1, 4, 64, 96, 3)),
    "x3d_s": (*_x3d("x3d_s"), (2, 3, 64, 96, 3)),
    "resnet101": (*_resnet("resnet101", False), (2, 64, 96, 3)),
    "resnet50_dc5": (*_resnet("resnet50", True), (2, 64, 96, 3)),
}
FAMILIES = ("swin_t_64x96", "video_swin_t_T3", "x3d_xs", "resnet50_dc5")


@functools.lru_cache(maxsize=None)
def _variables(case):
    jax_mod, _, shape = CASES[case]
    mod = jax_mod()
    x = np.random.RandomState(sum(map(ord, case))).randn(*shape).astype(np.float32)
    variables, flat = random_variables(mod.init, jnp.asarray(x))
    return mod, variables, prefixed(flat, "backbone"), x


def _port(case, flat):
    module = CASES[case][1]()
    module.load_state_dict(sub_state_dict(state_dict_from_jax(flat), BODY), strict=True)
    return module.eval()


def _to_torch_input(x):
    """Channel-last frames or clips -> NCHW frames or [b, 3, T, H, W] clips."""
    t = torch.from_numpy(x)
    return t.permute(0, 3, 1, 2) if t.ndim == 4 else t.permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_backbone_matches_jax(case):
    mod, variables, flat, x = _variables(case)
    want = jax.jit(mod.apply)(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = _port(case, flat)(_to_torch_input(x))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert_close(g.permute(0, 2, 3, 1), w, rtol=REL, atol=REL * float(np.abs(w).max()),
                     name=f"{case} level {i}")


def test_dc5_dilates_every_block_of_layer4_as_the_jax_package_does():
    port = backbone_resnet.ResNet(backbone_resnet.RESNET_SPECS["resnet50"]["layers"], True)
    assert [(b.conv2.stride, b.conv2.dilation, b.conv2.padding) for b in port.layer4] == [
        ((1, 1), (2, 2), (2, 2))] * 3
    assert port.layer4[0].downsample[0].stride == (1, 1)
    # the JAX module's own convolutions: three dilated 3x3 convs, block 0's
    # among them (torchvision's DC5 would dilate two)
    mod = jax_resnet.ResNet(layers=(3, 4, 6, 3), dilation=True)
    x = jnp.zeros((1, 64, 64, 3))
    variables = jax.eval_shape(mod.init, jax.random.PRNGKey(0), x)
    jaxpr = jax.make_jaxpr(mod.apply)(variables, x)
    dilations = [tuple(e.params["rhs_dilation"]) for e in jaxpr.jaxpr.eqns
                 if e.primitive.name == "conv_general_dilated"]
    assert dilations.count((2, 2)) == 3


def test_drop_path_keeps_and_scales_each_sample():
    dp = swin.DropPath(0.25)
    x = torch.ones(4000, 3, 5)
    assert dp.eval()(x) is x
    y = dp.train()(x)
    kept = (y != 0).flatten(1)
    assert (kept.all(1) | ~kept.any(1)).all()  # the whole sample, or nothing of it
    assert torch.all(y[kept.all(1)] == 1.0 / 0.75)
    assert abs(kept.all(1).float().mean().item() - 0.75) < 0.03
    assert swin.DropPath(0.0).train()(x) is x


@pytest.mark.parametrize("case", ["swin_t_64x96", "video_swin_t_T10"])
def test_recomputation_gives_the_same_gradients_with_drop_path(case):
    """``use_checkpoint`` recomputes each block in the backward pass with the
    RNG state kept, so DropPath draws the same masks: the gradients are
    those of the plain backward, within 1e-5 of each tensor's largest (the
    bias tables' gradients are index_put accumulations, whose order the
    CPU's threads vary; another DropPath mask would move them by its whole
    branch)."""
    _, _, flat, x = _variables(case)

    def grads(recompute: bool, train: bool):
        module = _port(case, flat).train(train)
        module.use_checkpoint = recompute
        torch.manual_seed(3)
        outs = module(_to_torch_input(x))
        sum((o * (i + 1)).sum() for i, o in enumerate(outs)).backward()
        return {n: p.grad for n, p in module.named_parameters()}

    plain, recomputed, no_drop = grads(False, True), grads(True, True), grads(False, False)
    # DropPath drew: without it the gradients are other ones
    assert any(not torch.allclose(g, no_drop[n]) for n, g in plain.items())
    for name, g in plain.items():
        torch.testing.assert_close(recomputed[name], g, rtol=1e-5,
                                   atol=1e-5 * float(g.abs().max()), msg=name)


def _zeros_like(flat):
    """JAX variables of ``flat``'s structure, all zeros."""
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.zeros(v.shape)
                                         for k, v in flat.items()})


@pytest.mark.parametrize("case", FAMILIES)
def test_every_leaf_maps_to_the_jax_key_and_round_trips(case):
    mod, variables, flat, _ = _variables(case)
    for path in flat:
        mapped = jax_ckpt.flax_to_torch_key(path)
        assert mapped is not None, path
        assert torch_key(path) == mapped[0], path
    sd = _port(case, flat).state_dict()
    back, missing, unexpected = jax_ckpt.convert_state_dict(
        {f"{BODY}.{k}": v.numpy() for k, v in sd.items()}, _zeros_like(flat), strict=True,
        verbose=False)
    assert not missing and not unexpected
    back = traverse_util.flatten_dict(back, sep="/")
    assert sorted(back) == sorted(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(np.asarray(back[path]), value, err_msg=path)


def test_kinetics_patch_embedding_loads_as_its_temporal_sum_in_both_packages():
    case = "video_swin_t_T3"
    _, _, flat, _ = _variables(case)
    port_sd = {f"{BODY}.{k}": v for k, v in _port(case, flat).state_dict().items()}
    k400 = torch.from_numpy(np.random.RandomState(5).randn(96, 3, 2, 4, 4).astype(np.float32))
    ckpt = dict(port_sd, **{checkpoint.PATCH_EMBED_KEY: k400})
    got, missing, unexpected = checkpoint.convert_state_dict(ckpt, port_sd, strict=True,
                                                             verbose=False)
    summed = k400.sum(dim=2, keepdim=True)
    assert torch.equal(got[checkpoint.PATCH_EMBED_KEY], summed)
    back, _, _ = jax_ckpt.convert_state_dict({k: v.numpy() for k, v in ckpt.items()},
                                             _zeros_like(flat), strict=True, verbose=False)
    kernel = np.asarray(back["params"]["backbone"]["patch_embed_proj"]["kernel"])  # DHWIO
    np.testing.assert_allclose(np.transpose(kernel, (4, 3, 0, 1, 2)), summed.numpy(),
                               rtol=1e-6, atol=1e-6)
    # any other shape that differs still raises
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.convert_state_dict(
            dict(ckpt, **{f"{BODY}.patch_embed.norm.weight": torch.zeros(7)}), port_sd,
            verbose=False)
