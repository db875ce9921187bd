"""Backbone families (``reference/backbones.py``): the counts at every
cell's shapes are the pinned ones; a new ``backbone_<family>.py`` dropped
into a copy of the benchmark is all that the reference and the counts need
to build and count it; an unknown name raises in both, and two families
that claim one name raise."""

import itertools
import json
import shutil
import subprocess
import sys

import pytest

import bench_helpers as bh
import reference
from harness import check, core, counts
from reference.text_encoder import tokenize

TOKENS = 12  # a 10-word caption: its words, BOS and EOS
BF16 = 2

# (padded size, [(T, E, serving FLOPs of a request, MSDA forward bound of
# its E x T clip-frames)]; training: [(frames, batch, FLOPs of a step, MSDA
# forward bound, MSDA backward bound)]), as the benchmark counted them
# before the backbones became families
PINNED = {
    "tce_r50_ftf8_iqt.ytvos_whole": ((384, 640), [
        (12, 1, 2960804290560.0, 0.00013118815522388062),
        (12, 2, 5441161543680.0, 0.00026237631044776123),
        (12, 4, 10401876049920.0, 0.0005247526208955225),
        (12, 6, 15362590556160.0, 0.0007871289313432835),
        (12, 8, 20323305062400.0, 0.001049505241791045),
        (20, 1, 4971084308480.0, 0.00021864692537313431),
        (20, 2, 9141423554560.0, 0.00043729385074626863),
        (20, 4, 17482102046720.0, 0.0008745877014925373),
        (20, 6, 25822780538880.0, 0.001311881552238806),
        (20, 8, 34163459031040.0, 0.0017491754029850745),
        (28, 1, 7011599491072.0, 0.00030610569552238804),
        (28, 2, 12902155894784.0, 0.0006122113910447761),
        (28, 4, 24683268702208.0, 0.0012244227820895522),
        (28, 6, 36464381509632.0, 0.0018366341731343282),
        (28, 8, 48245494317056.0, 0.0024488455641791043),
        (36, 1, 9082349838336.0, 0.00039356446567164177),
        (36, 2, 16723358564352.0, 0.0007871289313432835),
        (36, 4, 32005376016384.0, 0.001574257862686567),
        (36, 6, 47287393468416.0, 0.0023613867940298506),
        (36, 8, 62569410920448.0, 0.003148515725373134),
    ]),
    "tce_r50_ftf8_iqt.train_b1": ((384, 640), [
        (5, 1, 3689076403200.0, 5.466173134328358e-05, 0.00010932346268656716),
    ]),
    "tce_vswinb_ftf8_iqt.clip_e1": ((384, 640), [
        (5, 1, 1831053363200.0, 5.466173134328358e-05),
        (10, 1, 3662106726400.0, 0.00010932346268656716),
        (15, 1, 5493160089600.0, 0.00016398519402985076),
    ]),
    "tce_r50_ftf8_iqt.clip_e1": ((384, 640), [
        (5, 1, 1226611558400.0, 5.466173134328358e-05),
        (10, 1, 2453223116800.0, 0.00010932346268656716),
        (15, 1, 3679834675200.0, 0.00016398519402985076),
    ]),
}

# every backbone of the families on a 5-frame 384x640 clip: (FLOPs, FLOPs
# of the first convolution, the four sizes), channels
PINNED_BACKBONES = {
    ("resnet50", False): ((200186265600.0, 5780275200.0,
                           [(96, 160), (48, 80), (24, 40), (12, 20)]), [256, 512, 1024, 2048]),
    ("resnet50", True): ((303995289600.0, 5780275200.0,
                          [(96, 160), (48, 80), (24, 40), (24, 40)]), [256, 512, 1024, 2048]),
    ("resnet101", False): ((382009344000.0, 5780275200.0,
                            [(96, 160), (48, 80), (24, 40), (12, 20)]), [256, 512, 1024, 2048]),
    ("resnet101", True): ((485818368000.0, 5780275200.0,
                           [(96, 160), (48, 80), (24, 40), (24, 40)]), [256, 512, 1024, 2048]),
    ("video_swin_t_p4w7", False): ((247364812800.0, 707788800.0,
                                    [(96, 160), (48, 80), (24, 40), (12, 20)]),
                                   [96, 192, 384, 768]),
    ("video_swin_s_p4w7", False): ((472884019200.0, 707788800.0,
                                    [(96, 160), (48, 80), (24, 40), (12, 20)]),
                                   [96, 192, 384, 768]),
    ("video_swin_b_p4w7", False): ((815480832000.0, 943718400.0,
                                    [(96, 160), (48, 80), (24, 40), (12, 20)]),
                                   [128, 256, 512, 1024]),
}

UNKNOWN = "no_such_backbone"

TOY = '''"""A toy family: four strided 3x3 convolutions, one a stage."""

from torch import nn

from .layers import conv_out

CONFIGS = {"toy_c8": dict(width=8)}
TEMPORAL = False


def channels(name):
    return [CONFIGS[name]["width"] * 2**i for i in range(4)]


def _stages(name):
    chans = channels(name)
    return [(i, o, 4 if k == 0 else 2) for k, (i, o) in enumerate(zip([3] + chans, chans))]


class Toy(nn.Module):
    def __init__(self, name):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(i, o, 3, stride=s, padding=1)
                                   for i, o, s in _stages(name))

    def forward(self, x):
        outs = []
        for conv in self.convs:
            x = conv(x).relu()
            outs.append(x)
        return outs


def build(name, cfg):
    return Toy(name), [4, 8, 16, 32], channels(name)


def flops(name, cfg, t, hw):
    (h, w), parts, sizes = hw, [], []
    for i, o, s in _stages(name):
        h, w = conv_out(h, 3, s, 1), conv_out(w, 3, s, 1)
        parts.append(2.0 * t * h * w * i * o * 9)
        sizes.append((h, w))
    return sum(parts), parts[0], sizes
'''

# run in a copy of the benchmark: the unknown name's error, DC5's, and the
# toy built, initialised, run through the whole serving forward under the
# FLOP counter, and counted
TOY_RUN = '''
import json, sys
sys.path.insert(0, "benchmark")
import torch
from torch.utils.flop_counter import FlopCounterMode
import reference
from harness import counts
from reference.text_encoder import tokenize

cfg = {**json.loads(sys.argv[1]), "backbone": "toy_c8"}
out = {}
for bad in ({"backbone": "no_such_backbone"}, {"dilation": True}):
    try:
        reference.build({**cfg, **bad}, "cpu")
    except ValueError as e:
        out[next(iter(bad))] = str(e)
model = reference.build(cfg, "cpu")
reference.init_weights(model, torch.Generator().manual_seed(0))
model.requires_grad_(False)
ids, attn = (torch.as_tensor(x).long() for x in tokenize(["a b c d e f"]))
video, mask = torch.randn(1, 2, 224, 224, 3), torch.zeros(1, 2, 224, 224, dtype=torch.bool)
with torch.no_grad(), FlopCounterMode(display=False) as fc:
    feats = model(video, mask, backbone_only=True)
    res = model(None, mask, ids, attn, torch.tensor([[224, 224]]), precomputed_feats=feats)
bb, first, sizes = counts.backbone_flops(cfg, 2, (224, 224))
out.update(families=list(reference.families()), masks=list(res["pred_masks"].shape),
           maps=[list(f.shape[1:]) for f in feats], measured=fc.get_total_flops(),
           counted=counts.forward_flops(cfg, 2, (224, 224), [8]),
           sizes=[list(s) for s in sizes], channels=counts.backbone_channels(cfg))
print(json.dumps(out))
'''


def copy_of_the_benchmark(tmp_path, family: str, source: str):
    """A checkout of the benchmark alone, with one more family module."""
    shutil.copy(bh.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bh.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark" / "reference" / f"backbone_{family}.py").write_text(source)
    return tmp_path


def run_in(cwd, code, *args):
    return subprocess.run([sys.executable, "-c", code, *args], cwd=str(cwd), capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_counts_at_every_cells_shapes_are_the_pinned_ones(name):
    cell = core.load_cell(name)
    cfg, mix = cell.config, cell.mix
    hw, rows = PINNED[name]
    assert int(tokenize([" ".join(["a"] * int(mix["caption_words"]))])[1].sum()) == TOKENS
    if mix["kind"] == "serve":
        eng = mix["engine"]
        assert counts.padded_hw(mix["frame_hw"], int(eng["size"]), int(eng["max_size"]),
                                int(eng["pad_mult"])) == hw
        assert [r[:2] for r in rows] == list(itertools.product(mix["frames"], mix["expressions"]))
        for t, e, flops, bound in rows:
            assert sum(counts.forward_flops(cfg, n, hw, [TOKENS] * e)
                       for _, n in check.windows(t, mix)) == flops
            assert counts.trunk_msda_bound_s(cfg, e * t, hw, BF16) == bound
    else:
        assert tuple(mix["frame_hw"]) == hw
        [(t, b, flops, fwd, bwd)] = rows
        assert (t, b) == (mix["frames"], mix["batch"])
        assert counts.train_flops(cfg, t, hw, [TOKENS] * b) == flops
        assert counts.trunk_msda_bound_s(cfg, b * t, hw, BF16) == fwd
        assert counts.trunk_msda_bound_s(cfg, b * t, hw, BF16, True) == bwd


@pytest.mark.parametrize("name,dilation", sorted(PINNED_BACKBONES))
def test_every_backbone_of_the_families_counts_as_pinned(name, dilation):
    cfg = {"backbone": name, "dilation": dilation}
    count, chans = PINNED_BACKBONES[name, dilation]
    assert counts.backbone_flops(cfg, 5, (384, 640)) == count
    assert counts.backbone_channels(cfg) == chans


def known_ones(names):
    return f"--backbone: unknown backbone {UNKNOWN!r}; the known ones are " + ", ".join(names)


def test_the_families_hold_every_backbone_in_file_name_order():
    fams = reference.families()
    assert [n for n in fams if (n, False) in PINNED_BACKBONES] == [
        "resnet50", "resnet101", "video_swin_t_p4w7", "video_swin_s_p4w7", "video_swin_b_p4w7"]
    names = [f.__name__ for f in fams.values()]
    assert names == sorted(names)


def test_an_unknown_backbone_raises_in_the_reference_and_the_counts():
    cfg = {**bh.tiny_config(bh.CONFIGS[0]), "backbone": UNKNOWN}
    said = known_ones(reference.families())
    with pytest.raises(ValueError) as e:
        reference.build(cfg, "cpu")
    assert str(e.value) == said
    for count in (lambda: counts.backbone_flops(cfg, 1, (64, 64)),
                  lambda: counts.backbone_channels(cfg),
                  lambda: counts.forward_flops(cfg, 1, (64, 64), [8]),
                  lambda: counts.trunk_msda_bound_s(cfg, 1, (64, 64), BF16)):
        with pytest.raises(ValueError) as e:
            count()
        assert str(e.value) == said


def test_dc5_on_a_family_without_it_names_the_flag():
    cfg = {**bh.tiny_config(bh.CONFIGS[0]), "backbone": "video_swin_t_p4w7", "dilation": True}
    with pytest.raises(ValueError) as e:
        reference.build(cfg, "cpu")
    assert str(e.value) == "--dilation: DC5 is a ResNet option, not one of 'video_swin_t_p4w7'"


def test_a_new_family_file_is_all_the_reference_and_the_counts_need(tmp_path):
    root = copy_of_the_benchmark(tmp_path, "toy", TOY)
    added = {p.relative_to(root) for p in root.rglob("*") if p.is_file()}
    there = {p.relative_to(bh.ROOT) for p in (bh.ROOT / "benchmark").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert added - there == {root.joinpath("BENCHMARK.json").relative_to(root),
                             (root / "benchmark/reference/backbone_toy.py").relative_to(root)}
    out = run_in(root, TOY_RUN, json.dumps(bh.tiny_config(bh.CONFIGS[0])))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(got["families"]) == sorted([*reference.families(), "toy_c8"])
    assert got["backbone"] == known_ones(got["families"])
    assert got["dilation"] == "--dilation: DC5 is a ResNet option, not one of 'toy_c8'"
    assert got["maps"] == [[8 * 2**i, 56 // 2**i, 56 // 2**i] for i in range(4)]
    assert got["sizes"] == [m[1:] for m in got["maps"]] and got["channels"] == [8, 16, 32, 64]
    assert got["masks"][:3] == [1, 2, 5]
    assert got["counted"] == got["measured"]


def test_two_families_claiming_one_name_raise(tmp_path):
    root = copy_of_the_benchmark(tmp_path, "dup", 'CONFIGS = {"resnet101": {}}\n')
    out = run_in(root, "import sys; sys.path.insert(0, 'benchmark')\n"
                       "import reference; reference.families()")
    assert out.returncode != 0
    last = out.stderr.strip().splitlines()[-1]
    assert last == ("ValueError: backbone 'resnet101' is claimed by both "
                    "reference.backbone_dup and reference.backbone_resnet")
