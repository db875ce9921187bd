"""The port's inference command line and protocol plumbing, on the CPU,
without JAX (``tests/test_torch_protocols.py`` holds the protocols against
the JAX package):

* ``main([... "--device", "cpu"])`` writes the ytvos, davis and mevis PNG
  trees of synthetic datasets on disk (no download), with small model
  flags;
* ``--resume`` refuses without the RoBERTa BPE tokenizer; past the guard a
  reference-layout checkpoint (``{"model": state_dict, "epoch": n}``) is laid
  over the fresh model and gives the PNGs of ``InferenceEngine(state_dict)``
  with ``run_ytvos``; missing and unexpected keys are reported, a shape
  mismatch raises;
* every flag value the port cannot run raises and names the flag (an
  unknown ``--backbone``, ``--dilation`` on a backbone that is not a
  ResNet); ``--backbone`` and ``--dilation`` build their configs, and main
  serves a Video-Swin backbone;
* two CPU engines through ``_fanout`` write the serial run's PNGs bitwise;
* ``--device cuda`` without a GPU raises; nothing falls back to the CPU;
* ``trunk_frame_envelope``: its formula, the power-of-two floor of the
  expressions per trunk dispatch, and the chunks that follow.

The synthetic trees (``write_*_tree``) are shared with
``tests/test_torch_protocols.py``.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tce_rvos_tpu_torch import infer
from tce_rvos_tpu_torch.config import ModelConfig
from tce_rvos_tpu_torch.infer import InferenceEngine, main, make_engines, run_ytvos
from tce_rvos_tpu_torch.models import text_encoder
from tce_rvos_tpu_torch.models.build import build_model
from tce_rvos_tpu_torch.utils import profiling
from tce_rvos_tpu_torch.utils.checkpoint import convert_state_dict, load_torch_file

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """At most 2 torch threads while this module runs, as
    ``torch_parity_helpers.torch_threads`` gives the modules that import
    JAX (this one does not import that module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
FRAME_HW = (48, 72)  # upscaled to 64x96 by size=64, max_size=96
# the command line's engines resize to a short side of 360 and a long side
# of at most 640: 24x320 frames become 48x640 (a 64x640 bucket), a fifth of
# the pixels of a 360-short-side frame, which keeps ResNet-50 cheap here
CLI_HW = (24, 320)

# ---- synthetic datasets on disk ------------------------------------------------------


def _write_frames(root, video, n_frames, rng, hw=FRAME_HW):
    from PIL import Image

    d = Path(root) / video
    d.mkdir(parents=True, exist_ok=True)
    names = [f"{i:05d}" for i in range(n_frames)]
    for name in names:
        img = (rng.rand(hw[0], hw[1], 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(d / f"{name}.jpg")
    return names


def _write_meta(path, videos):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"videos": videos}))


YTVOS_VIDEOS = {"goat": (5, ["the goat on the rock", "a white goat"]),
                "lion": (4, ["the lion walking", "a lion"])}


def write_ytvos_tree(root, seed=0, hw=FRAME_HW):
    """Ref-YouTube-VOS layout: two valid videos of 5 and 4 frames with 2
    expressions each, and a third valid video that the test split also
    lists, which the protocol must skip."""
    rng = np.random.RandomState(seed)
    valid = {}
    for video, (n, caps) in list(YTVOS_VIDEOS.items()) + [("zebra", (3, ["a zebra"]))]:
        frames = _write_frames(Path(root) / "valid" / "JPEGImages", video, n, rng, hw)
        valid[video] = {"frames": frames,
                        "expressions": {str(i): {"exp": c} for i, c in enumerate(caps)}}
    _write_meta(Path(root) / "meta_expressions" / "valid" / "meta_expressions.json", valid)
    _write_meta(Path(root) / "meta_expressions" / "test" / "meta_expressions.json",
                {"zebra": {"frames": valid["zebra"]["frames"], "expressions": {}}})
    return root


DAVIS_CAPTIONS = ["the black dog", "a dog running", "dog on the left", "the dark dog",
                  "a brown horse", "the horse jumping", "horse on the right", "a tall horse"]


def write_davis_tree(root, seed=1, hw=FRAME_HW):
    """Ref-DAVIS17 layout: one video of 5 frames, 2 objects x 4 annotators
    (expression ids 0-7, object = id // 4)."""
    rng = np.random.RandomState(seed)
    frames = _write_frames(Path(root) / "valid" / "JPEGImages", "dogs", 5, rng, hw)
    _write_meta(Path(root) / "meta_expressions" / "valid" / "meta_expressions.json",
                {"dogs": {"frames": frames, "expressions": {
                    str(i): {"exp": c} for i, c in enumerate(DAVIS_CAPTIONS)}}})
    return root


MEVIS_CAPTIONS = ["the bird flying away", "birds moving left", "the last bird",
                  "two birds"]


def write_mevis_tree(root, seed=2, hw=FRAME_HW):
    """MeViS layout: one valid video of 5 frames with 4 expressions."""
    rng = np.random.RandomState(seed)
    frames = _write_frames(Path(root) / "valid" / "JPEGImages", "birds", 5, rng, hw)
    _write_meta(Path(root) / "valid" / "meta_expressions.json",
                {"birds": {"frames": frames, "expressions": {
                    str(i): {"exp": c} for i, c in enumerate(MEVIS_CAPTIONS)}}})
    return root


def ytvos_pngs(out_dir, split="valid"):
    """{(video, exp_id, frame): mask} of a ytvos/mevis output tree."""
    base = Path(out_dir) / split
    return {(v.name, e.name, f.stem): _read_png(f)
            for v in sorted(base.iterdir()) for e in sorted(v.iterdir())
            for f in sorted(e.iterdir())}


def davis_pngs(out_dir, split="valid"):
    """{(annotator, video, frame): index mask} of a davis output tree."""
    base = Path(out_dir) / split
    return {(a.name, v.name, f.stem): _read_png(f)
            for a in sorted(base.iterdir()) for v in sorted(a.iterdir())
            for f in sorted(v.iterdir())}


def _read_png(path):
    from PIL import Image

    img = Image.open(path)
    return img.mode, np.array(img)


# ---- the command line -------------------------------------------------------------

# small model flags: 1 encoder and 1 decoder layer, 32 wide, narrow FFN and
# mask features, 3-frame windows (ResNet-50 and RoBERTa-base keep their
# widths: the command line has no flags for them)
SMALL = ["--binary", "--with_box_refine", "--qtrans", "--f_token", "2", "--enc_layers", "1",
         "--dec_layers", "1", "--hidden_dim", "32", "--dim_feedforward", "32",
         "--mask_dim", "8", "--num_frames", "3", "--device", "cpu"]


def _cfg_of(argv):
    import argparse

    from tce_rvos_tpu_torch.cli import add_model_args, model_config_from_args

    args, _ = add_model_args(argparse.ArgumentParser()).parse_known_args(argv)
    return model_config_from_args(args)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return {"ytvos": write_ytvos_tree(root / "ytvos", hw=CLI_HW),
            "davis": write_davis_tree(root / "davis", hw=CLI_HW),
            "mevis": write_mevis_tree(root / "mevis", hw=CLI_HW)}


@pytest.fixture
def tokenizer_guard_passes(monkeypatch):
    """Past ``require_real_tokenizer``, as with a cached roberta-base
    tokenizer (the captions still take the hash fallback)."""
    monkeypatch.setattr(text_encoder, "require_real_tokenizer", lambda context="": None)


def test_main_writes_the_three_protocol_trees(trees, tmp_path):
    out = {k: tmp_path / k for k in trees}
    main(["--dataset_file", "ytvos", "--ytvos_path", str(trees["ytvos"]),
          "--output_dir", str(out["ytvos"]), "--visualize", *SMALL])
    main(["--dataset_file", "davis", "--davis_path", str(trees["davis"]),
          "--output_dir", str(out["davis"]), "--window", "3", *SMALL])
    main(["--dataset_file", "mevis", "--mevis_path", str(trees["mevis"]),
          "--output_dir", str(out["mevis"]), *SMALL])

    got = ytvos_pngs(out["ytvos"])
    want = {(v, str(e), f"{i:05d}") for v, (n, caps) in YTVOS_VIDEOS.items()
            for e in range(len(caps)) for i in range(n)}
    assert set(got) == want  # zebra, listed by the test split, is skipped
    for mode, m in got.values():
        assert mode == "L" and m.shape == CLI_HW and set(np.unique(m)) <= {0, 255}
    vis = Path(out["ytvos"]) / "valid_vis" / "goat" / "0"
    assert sorted(p.stem for p in vis.iterdir()) == [f"{i:05d}" for i in range(5)]

    got = davis_pngs(out["davis"])
    assert set(got) == {(f"anno_{a}", "dogs", f"{i:05d}") for a in range(4) for i in range(5)}
    for mode, m in got.values():
        assert mode == "P" and m.shape == CLI_HW and set(np.unique(m)) <= {0, 1, 2}

    got = ytvos_pngs(out["mevis"])
    assert set(got) == {("birds", str(e), f"{i:05d}") for e in range(4) for i in range(5)}
    for mode, m in got.values():
        assert mode == "L" and m.shape == CLI_HW and set(np.unique(m)) <= {0, 255}


def test_trace_dir_writes_the_trace_and_the_spans(trees, tmp_path):
    """``--trace_dir``: the PNGs of the run without it, ``trace.json`` with
    the engine's and the model's spans, ``spans.json`` with the one
    request's real expression-frames (5 frames x 4 expressions) and its
    trunk dispatches; tracing is off again after."""
    argv = ["--dataset_file", "mevis", "--mevis_path", str(trees["mevis"]), *SMALL]
    main(argv + ["--output_dir", str(tmp_path / "plain")])
    trace_dir = tmp_path / "trace"
    main(argv + ["--output_dir", str(tmp_path / "traced"), "--trace_dir", str(trace_dir)])
    assert not profiling.enabled()
    got, want = ytvos_pngs(tmp_path / "traced"), ytvos_pngs(tmp_path / "plain")
    assert sorted(got) == sorted(want) and len(want) == 20
    for k in want:
        assert np.array_equal(got[k][1], want[k][1]), k
    with open(trace_dir / profiling.SPANS_FILE) as fh:
        records = json.load(fh)
    spans = records["spans"]
    names = [s["name"] for s in spans]
    (request,) = [s for s in spans if s["name"] == "tce.engine.request"]
    assert request["units"] == records["counters"]["engine.trunk_expframes_real"] == 20
    assert names.count("tce.engine.trunk") == records["counters"]["engine.trunk_dispatches"] == 2
    with open(trace_dir / profiling.TRACE_FILE) as fh:
        events = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"tce.engine.preprocess.h2d", "tce.model.pixel_decoder", "aten::conv2d"} <= events


def _checkpoint(tmp_path, sd, name="ckpt.pth", epoch=3):
    path = tmp_path / name
    torch.save({"model": sd, "epoch": epoch}, path)
    return str(path)


# no tokenizer cached (the hash fallback), or a cached one that is not
# roberta-base's (a BERT vocabulary under that name)
TOKENIZERS = {"missing": (None, "real RoBERTa BPE tokenizer"),
              "bert_vocabulary": (types.SimpleNamespace(vocab_size=30522), "not 50265")}


@pytest.mark.parametrize("which", sorted(TOKENIZERS))
def test_resume_refuses_without_the_bpe_tokenizer(trees, tmp_path, monkeypatch, which):
    tokenizer, message = TOKENIZERS[which]
    monkeypatch.setattr(text_encoder._TokenizerCache, "tried", True)
    monkeypatch.setattr(text_encoder._TokenizerCache, "tokenizer", tokenizer)
    path = _checkpoint(tmp_path, {"query_embed.weight": torch.zeros(5, 32)})
    with pytest.raises(RuntimeError, match=message):
        main(["--ytvos_path", str(trees["ytvos"]), "--output_dir", str(tmp_path / "out"),
              "--resume", path, *SMALL])
    assert not (tmp_path / "out").exists()


def test_resume_loads_a_reference_checkpoint(trees, tmp_path, tokenizer_guard_passes, capsys):
    """A reference-layout checkpoint from other weights than the command
    line's own init: main writes the PNGs of an engine built on them."""
    cfg = _cfg_of(SMALL)
    sd = build_model(cfg, device="cpu", seed=7).state_dict()
    path = _checkpoint(tmp_path, sd)
    loaded, meta = load_torch_file(path, with_meta=True)
    assert meta == {"epoch": 3} and sorted(loaded) == sorted(sd)

    main(["--ytvos_path", str(trees["ytvos"]), "--output_dir", str(tmp_path / "cli"),
          "--resume", path, *SMALL])
    assert f"checkpoint: loaded {len(sd)} tensors, 0 model tensors left at init, " \
           "0 checkpoint keys unused" in capsys.readouterr().out
    engine = InferenceEngine(cfg, sd, device="cpu")
    run_ytvos(engine, str(trees["ytvos"]), str(tmp_path / "engine"))
    got, want = ytvos_pngs(tmp_path / "cli"), ytvos_pngs(tmp_path / "engine")
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k][1], want[k][1]), k


def test_convert_state_dict_reports_missing_and_unexpected_and_refuses_shapes(capsys):
    ref = {"a": torch.zeros(2, 3), "b": torch.ones(4), "c": torch.zeros(1, dtype=torch.int64)}
    ckpt = {"a": torch.arange(6.0, dtype=torch.float64).reshape(2, 3), "c": torch.tensor([5]),
            "extra": torch.ones(1)}
    out, missing, unexpected = convert_state_dict(ckpt, ref)
    assert missing == ["b"] and unexpected == ["extra"]
    assert out["a"].dtype == torch.float32 and torch.equal(out["a"], ckpt["a"].float())
    assert out["b"] is ref["b"] and torch.equal(out["c"], torch.tensor([5]))
    assert ("checkpoint: loaded 2 tensors, 1 model tensors left at init, "
            "1 checkpoint keys unused") in capsys.readouterr().out
    with pytest.raises(ValueError, match="missing"):
        convert_state_dict(ckpt, ref, strict=True, verbose=False)
    with pytest.raises(ValueError, match="shape mismatch a"):
        convert_state_dict({"a": torch.zeros(3, 2)}, ref, verbose=False)


def test_resume_refuses_a_shape_mismatched_checkpoint(trees, tmp_path, tokenizer_guard_passes):
    path = _checkpoint(tmp_path, {"query_embed.weight": torch.zeros(7, 32)})
    with pytest.raises(ValueError, match="shape mismatch query_embed.weight"):
        main(["--ytvos_path", str(trees["ytvos"]), "--output_dir", str(tmp_path / "out"),
              "--resume", path, *SMALL])


UNSUPPORTED = {
    "--backbone": ["--backbone", "resnet18"],
    "--dilation": ["--dilation", "--backbone", "swin_t_p4w7"],
    "--two_stage": ["--two_stage"],
    "--position_embedding": ["--position_embedding", "learned"],
    "--msda_impl": ["--msda_impl", "pallas"],
}
# what the error says after the flag, where it is not "not supported"
UNSUPPORTED_MESSAGES = {
    "--backbone": "unknown backbone 'resnet18'; the known ones are resnet50, resnet101, "
                  "swin_t_p4w7, .*, video_swin_b_p4w7, x3d_xs, .*, x3d_self$",
    "--dilation": "DC5 is a ResNet option, not one of 'swin_t_p4w7'",
}


@pytest.mark.parametrize("flag", sorted(UNSUPPORTED))
def test_unsupported_flag_raises_naming_it(flag, tmp_path):
    argv = SMALL + UNSUPPORTED[flag]
    message = UNSUPPORTED_MESSAGES.get(flag, "not supported")
    with pytest.raises(ValueError, match=f"^{flag}: {message}"):
        main(["--output_dir", str(tmp_path), *argv])


def test_backbone_flags_build_their_configs():
    cfg = _cfg_of(["--backbone", "video_swin_b_p4w7", *SMALL])
    assert (cfg.backbone, cfg.dilation) == ("video_swin_b_p4w7", False)
    cfg = _cfg_of(["--dilation", *SMALL])
    assert (cfg.backbone, cfg.dilation) == ("resnet50", True)
    cfg = _cfg_of(["--backbone", "resnet101", "--dilation", *SMALL])
    assert (cfg.backbone, cfg.dilation) == ("resnet101", True)


def test_main_serves_a_video_swin_backbone(trees, tmp_path):
    out = tmp_path / "ytvos"
    main(["--dataset_file", "ytvos", "--ytvos_path", str(trees["ytvos"]), "--output_dir",
          str(out), "--backbone", "video_swin_t_p4w7", *SMALL])
    got = ytvos_pngs(out)
    assert set(got) == {(v, str(e), f"{i:05d}") for v, (n, caps) in YTVOS_VIDEOS.items()
                        for e in range(len(caps)) for i in range(n)}
    for mode, m in got.values():
        assert mode == "L" and m.shape == CLI_HW and set(np.unique(m)) <= {0, 255}


def test_device_cuda_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    argv = ["--output_dir", str(tmp_path), *SMALL[:-2], "--device", "cuda"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    # the module's own entry point: the default device is cuda
    res = subprocess.run([sys.executable, "-m", "tce_rvos_tpu_torch.infer", *argv[:-2]],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode != 0 and "CUDA is not available" in res.stderr
    assert not list(tmp_path.iterdir())


# ---- the fan-out and the envelope, on the tiny model ----------------------------------

TINY = ModelConfig(enc_layers=2, dec_layers=2, dim_feedforward=64, text_encoder_layers=2,
                   text_encoder_hidden=64, text_encoder_heads=4, text_encoder_intermediate=128,
                   f_token=2, qtrans=True, with_box_refine=True)
ENGINE_KW = dict(size=64, max_size=96, window=3)


def test_two_cpu_engines_fan_out_to_the_serial_pngs(trees, tmp_path):
    sd = build_model(TINY, device="cpu", seed=3).state_dict()
    engines = make_engines(TINY, sd, num_devices=2, device="cpu", **ENGINE_KW)
    assert len(engines) == 2 and engines[0] is not engines[1]
    run_ytvos(engines[0], str(trees["ytvos"]), str(tmp_path / "serial"), whole_video=False)
    run_ytvos(engines, str(trees["ytvos"]), str(tmp_path / "fanout"), whole_video=False)
    got, want = ytvos_pngs(tmp_path / "fanout"), ytvos_pngs(tmp_path / "serial")
    assert sorted(got) == sorted(want) and len(want) == 18
    for k in want:
        assert np.array_equal(got[k][1], want[k][1]), k


def test_trunk_frame_envelope_formula_and_chunks(monkeypatch):
    base, per_frame = infer._ENVELOPE_GIB["bfloat16"]
    want = int((80.0 * infer._MEMORY_SAFETY - base) / per_frame)
    assert infer.trunk_frame_envelope((384, 640), "bfloat16", memory_gib=80.0) == want
    # a quarter of the pixels: four times the frames
    want_small = int((80.0 * infer._MEMORY_SAFETY - base) / (per_frame * 0.25))
    assert infer.trunk_frame_envelope((192, 320), "bfloat16", memory_gib=80.0) == want_small
    f32 = infer.trunk_frame_envelope((384, 640), "float32", memory_gib=80.0)
    assert 1 <= f32 < want
    assert infer.trunk_frame_envelope((384, 640), "float32", memory_gib=0.1) == 1
    assert [infer._pow2_floor(x) for x in (1, 2, 3, 7, 8, 9)] == [1, 2, 2, 4, 8, 8]

    # the CPU's stated memory caps nothing at the tests' sizes
    assert infer.trunk_frame_envelope((64, 128), "float32", device="cpu") > 1000

    engine = InferenceEngine(TINY, build_model(TINY, device="cpu").state_dict(), device="cpu",
                             **ENGINE_KW)
    widths = []
    trunk = engine.trunk
    monkeypatch.setattr(engine, "trunk", lambda feats, mask, ids, attn, sizes: (
        widths.append(len(ids)), trunk(feats, mask, ids, attn, sizes))[1])
    frames = [np.random.RandomState(i).rand(*FRAME_HW, 3).astype(np.float32) for i in range(3)]
    caps = ["a", "b c", "d", "e f g", "h"]
    # 48x72 frames take the 64x128 bucket; room for 3 clips of 5 frames (3 +
    # 2 context): 3 expressions, floored to 2 a dispatch
    t_clip, scale = 3 + 2, (64 * 128) / (384 * 640)
    base, per_frame = infer._ENVELOPE_GIB["float32"]
    gib = (base + per_frame * scale * (3 * t_clip + 0.5)) / infer._MEMORY_SAFETY
    monkeypatch.setattr(infer, "_CPU_MEMORY_GIB", gib)
    assert infer.trunk_frame_envelope((64, 128), "float32", device="cpu") // t_clip == 3
    outs = engine.run_video_batch(frames, caps, f_extra=1, exp_batch=8)
    assert widths == [2, 2, 1] and len(outs) == 5
    widths.clear()
    engine.run_video_batch(frames, caps, f_extra=1, exp_batch=1)
    assert widths == [1] * 5


# ---- the engine's input stage: FrameStage, with pinning off (CPU) ------------------

def _stage_frames(dtype, t, hw=(6, 10), seed=0):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return [rng.randint(0, 256, hw + (3,)).astype(np.uint8) for _ in range(t)]
    # f64 values that round to f32 (not exact), as decoders and /255 give
    return [(rng.rand(*hw, 3) * 1.7 - 0.3).astype(dtype) for _ in range(t)]


def _stacked(frames):
    """The engine's earlier input stage, held as the oracle."""
    return np.stack([np.asarray(f, np.float32) for f in frames])


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8])
def test_frame_stage_is_bitwise_the_stack(dtype):
    stage = infer.FrameStage(torch.device("cpu"))
    assert not stage.pin
    frames = _stage_frames(dtype, 5)
    frames[2] = np.ascontiguousarray(frames[2][:, ::-1])[:, ::-1]  # negative strides
    got = stage.upload(frames)
    assert got.dtype == torch.float32 and got.shape == (5, 6, 10, 3)
    assert np.array_equal(got.numpy().view(np.uint32), _stacked(frames).view(np.uint32))
    with pytest.raises(ValueError, match="differ in shape"):
        stage.upload(frames[:2] + [frames[2][:, :-1]])


def test_frame_stage_reuses_its_buffer_and_grows_once():
    stage = infer.FrameStage(torch.device("cpu"))
    with profiling.tracing():
        stage.upload(_stage_frames(np.float32, 5))
    assert profiling.collect()["counters"] == {"engine.pinned_allocs": 1,
                                               "engine.pinned_frames": 5}
    ptr, size = stage.buf.data_ptr(), stage.buf.numel()
    assert size == infer._pow2_ceil(5 * 6 * 10 * 3)
    for t, seed in ((5, 1), (3, 2), (5, 3)):  # the same size or smaller
        frames = _stage_frames(np.float64, t, seed=seed)
        with profiling.tracing():
            got = stage.upload(frames)
        assert profiling.collect()["counters"] == {"engine.pinned_frames": t}
        assert stage.buf.data_ptr() == ptr and np.array_equal(got.numpy(), _stacked(frames))
    frames = _stage_frames(np.uint8, 9, seed=4)
    with profiling.tracing():
        got = stage.upload(frames)
    assert profiling.collect()["counters"] == {"engine.pinned_allocs": 1,
                                               "engine.pinned_frames": 9}
    assert stage.buf.numel() == infer._pow2_ceil(9 * 6 * 10 * 3)
    assert np.array_equal(got.numpy(), _stacked(frames))


def test_frame_stage_goes_in_chunks_over_its_cap(monkeypatch):
    frame_bytes = 4 * 6 * 10 * 3
    monkeypatch.setattr(infer, "STAGE_CAP_BYTES", 3 * frame_bytes + 16)
    stage = infer.FrameStage(torch.device("cpu"))
    frames = _stage_frames(np.float64, 7, seed=5)
    with profiling.tracing():
        got = stage.upload(frames)
    rec = profiling.collect()
    assert np.array_equal(got.numpy().view(np.uint32), _stacked(frames).view(np.uint32))
    units = {name: [s["units"] for s in rec["spans"] if s["name"] == name]
             for name in ("tce.engine.preprocess.stack", "tce.engine.preprocess.h2d")}
    assert units == {"tce.engine.preprocess.stack": [3, 3, 1],
                     "tce.engine.preprocess.h2d": [3, 3, 1]}
    assert rec["counters"] == {"engine.pinned_allocs": 1, "engine.pinned_frames": 7}
    assert stage.buf.numel() * 4 <= infer.STAGE_CAP_BYTES
    # a frame larger than the cap goes alone, in a buffer of its size
    monkeypatch.setattr(infer, "STAGE_CAP_BYTES", frame_bytes // 2)
    got = stage.upload(frames[:2])
    assert stage.buf.numel() * 4 >= frame_bytes
    assert np.array_equal(got.numpy(), _stacked(frames[:2]))


def test_frame_stage_calls_from_threads_take_turns():
    """Threads sharing one stage each get their own frames back: without
    the stage's lock one thread's rows would be overwritten by another's
    before its copy."""
    import threading

    stage = infer.FrameStage(torch.device("cpu"))
    wrong, done = [], []

    def worker(k):
        for i in range(40):
            frames = [np.full((6, 10, 3), k * 1000 + i * 10 + j, np.float32) for j in range(4)]
            if not np.array_equal(stage.upload(frames).numpy(), _stacked(frames)):
                wrong.append((k, i))
        done.append(k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = 2 * (os.cpu_count() or 1)  # more than the cores
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(workers)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and len(done) == len(threads)
    assert wrong == []


class _StackStage:
    """A stand-in for the engine's stage: the stacked oracle, copied up."""

    def __init__(self, device):
        self.device = device

    def upload(self, frames):
        return torch.as_tensor(_stacked(frames)).to(self.device)


def test_cpu_engine_keeps_the_stack_path():
    """The CPU engine stages its frames through an unpinned ``FrameStage``
    (the one input path of every engine), and ``preprocess`` gives what it
    gives from the stacked frames, bitwise."""
    engine = InferenceEngine(TINY, build_model(TINY, device="cpu").state_dict(), device="cpu",
                             **ENGINE_KW)
    assert isinstance(engine._stage, infer.FrameStage) and not engine._stage.pin
    for dtype, hw in ((np.float64, (48, 80)), (np.uint8, (64, 96))):
        frames = _stage_frames(dtype, 3, hw=hw, seed=6)
        got = engine.preprocess(frames)
        assert not engine._stage.buf.is_pinned()
        stage, engine._stage = engine._stage, _StackStage(engine.device)
        try:
            want = engine.preprocess(frames)
        finally:
            engine._stage = stage
        assert got[2] == want[2]
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
