#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tce_rvos_tpu_torch``) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each one fails the run, nothing is caught and carried on):
  1. build   - compile every CUDA kernel from csrc/ (nvcc, in parallel);
  2. kernels - hold each kernel against its plain PyTorch version at the
               shapes the flagship serving path gives it, f32 and bf16;
  3. path    - flagship model at full width (ResNet-50 + RoBERTa-base,
               f_token 8, IQT, box refine, binary) from seeded random
               weights; InferenceEngine.run_video_batch on a 10-frame
               360x640 video (two 5-frame windows) with E = 4 captions, in
               bf16 and f32; checks shapes, finiteness, boxes in [0, 1],
               12 MSDA kernel launches per trunk forward, batched masks
               equal serial run_video masks;
  4. parity  - one window, E = 1, f32 with TF32 off, GPU (kernel) against
               the same weights on the CPU (plain MSDA);
  5. numbers - card name and power limit, clips/s and ms per trunk
               forward, peak memory per E, and a JSON ``kernels`` line.

The last line of standard output is the device JSON line. Without a CUDA
device, or without the package beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

FLAGSHIP_SHAPES = ((48, 80), (24, 40), (12, 20), (6, 10))  # 384x640 clip
M, D, L, P = 8, 32, 4, 4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12    # non-tensor-core float32 peak


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` launches, each timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from tce_rvos_tpu_torch.ops import _build
    from tce_rvos_tpu_torch.ops.msda_cuda import SOURCE

    t0 = time.perf_counter()
    so = _build.build(SOURCE)
    secs = time.perf_counter() - t0
    log(f"[build] {SOURCE} -> {so.name}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")
    log(f"[build] seconds={secs:.3f}")


# ---------------------------------------------------------------------------
# phase 2: kernel against plain
# ---------------------------------------------------------------------------

def msda_inputs(kind: str, n: int, q: int, dtype, gen, device):
    """Seeded MSDA inputs at the flagship level shapes, with the reference
    points of each call site: the query's own pixel centre (encoder, q = S,
    so neighbouring queries read neighbouring values), free points (FTF) or
    boxes (decoder, 4-d). Offsets reach outside [0, 1], and one point of
    every head and level lands exactly on a pixel centre."""
    import torch

    s = sum(h * w for h, w in FLAGSHIP_SHAPES)
    value = torch.randn(n, s, M, D, generator=gen).to(device=device, dtype=dtype)
    wh = torch.tensor([[w, h] for h, w in FLAGSHIP_SHAPES], dtype=torch.float32)
    if kind != "decoder":
        if kind == "encoder":
            grids = [torch.stack(torch.meshgrid((torch.arange(w) + 0.5) / w,
                                                (torch.arange(h) + 0.5) / h,
                                                indexing="xy"), -1).reshape(-1, 2)
                     for h, w in FLAGSHIP_SHAPES]
            ref = torch.cat(grids)[None, :, None, None, None, :].expand(n, q, 1, 1, 1, 2)
        else:
            ref = torch.rand(n, q, 1, 1, 1, 2, generator=gen) * 1.2 - 0.1
        off = torch.randn(n, q, M, L, P, 2, generator=gen) * 4.0
        loc = ref + off / wh[None, None, None, :, None, :]
    else:
        box = torch.rand(n, q, 1, 1, 1, 4, generator=gen)
        off = torch.randn(n, q, M, L, P, 2, generator=gen)
        loc = box[..., :2] + off / P * box[..., 2:] * 0.5
    # exact pixel centres for one point of every head
    pix = torch.floor(torch.rand(n, q, M, L, 2, generator=gen) * wh)
    loc[:, :, :, :, 0, :] = (pix + 0.5) / wh
    logits = torch.randn(n, q, M, L * P, generator=gen)
    attn = torch.softmax(logits, -1).reshape(n, q, M, L, P)
    return value, loc.contiguous().to(device), attn.contiguous().to(device)


def msda_bound(value, loc, attn, out) -> dict:
    """The least time of one MSDA call on this call's data: the larger of
    its compulsory bytes over the HBM rate and its operations over the f32
    peak. Bytes: locations, weights and output once each, and of the value
    only the rows (one pixel of one head, D channels) that some tap reads
    with a non-zero bilinear weight; at the FTF and decoder shapes the taps
    touch a small part of the value. Operations: one FMA per channel for
    each such corner and one for each tap that has one."""
    import torch

    n, s, m, d = value.shape
    dev = loc.device
    touched = torch.zeros(n * s * m, dtype=torch.bool, device=dev)
    n_idx = torch.arange(n, device=dev)[:, None, None, None]
    m_idx = torch.arange(m, device=dev)[None, None, :, None]
    corners = taps = start = 0
    for lvl, (h, w) in enumerate(FLAGSHIP_SHAPES):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5  # [n, q, m, p]
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        dx, dy = x - x0, y - y0
        tap_live = torch.zeros_like(x, dtype=torch.bool)
        for cx, cy, wgt in ((x0, y0, (1 - dx) * (1 - dy)), (x0 + 1, y0, dx * (1 - dy)),
                            (x0, y0 + 1, (1 - dx) * dy), (x0 + 1, y0 + 1, dx * dy)):
            ok = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h) & (wgt != 0)
            pix = start + (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
            touched[((n_idx * s + pix) * m + m_idx)[ok]] = True
            corners += int(ok.sum())
            tap_live |= ok
        taps += int(tap_live.sum())
        start += h * w
    value_bytes = int(touched.sum()) * d * value.element_size()
    nbytes = value_bytes + sum(t.numel() * t.element_size() for t in (loc, attn, out))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * d * (corners + taps) / FP32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, value_bytes_read=value_bytes,
                value_bytes_all=value.numel() * value.element_size())


def phase_kernels(e: int) -> dict:
    """Kernel against plain at the serving trunk's three MSDA call shapes
    (N = 5 frames x E expressions). Returns per-shape numbers."""
    import torch

    from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_plain
    from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    s = sum(h * w for h, w in FLAGSHIP_SHAPES)
    n = 5 * e
    cases = [("encoder", n, s), ("ftf", n, 8), ("decoder", n, 5)]
    # f32: the kernel and the plain version sum the same f32 products in
    # another order (~1e-6); bf16: both round an f32 sum of bf16 taps to
    # bf16 once, so they differ by at most one bf16 step (2^-8 relative).
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (8e-3, 1e-2)}
    results = {}
    for name, nn_, q in cases:
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, attn = msda_inputs(name, nn_, q, dtype, gen, dev)
            got = ms_deform_attn(value, FLAGSHIP_SHAPES, loc, attn)
            torch.cuda.synchronize()
            ref = ms_deform_attn_plain(value, FLAGSHIP_SHAPES, loc, attn)
            err = (got.float() - ref.float()).abs()
            rtol, atol = tol[dtype]
            bad = err > atol + rtol * ref.float().abs()
            max_err = float(err.max())
            if bool(bad.any()):
                raise AssertionError(
                    f"msda kernel disagrees with plain at {name} {dtype}: "
                    f"max |err| {max_err:.3e}, {int(bad.sum())} elements out of tolerance")
            ms = cuda_ms(lambda: ms_deform_attn(value, FLAGSHIP_SHAPES, loc, attn))
            plain_ms = cuda_ms(
                lambda: ms_deform_attn_plain(value, FLAGSHIP_SHAPES, loc, attn), reps=5)
            bound = msda_bound(value, loc, attn, got)
            key = f"{name}/{str(dtype).replace('torch.', '')}"
            results[key] = dict(N=nn_, Q=q, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                                rtol=rtol, atol=atol, **bound)
            log(f"[kernels] msda_fwd {key:18s} N={nn_} Q={q}: max|err|={max_err:.3e} "
                f"(rtol {rtol}, atol {atol}) kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}; {bound['bytes']} bytes, "
                f"value {bound['value_bytes_read']} of {bound['value_bytes_all']})")
    return results


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------

CAPTIONS = (
    "the person riding a brown horse on the beach",
    "a small white dog running after a ball",
    "the car on the left",
    "a man in a red jacket holding an umbrella",
)
N_FRAMES, FRAME_HW = 10, (360, 640)
OUT_SHAPES = {  # per caption, 10 frames, q = 5, stride-4 masks of 384x640
    "pred_logits": (10, 5, 1), "pred_boxes": (10, 5, 4), "pred_masks": (10, 5, 96, 160),
    "reference_points": (10, 5, 2), "inter_samples": (10, 5, 30, 2),
}


def random_state_dict(cfg, seed: int = 0):
    """Flagship weights at full width from a seed: the model's own init plus
    seeded noise on every parameter, so that the MSDA offsets and weights
    depend on the query (at init they do not)."""
    import torch

    from tce_rvos_tpu_torch.models.build import build_model

    model = build_model(cfg, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    return model.state_dict()


def synthetic_video(seed: int = 0):
    """10 smooth random RGB frames in [0, 1] at 360x640."""
    import numpy as np

    rng = np.random.RandomState(seed)
    h, w = FRAME_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for t in range(N_FRAMES):
        f = np.stack([0.5 + 0.5 * np.sin((xx * a + yy * b) / 40.0 + t * 0.3 + c)
                      for a, b, c in rng.rand(3, 3)], -1)
        frames.append((f + 0.05 * rng.rand(h, w, 3)).clip(0, 1).astype(np.float32))
    return frames


def check_outputs(outs, label: str) -> None:
    import numpy as np

    if len(outs) != len(CAPTIONS):
        raise AssertionError(f"{label}: {len(outs)} results for {len(CAPTIONS)} captions")
    for e, out in enumerate(outs):
        for k, shape in OUT_SHAPES.items():
            if out[k].shape != shape:
                raise AssertionError(f"{label} caption {e}: {k} shape {out[k].shape} != {shape}")
            if not np.isfinite(out[k]).all():
                raise AssertionError(f"{label} caption {e}: {k} is not finite")
        boxes = out["pred_boxes"]
        if boxes.min() < 0.0 or boxes.max() > 1.0:
            raise AssertionError(f"{label} caption {e}: boxes outside [0, 1]")


def compare(got, want, rtol: float, atol_rel: float, label: str) -> float:
    """max |got - want| within rtol*|want| + atol_rel*max|want|; returns the
    max abs error."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    scale = max(float(np.abs(want).max()), 1.0)
    bad = err > rtol * np.abs(want) + atol_rel * scale
    if bad.any():
        raise AssertionError(f"{label}: max |err| {err.max():.3e} (scale {scale:.3g}), "
                             f"{int(bad.sum())} of {bad.size} out of tolerance")
    return float(err.max())


def mask_gap(got, want) -> tuple:
    """(relative RMS difference, share of pixels whose mask differs) of two
    mask-logit arrays; a pixel is in the mask where its logit is > 0."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    rel_rms = float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))
    return rel_rms, float(np.mean((got > 0) != (want > 0)))


# bf16 batched against serial masks: (relative RMS, share of pixels whose
# mask differs) may reach twice the largest of the 12 readings (3 videos x
# 4 captions) of the calibration run on an H100, 2.537e-2 and 4.535e-3
# (PERF.md). The gap is bf16 rounding: the first decoder layer's kernels
# round differently at E = 1 and E = 4, while expression 0 is bitwise
# independent of the other expressions (expression_isolation checks both).
# f32 is held to rtol 1e-3 plus 1e-3 of the largest |logit| on every pixel.
BF16_BATCHED_VS_SERIAL_LIMITS = (5.1e-2, 9.1e-3)


def batched_vs_serial(engine, videos, first_outs, dtype_name: str, label: str) -> dict:
    """run_video_batch (E = 4) against run_video (E = 1) for every caption
    of every video; returns the readings and the masks, keyed by (video,
    caption), for the bf16-against-f32 reading."""
    import numpy as np

    readings, masks = [], {}
    for v, frames in enumerate(videos):
        outs = first_outs if v == 0 else engine.run_video_batch(
            frames, list(CAPTIONS), exp_batch=len(CAPTIONS))
        check_outputs(outs, f"{label} video {v}")
        for e, cap in enumerate(CAPTIONS):
            got = outs[e]["pred_masks"]
            want = engine.run_video(frames, cap)["pred_masks"]
            where = f"{label} batched vs serial masks, video {v} caption {e}"
            rel_rms, flip = mask_gap(got, want)
            if dtype_name == "float32":
                compare(got, want, 1e-3, 1e-3, where)
            elif rel_rms > BF16_BATCHED_VS_SERIAL_LIMITS[0] or flip > BF16_BATCHED_VS_SERIAL_LIMITS[1]:
                raise AssertionError(f"{where}: relative RMS {rel_rms:.3e}, mask differs on "
                                     f"{flip:.3e} of pixels; limits {BF16_BATCHED_VS_SERIAL_LIMITS}")
            readings.append(dict(video=v, caption=e, rel_rms=rel_rms, flip=flip,
                                 max_abs_err=float(np.abs(got - want).max()),
                                 max_abs_logit=float(np.abs(want).max())))
            masks[(v, e)] = (got, want)
    worst = {k: max(r[k] for r in readings) for k in ("rel_rms", "flip", "max_abs_err")}
    log(f"{label} batched vs serial masks, {len(videos)} videos x {len(CAPTIONS)} captions: "
        f"largest relative RMS {worst['rel_rms']:.3e}, largest share of pixels whose mask "
        f"differs {worst['flip']:.3e}, largest max |err| {worst['max_abs_err']:.3e}; readings "
        + json.dumps([[r["video"], r["caption"], r["rel_rms"], r["flip"]] for r in readings]))
    return dict(readings=readings, worst=worst, masks=masks)


def expression_isolation(engine, frames, label: str) -> dict:
    """Why batched and serial outputs differ, on one window in the engine's
    dtype:
    * isolation: expression 0 of an E = 4 batch must not depend on the
      other three. Captions 0-3 against caption 0 four times: the shapes
      are the same, so the same kernels run, and every stage's output for
      expression 0 must be bitwise equal;
    * divergence: expression 0 alone (E = 1) against the same expression
      in the E = 4 batch, stage by stage. Only the batch each kernel sees
      differs; the readings show where the two first part, and inside the
      first decoder layer, which submodule takes equal inputs and gives
      unequal outputs;
    * mechanism: the same rows through one op alone and in a 4x batch, at
      the shapes it sees for E = 1 and E = 4: nn.Linear in the text
      encoder, the encoder FFN and the decoder FFN, and the pieces of the
      first decoder layer's IQT self-attention (in-projection, logits
      matmul, probabilities times values)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    model = engine.model
    tr = model.transformer
    stages = [("text_encoder", model.text_encoder), ("resizer", model.resizer)]
    stages += [("input_proj", m) for m in model.input_proj]
    stages += [("fusion", model.fusion_module)]
    stages += [(f"encoder{i}", m) for i, m in enumerate(tr.encoder.layers)]
    stages += [(f"decoder{i}", m) for i, m in enumerate(tr.decoder.layers)]
    stages += [("pixel_decoder", model.pixel_decoder), ("controller", model.controller)]
    video, mask, size = engine.preprocess(frames[:engine.window])
    sizes = torch.tensor([size], device=engine.device)
    feats = engine.backbone(video, mask)
    ids, attn = tokenize(list(CAPTIONS))

    def lead(o):
        while not torch.is_tensor(o):
            o = next(iter(o.values())) if isinstance(o, dict) else o[0]
        return o

    pinpoint = [(f"decoder0.{n or 'layer'}", m) for n, m in tr.decoder.layers[0].named_modules()]
    pinpoint += [(f"pixel_decoder.{n or 'module'}", m)
                 for n, m in model.pixel_decoder.named_modules()]
    mha = tr.decoder.layers[0].self_attn  # IQT: E*q sequences of t frames

    def run(ids_, attn_):
        caught = {name: [] for name, _ in stages}
        inner = {}  # pinpointed submodules, in the order they finish: name -> (input, output)
        hooks = [mod.register_forward_hook(
            lambda _m, _a, o, name=name: caught[name].append(lead(o).float().clone()))
            for name, mod in stages]

        def keep_first(name):
            def hook(_m, a, o):  # returns None: the module's output stands
                if name not in inner:
                    inner[name] = (lead(a).float().clone(), lead(o).float().clone())
                    if name == "decoder0.self_attn":  # its own inputs and layouts, for a replay
                        inner["mha_args"] = tuple((x.clone(), x.size(), x.stride()) for x in a)
            return hook

        hooks += [mod.register_forward_hook(keep_first(name)) for name, mod in pinpoint]
        try:
            out = engine.trunk(feats, mask, ids_, attn_, sizes)
        finally:
            for h in hooks:
                h.remove()
        for k in ("pred_logits", "pred_boxes", "pred_masks"):
            caught[k] = [out[k].float()]
        return caught, inner

    full, inner_full = run(ids, attn)
    same, _ = run(np.repeat(ids[:1], 4, 0), np.repeat(attn[:1], 4, 0))
    alone, inner_alone = run(ids[:1], attn[:1])
    divergence = {}
    for name in full:
        rel, share = 0.0, 0.0
        for a, b, one in zip(full[name], same[name], alone[name]):
            k = a.shape[0] // 4  # expression-major: expression 0 leads
            if not torch.equal(a[:k], b[:k]):
                raise AssertionError(
                    f"{label} isolation: expression 0's {name} output changes with the other "
                    f"expressions of its batch (max |diff| {float((a[:k] - b[:k]).abs().max()):.3e})")
            diff = (one - a[:k]).abs()
            rel = max(rel, float(diff.max()) / max(float(a[:k].abs().max()), 1e-30))
            share = max(share, float((diff > 0).float().mean()))
        divergence[name] = (rel, share)
    log(f"{label} isolation: expression 0 bitwise equal with captions 0-3 and with caption 0 "
        f"x 4, at every stage")
    log(f"{label} E=1 vs E=4, expression 0, by stage (max |diff| / max |E=4|, share of "
        f"elements that differ): " + ", ".join(
            f"{k} {r:.2e} ({s:.3f})" for k, (r, s) in divergence.items()))

    def same_rows(one, four):  # expression 0 of E = 4 against E = 1, if batch-major
        return None if one.shape[0] * 4 != four.shape[0] else torch.equal(one, four[:one.shape[0]])

    mha_args = {"E=1": inner_alone.pop("mha_args"), "E=4": inner_full.pop("mha_args")}
    inner = {}
    for name, (a_in, a_out) in inner_full.items():
        o_in, o_out = inner_alone[name]
        inner[name] = (same_rows(o_in, a_in), same_rows(o_out, a_out))
    mark = {True: "=", False: "x", None: "?"}
    log(f"{label} submodules of decoder0 and the pixel decoder that take bitwise-equal inputs "
        "at E=1 and E=4 and give unequal outputs, in the order they finish: " + ", ".join(
            k for k, (i, o) in inner.items() if i and o is False))
    log(f"{label} decoder0 submodules in the order they finish, input/output of E=1 against "
        "E=4 (= bitwise equal, x not, ? not batch-major): " + ", ".join(
            f"{k.split('.', 1)[1]} {mark[i]}/{mark[o]}" for k, (i, o) in inner.items()
            if k.startswith("decoder0.")))
    strides = {e: [st for _, _, st in args] for e, args in mha_args.items()}
    log(f"{label} decoder0 IQT self-attention input strides (query, key, value): {strides}")

    gen = torch.Generator(device=engine.device).manual_seed(0)
    lin_txt = model.text_encoder.encoder.layer[0].attention.self.query
    s_vis = sum(h * w for h, w in FLAGSHIP_SHAPES)
    gemm = {}
    for name, lin, rows in (("text_query", lin_txt, ids.shape[1]),
                            ("encoder_linear1", tr.encoder.layers[0].linear1, engine.window * s_vis),
                            ("decoder_linear1", tr.decoder.layers[0].linear1,
                             engine.window * engine.cfg.num_queries)):
        x = torch.randn(4 * rows, lin.in_features, generator=gen, device=engine.device,
                        dtype=engine.dtype)
        with torch.inference_mode():
            y_one = F.linear(x[:rows], lin.weight, lin.bias)
            y_four = F.linear(x, lin.weight, lin.bias)
        gemm[f"{name} ({rows} vs {4 * rows} rows)"] = float((y_one != y_four[:rows]).float().mean())
    seqs, t, c, h = engine.cfg.num_queries, engine.window, mha.d_model, mha.num_heads
    x = torch.randn(4 * seqs, t, c, generator=gen, device=engine.device, dtype=engine.dtype)
    w, bias = mha.in_proj_weight.chunk(3), mha.in_proj_bias.chunk(3)

    def iqt_steps(*qkv):  # the steps of MultiheadAttention.forward, with its layouts
        n = qkv[0].shape[0]
        q, k, v = (F.linear(qkv[i], w[i], bias[i]).reshape(n, t, h, c // h).transpose(1, 2)
                   for i in range(3))
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(c // h)
        probs = torch.softmax(logits, dim=-1)
        heads = torch.matmul(probs, v)
        out = mha.out_proj(heads.transpose(1, 2).reshape(n, t, c))
        return dict(input=torch.stack(qkv), in_proj=torch.stack([q, k, v]),
                    logits_matmul=logits, softmax=probs, probs_matmul=heads, out_proj=out,
                    module=mha(*qkv))

    def replay(e, layout):
        """The captured inputs, dense, or rebuilt with the trunk's strides
        (a stride-0 broadcast view clones to a dense tensor)."""
        out = []
        for x_, size, stride in mha_args[e]:
            y = x_.contiguous() if layout == "dense" else x_.as_strided(size, stride)
            if not torch.equal(y, x_):
                raise AssertionError(f"{label} replay: rebuilt input differs from the captured one")
            out.append(y)
        return out

    with torch.inference_mode():
        for src, one, four in (
                ("random", iqt_steps(x[:seqs], x[:seqs], x[:seqs]), iqt_steps(x, x, x)),
                ("replayed_dense", iqt_steps(*replay("E=1", "dense")),
                 iqt_steps(*replay("E=4", "dense"))),
                ("replayed_trunk_strides", iqt_steps(*replay("E=1", "trunk")),
                 iqt_steps(*replay("E=4", "trunk")))):
            for name in one:  # [3, n, ...] for the query, key and value inputs
                a, b = (one[name], four[name][:, :seqs]) if name in ("input", "in_proj") else (
                    one[name], four[name][:seqs])
                gemm[f"iqt_{name} {src} ({seqs} vs {4 * seqs} sequences)"] = float(
                    (a != b).float().mean())
    log(f"{label} the same rows through one op alone and in a 4x batch, share of outputs that "
        "differ (iqt_: decoder 0's IQT self-attention step by step, each step fed the previous "
        "one's output, on random inputs and replayed on the inputs it took in the E=1 and "
        "E=4 runs, as dense copies and with the strides they had there): " + ", ".join(f"{k} {v:.4f}" for k, v in gemm.items()))
    return dict(divergence=divergence, decoder0=inner, gemm_share_differ=gemm)


def phase_path(dtype_name: str, sd, videos) -> dict:
    """run_video_batch (E = 4, two 5-frame windows) through the kernel;
    expression isolation and where batched and serial part; the batched
    masks against serial run_video for every caption of every video;
    times."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.infer import InferenceEngine
    from tce_rvos_tpu_torch.models.text_encoder import tokenize
    from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn

    cfg = flagship_config(compute_dtype=dtype_name)
    engine = InferenceEngine(cfg, sd, device="cuda")
    label = f"[path {dtype_name}]"
    frames = videos[0]
    n_windows = -(-N_FRAMES // engine.window)

    ms_deform_attn.launches = 0
    t0 = time.perf_counter()
    outs = engine.run_video_batch(frames, list(CAPTIONS), exp_batch=len(CAPTIONS))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ms_deform_attn.launches
    trunk_forwards = n_windows  # one expression chunk per window
    if launches != 12 * trunk_forwards:
        raise AssertionError(f"{label} MSDA kernel launched {launches} times, "
                             f"expected 12 per trunk forward x {trunk_forwards}")
    check_outputs(outs, label)
    log(f"{label} run_video_batch E={len(CAPTIONS)}, {n_windows} windows: outputs ok, "
        f"msda_fwd launches {launches} (12 x {trunk_forwards} trunk forwards), "
        f"first call {first_s:.3f} s")

    isolation = expression_isolation(engine, frames, label)
    bvs = batched_vs_serial(engine, videos, outs, dtype_name, label)

    # steady-state serving rate: expression-windows per second
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.run_video_batch(frames, list(CAPTIONS), exp_batch=len(CAPTIONS))
    torch.cuda.synchronize()
    serve_s = (time.perf_counter() - t0) / reps
    serve_rate = len(CAPTIONS) * n_windows / serve_s

    # per-window times: full forward (E = 1, the JAX bench's clip), the
    # backbone, and the trunk per E with its peak memory
    video, mask, size = engine.preprocess(frames[:engine.window])
    sizes = torch.tensor([size], device="cuda")
    full_ms = cuda_ms(lambda: engine.run_window(video, mask, *tokenize([CAPTIONS[0]]), size),
                      reps=10)
    feats = engine.backbone(video, mask)
    backbone_ms = cuda_ms(lambda: engine.backbone(video, mask), reps=10)
    trunk = {}
    for e in (1, 2, 4, 8):
        ids, attn = tokenize([CAPTIONS[i % len(CAPTIONS)] for i in range(e)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = cuda_ms(lambda: engine.trunk(feats, mask, ids, attn, sizes), reps=10)
        peak = torch.cuda.max_memory_allocated()
        trunk[e] = dict(ms=ms, peak_gib=peak / 2**30, peak_above_resident_gib=(peak - base) / 2**30)
        log(f"{label} trunk E={e}: {ms:.3f} ms/forward, {e * 1000.0 / ms:.2f} expression-clips/s, "
            f"max_memory_allocated {peak / 2**30:.3f} GiB "
            f"({(peak - base) / 2**30:.3f} GiB above the resident weights and features)")
    breakdown = stage_breakdown(engine, feats, mask, sizes, label)
    log(f"{label} full forward (E=1, one 5x384x640 clip): {full_ms:.3f} ms = "
        f"{1000.0 / full_ms:.2f} clips/s; backbone {backbone_ms:.3f} ms/window; "
        f"run_video_batch E={len(CAPTIONS)}: {serve_s * 1e3:.3f} ms for {n_windows} windows = "
        f"{serve_rate:.2f} expression-windows/s")
    result = dict(launches=launches, trunk_forwards=trunk_forwards, first_call_s=first_s,
                  isolation=isolation, batched_vs_serial=bvs["worst"], full_ms=full_ms,
                  clips_per_s=1000.0 / full_ms, backbone_ms=backbone_ms, trunk=trunk,
                  serve_ms=serve_s * 1e3, expression_windows_per_s=serve_rate,
                  breakdown=breakdown)
    del engine
    torch.cuda.empty_cache()
    return result, bvs["masks"]


def bf16_against_f32(masks) -> None:
    """How far bf16 serving lies from f32 on the same weights and videos:
    serial and batched bf16 masks against serial f32 masks (a reading, for
    the size of bf16's own error beside the batched-vs-serial gap)."""
    out = {}
    for which, idx in (("serial", 1), ("batched", 0)):
        gaps = [mask_gap(masks["bfloat16"][key][idx], masks["float32"][key][1])
                for key in masks["float32"]]
        out[which] = dict(rel_rms=max(g[0] for g in gaps), flip=max(g[1] for g in gaps))
    log("[bf16 vs f32] masks against serial f32, largest over videos and captions: " + ", ".join(
        f"{k} bf16: relative RMS {v['rel_rms']:.3e}, mask differs on {v['flip']:.3e} of pixels"
        for k, v in out.items()))


def stage_breakdown(engine, feats, mask, sizes, label: str, e: int = 4) -> dict:
    """Where one trunk forward (E captions) spends device time: CUDA events
    around each stage (forward hooks on the model's modules, no change to
    the model), then torch.profiler's top kernels and the device's busy
    share of the forward's wall time."""
    import torch

    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    model = engine.model
    tr = model.transformer
    stages = {"text_encoder": [model.text_encoder], "input_proj": list(model.input_proj),
              "fusion": [model.fusion_module],
              "encoder_ftf": [l.ftoken_layers for l in tr.encoder.layers],
              "encoder_msda": [l.self_attn for l in tr.encoder.layers],
              "encoder": list(tr.encoder.layers), "decoder": list(tr.decoder.layers),
              "pixel_decoder": [model.pixel_decoder]}
    spans = {k: [] for k in stages}
    hooks = []
    for name, mods in stages.items():
        for mod in mods:
            def pre(_m, _a, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                spans[name].append([ev, None])

            def post(_m, _a, _o, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                spans[name][-1][1] = ev

            hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    ids, attn = tokenize([CAPTIONS[i % len(CAPTIONS)] for i in range(e)])
    engine.trunk(feats, mask, ids, attn, sizes)  # warm
    for v in spans.values():
        v.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    engine.trunk(feats, mask, ids, attn, sizes)
    end.record()
    end.synchronize()
    for h in hooks:
        h.remove()
    total = start.elapsed_time(end)
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    ms["encoder_rest"] = ms["encoder"] - ms["encoder_ftf"] - ms["encoder_msda"]
    ms["other"] = total - sum(ms[k] for k in ("text_encoder", "input_proj", "fusion",
                                              "encoder", "decoder", "pixel_decoder"))
    log(f"{label} trunk E={e} stage breakdown, {total:.3f} ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ms.items()))

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        engine.trunk(feats, mask, ids, attn, sizes)
        b.record()
        b.synchronize()
    wall = a.elapsed_time(b)

    def dev_us(evt):
        return getattr(evt, "self_device_time_total", None) or getattr(
            evt, "self_cuda_time_total", 0)

    # device-side entries only: a CPU op's self device time repeats the
    # time of the kernels it launched
    kernels = sorted(((dev_us(evt), evt.key, evt.count) for evt in prof.key_averages()
                      if str(evt.device_type).endswith("CUDA") and dev_us(evt) > 0),
                     reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    if busy_ms == 0:
        log(f"{label} profiler saw no device time; the stage events above stand alone")
    else:
        log(f"{label} profiled trunk forward: wall {wall:.3f} ms, device busy {busy_ms:.3f} ms "
            f"({100.0 * busy_ms / wall:.1f}%); top device ops:")
        for us, key, count in kernels[:12]:
            log(f"{label}   {us / 1e3:9.3f} ms  x{count:<5d} {key[:100]}")
    return {"total_ms": total, "stages_ms": ms, "profiled_wall_ms": wall,
            "device_busy_ms": busy_ms,
            "top_ops": [(key[:100], us / 1e3, count) for us, key, count in kernels[:12]]}


def phase_parity(sd, frames) -> None:
    """One window, E = 1, f32 with TF32 off: the GPU path (MSDA kernel)
    against the same weights on the CPU (plain MSDA). Tolerance: rtol 2e-3
    plus 2e-3 of each output's largest magnitude, the model-level bar of
    the JAX package's parity with the reference; cuDNN/cuBLAS and the CPU
    libraries sum in other orders."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.infer import InferenceEngine
    from tce_rvos_tpu_torch.models.text_encoder import tokenize
    from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn

    cfg = flagship_config()
    ids, attn = tokenize([CAPTIONS[0]])
    outs = {}
    for dev in ("cuda", "cpu"):
        engine = InferenceEngine(cfg, sd, device=dev)
        video, mask, size = engine.preprocess(frames[:engine.window])
        before = ms_deform_attn.launches
        t0 = time.perf_counter()
        out = engine.run_window(video, mask, ids, attn, size)
        outs[dev] = {k: v.float().cpu().numpy() for k, v in out.items()}
        secs = time.perf_counter() - t0
        launched = ms_deform_attn.launches - before
        log(f"[parity] {dev}: one window in {secs:.3f} s, msda_fwd launches {launched}")
        want = 12 if dev == "cuda" else 0  # one trunk forward; the CPU takes the plain version
        if launched != want:
            raise AssertionError(f"[parity] {dev} run launched the MSDA kernel {launched} "
                                 f"times, expected {want}")
        del engine
    errs = {}
    for k in ("pred_logits", "pred_boxes", "pred_masks", "reference_points"):
        errs[k] = compare(outs["cuda"][k], outs["cpu"][k], 2e-3, 2e-3, f"[parity] {k}")
    log(f"[parity] GPU kernel path vs CPU plain path, max |err|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def kernels_line(kern: dict, launches: int) -> dict:
    """The JSON ``kernels`` record: the main path's shape in its deployment
    dtype (encoder call, E = 4, bf16) in the top-level numbers, every
    measured shape under ``shapes``."""
    main = kern["e4"]["encoder/bfloat16"]
    return {"kernels": [{
        "name": "msda_fwd",
        "route": "cuda",
        "source": "tce_rvos_tpu_torch/csrc/msda_fwd.cu",
        "replaces": "tce_rvos_tpu/ops/pallas_msda.py:166",
        "replaces_also": ["tce_rvos_tpu/ops/pallas_msda.py:265"],
        "launches": launches,
        "max_abs_err": max(v["max_abs_err"] for e in kern.values() for v in e.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "shapes": {f"{e}/{k}": v for e, d in kern.items() for k, v in d.items()},
    }]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    try:
        import tce_rvos_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the tce_rvos_tpu_torch package is not importable ({exc}); "
              "run from the root of a checkout", file=sys.stderr)
        return 1
    # float32 means float32: no TF32 in cuDNN convolutions or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    phase_build()
    kern = {"e4": phase_kernels(e=4), "e1": phase_kernels(e=1)}
    from tce_rvos_tpu_torch import flagship_config

    sd = random_state_dict(flagship_config(), seed=0)
    videos = [synthetic_video(seed=v) for v in range(3)]
    paths, masks = {}, {}
    for dtype_name in ("bfloat16", "float32"):
        paths[dtype_name], masks[dtype_name] = phase_path(dtype_name, sd, videos)
    bf16_against_f32(masks)
    del masks
    phase_parity(sd, videos[0])
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels_line(kern, paths["bfloat16"]["launches"])))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
