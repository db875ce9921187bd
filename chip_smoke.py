#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tce_rvos_tpu_torch``) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each one fails the run, nothing is caught and carried on from):
  1. build   - compile every CUDA kernel from csrc/ (one nvcc per source,
               all started together), printing registers and spills;
  2. kernels - hold each kernel against its plain PyTorch version: the MSDA
               forward at the shapes the flagship serving path gives it,
               the MSDA backward (autograd through the plain version) at
               the training shapes (N = 5 frames; encoder Q = 5100, FTF
               Q = 8, decoder Q = 5 with 4-d refs), f32 and bf16, with
               out-of-range and pixel-centre taps; the 2D kernels' launch
               plan against its Python mirror; the 2D and 3D kernels on
               edge cases (a ragged query count, shuffled queries, far
               taps, x or y = -1, L = 3 and P = 2; in 3D also f_im = -1
               and N - 1, integer and halfway frames, frames past both
               ends, N = 1); times and bounds; then the 2D and 3D kernels
               timed in turns against other builds of their entry points
               found in build/ab/ (git-ignored), e.g. an earlier version's
               sources (phase_ab);
  3. path    - flagship model at full width (ResNet-50 + RoBERTa-base,
               f_token 8, IQT, box refine, binary) from seeded random
               weights; InferenceEngine.run_video_batch on a 10-frame
               360x640 video (two 5-frame windows) with E = 4 captions, in
               bf16 and f32; checks shapes, finiteness, boxes in [0, 1],
               12 MSDA kernel launches per trunk forward, batched masks
               equal serial run_video masks;
  4. parity  - one window, E = 1, f32 with TF32 off, GPU (kernel) against
               the same weights on the CPU (plain MSDA);
  5. train   - the flagship at full width and depth, b = 1, 5x384x640,
               random targets: train_one_epoch over 10 bf16 steps (f32
               master weights, dropout on); finite losses, a non-zero
               gradient on every trainable parameter, parameters moved,
               12 MSDA forward + 12 backward launches per step; the
               gradients of one f32 step with use_checkpoint (dropout off)
               held against one without (24 forward launches); bf16 steps
               with recomputation; ms/step, steps/s, peak memory and MFU
               with and without recomputation; the device's busy share and
               top ops of one step under torch.profiler;
  6. train parity - one f32 step (TF32 off, dropout off), GPU (kernels)
               against CPU (plain MSDA), full width on a 2x192x320 clip;
  7. 3D path - the temporal-MSDA flagship (``--msda_3d``: 3D MSDA in the
               encoder and decoder, 2D in FTF) from its own seeded weights
               (first, at two weight seeds, one f32 train step on the GPU
               and one on the CPU, each held against float64: the GPU no
               farther from it than the CPU's own f32 step plus the
               GPU-against-CPU limits):
               run_video_batch E = 4 in bf16 (8 3D + 4 2D forward launches
               per trunk forward; batched against serial masks printed as a
               reading, since the 3D op's time axis spans the expressions;
               where the encoder's taps land in time, a reading);
               one window at E = 2, f32, GPU against CPU; 4 bf16 train
               steps (8 + 8 3D and 4 + 4 2D launches per step, a gradient
               on every parameter and on the temporal offset rows); one f32
               train step GPU against CPU. The kernels phase holds the 3D
               forward at the serving shapes (N = 20 and 5) and the 3D
               backward at the training shapes (N = 5, and N = 10 with taps
               crossing clips), with frames past both ends of the axis,
               exact-integer and halfway frames;
  8. protocols - the trunk's peak memory at (E, T) points per compute
               dtype, fitted and held under ``infer._ENVELOPE_GIB``; on
               synthetic trees of 720x1280 JPEG frames: ytvos whole-video
               in bf16 (PNGs bitwise the threshold of run_video_batch on
               the same engine, 12 2D forward launches per trunk forward,
               N = 160 at the 40-frame window; the kernels phase holds the
               2D forward at N = 160 too), davis through ``infer.main``,
               mevis, windowed f32 PNGs GPU against CPU, a ``--msda_3d``
               windowed run; wall seconds, frames/s, expression-windows/s
               and peak memory per protocol;
  9. main    - ``train.main`` at full width and depth, bf16, on a
               synthetic 720x1280 Ref-YouTube-VOS train tree (3 videos x 20
               frames x 2 expressions = 24 samples an epoch; an object that
               leaves some frames): two epochs (12 + 12 MSDA launches per
               step); a resume from ``checkpoint/`` for a third (starts at
               epoch 2, parameters and AdamW state bitwise the saved ones,
               the schedule's LR); a resume from a reference-format
               ``.pth`` for a third (AdamW empty, the schedules
               fast-forwarded, then an epoch of steps);
               ``--msda_3d --batch_size 2`` for one epoch (8 + 8 3D and
               4 + 4 2D launches per step); the 2D kernels held against
               plain at the largest padded shape of the 2D runs (N = 5)
               and, with the 3D kernels, at that of the ``--msda_3d`` run
               (N = 10); ms/step and the step thread's CPU time, the
               logger's data share, padded shapes, peak memory, checkpoint
               seconds and bytes;
 10. numbers - card name and power limit, clips/s and ms per trunk
               forward, peak memory per E, and a JSON ``kernels`` line.

The last line of standard output is the device JSON line. Without a CUDA
device, or without the package beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

FLAGSHIP_SHAPES = ((48, 80), (24, 40), (12, 20), (6, 10))  # 384x640 clip
M, D, L, P = 8, 32, 4, 4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12    # non-tensor-core float32 peak
BF16_DENSE_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor-core dense peak
# useful forward + backward FLOPs of one flagship training step on one
# 5x384x640 clip (the JAX package's scripts/count_flops.py, recomputation
# not counted), the numerator of the training MFU
TRAIN_USEFUL_FLOPS_PER_CLIP = 3.7012e12


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


def graph_ms(fn, calls: int = 10, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, each replay timed with CUDA events (``cuda_ms``), divided
    by ``calls``. The host's share of a call (argument checks, ctypes) is
    left out, which at the small MSDA calls is most of ``cuda_ms``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, reps=reps, warmup=2) / calls
    del graph
    return ms


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from tce_rvos_tpu_torch.ops import _build
    from tce_rvos_tpu_torch.ops.msda_cuda import SOURCES

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, all at once
        libs = list(pool.map(_build.build, SOURCES))
    secs = time.perf_counter() - t0
    for source, so in zip(SOURCES, libs):
        log_build("[build]", source, so)
    log(f"[build] seconds={secs:.3f}")


def log_build(tag: str, source, so) -> None:
    """The library a source was built into, and its kernels' registers,
    shared memory and spills (``-Xptxas -v``)."""
    log(f"{tag} {source} -> {so.name}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"{tag}   {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2: kernel against plain
# ---------------------------------------------------------------------------

def pixel_grid(shapes=FLAGSHIP_SHAPES):
    """The encoder's reference points: every pixel centre of every level,
    in the order of the flattened value, as (x, y) in [0, 1]; [S, 2]."""
    import torch

    return torch.cat([torch.stack(torch.meshgrid((torch.arange(w) + 0.5) / w,
                                                 (torch.arange(h) + 0.5) / h,
                                                 indexing="xy"), -1).reshape(-1, 2)
                      for h, w in shapes])


def own_frames(n: int, ndim: int):
    """The query's own frame coordinate, (i + 0.5) / N as the model makes it
    (an exact-integer f_im), shaped [n, 1, ...] to ``ndim`` dimensions."""
    import torch

    return ((torch.arange(n, dtype=torch.float32) + 0.5) / n).reshape(n, *[1] * (ndim - 1))


def frame_coords(n: int, shape, gen, spread: float = 1.5):
    """The third coordinate of 3D MSDA taps, [n, ...] = ``shape``: the
    query's own frame plus seeded offsets of about ``spread`` frames, so
    that taps reach past both ends of the frame axis and into neighbouring
    clips; point 0 (a pixel centre) sits exactly on the own frame (an
    exact-integer f_im), point 1 halfway between two frames (with N > 1)."""
    import torch

    own = own_frames(n, len(shape))
    f = own + torch.randn(shape, generator=gen) * spread / n
    f[..., 0] = own[..., 0]
    if n > 1:
        f[..., 1] = torch.randint(1, n, shape[:-1], generator=gen).float() / n
    return f


def msda_inputs(kind: str, n: int, q: int, dtype, gen, device, frames: bool = False,
                shapes=FLAGSHIP_SHAPES, points: int = P, spread: float = 4.0,
                frame_spread: float = 1.5):
    """Seeded MSDA inputs at the level ``shapes`` (the flagship's unless
    given) with ``points`` points, and the reference points of each call
    site: the query's own pixel centre (encoder, the first q of the S
    pixels, so neighbouring queries read neighbouring values), free points
    (FTF) or boxes (decoder, 4-d). Offsets of about ``spread`` pixels reach
    outside [0, 1], and one point of every head and level lands exactly on a
    pixel centre. ``frames`` adds the 3D op's frame coordinate
    (``frame_coords``, offsets of about ``frame_spread`` frames)."""
    import torch

    s = sum(h * w for h, w in shapes)
    n_levels = len(shapes)
    value = torch.randn(n, s, M, D, generator=gen).to(device=device, dtype=dtype)
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
    if kind != "decoder":
        if kind == "encoder":
            ref = pixel_grid(shapes)[None, :q, None, None, None, :].expand(n, q, 1, 1, 1, 2)
        else:
            ref = torch.rand(n, q, 1, 1, 1, 2, generator=gen) * 1.2 - 0.1
        off = torch.randn(n, q, M, n_levels, points, 2, generator=gen) * spread
        loc = ref + off / wh[None, None, None, :, None, :]
    else:
        box = torch.rand(n, q, 1, 1, 1, 4, generator=gen)
        off = torch.randn(n, q, M, n_levels, points, 2, generator=gen)
        loc = box[..., :2] + off / points * box[..., 2:] * 0.5
    # exact pixel centres for one point of every head
    pix = torch.floor(torch.rand(n, q, M, n_levels, 2, generator=gen) * wh)
    loc[:, :, :, :, 0, :] = (pix + 0.5) / wh
    if frames:
        loc = torch.cat([loc, frame_coords(n, loc.shape[:-1], gen, frame_spread)[..., None]], -1)
    logits = torch.randn(n, q, M, n_levels * points, generator=gen)
    attn = torch.softmax(logits, -1).reshape(n, q, M, n_levels, points)
    return value, loc.contiguous().to(device), attn.contiguous().to(device)


def msda_traffic(value, loc, zero_weight_reads: bool, shapes=FLAGSHIP_SHAPES) -> dict:
    """What one MSDA call's taps touch on this call's data: the bytes of
    the value rows (one pixel of one frame and one head, D channels) that
    some live corner reads, and the counts of live corners, live (tap,
    frame) pairs and live taps. 2D taps read the query's own frame; 3D taps
    (loc [..., 3]) the frames floor(f_im) and floor(f_im) + 1 that lie in
    [0, N - 1]. A corner is live when it lies inside its level and frame
    and, unless ``zero_weight_reads``, has non-zero bilinear and frame
    weights: the forward skips the others, the backward reads them for the
    location gradient (the right derivative at a pixel centre or an
    integer frame)."""
    import torch

    n, s, m, d = value.shape
    dev = loc.device
    touched = torch.zeros(n * s * m, dtype=torch.bool, device=dev)
    m_idx = torch.arange(m, device=dev)[None, None, :, None]
    if loc.shape[-1] == 3:
        f = loc[..., 2] * n - 0.5  # [n, q, m, l, p]
        f0 = torch.floor(f)
        frames = ((f0, 1 - (f - f0)), (f0 + 1, f - f0))
    else:
        own = torch.arange(n, device=dev, dtype=torch.float32)[:, None, None, None, None]
        own = own.expand(loc.shape[:-1])
        frames = ((own, torch.ones_like(own)),)
    corners = frame_taps = taps = start = 0
    for lvl, (h, w) in enumerate(shapes):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5  # [n, q, m, p]
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        dx, dy = x - x0, y - y0
        tap_live = torch.zeros_like(x, dtype=torch.bool)
        for fr, fw in frames:
            fr, fw = fr[:, :, :, lvl], fw[:, :, :, lvl]
            f_ok = (fr >= 0) & (fr < n) & (zero_weight_reads | (fw != 0))
            fr_i = fr.clamp(0, n - 1).long()
            frame_live = torch.zeros_like(tap_live)
            for cx, cy, wgt in ((x0, y0, (1 - dx) * (1 - dy)), (x0 + 1, y0, dx * (1 - dy)),
                                (x0, y0 + 1, (1 - dx) * dy), (x0 + 1, y0 + 1, dx * dy)):
                ok = f_ok & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h) & (
                    zero_weight_reads | (wgt != 0))
                pix = start + (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
                touched[((fr_i * s + pix) * m + m_idx)[ok]] = True
                corners += int(ok.sum())
                frame_live |= ok
            frame_taps += int(frame_live.sum())
            tap_live |= frame_live
        taps += int(tap_live.sum())
        start += h * w
    return dict(value_bytes=int(touched.sum()) * d * value.element_size(), corners=corners,
                frame_taps=frame_taps, taps=taps, lerp=loc.shape[-1] == 3)


def _bound(nbytes: int, ops: int, value, value_bytes: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops, value_bytes_read=value_bytes,
                value_bytes_all=value.numel() * value.element_size())


def msda_bound(value, loc, attn, out, shapes=FLAGSHIP_SHAPES) -> dict:
    """The least time of one MSDA forward call (2D or 3D) on this call's
    data: the larger of its compulsory bytes over the HBM rate and its
    operations over the f32 peak. Bytes: locations (2 or 3 floats a tap),
    weights and output once each, and of the value only the (frame, pixel)
    rows that some tap reads with non-zero weights; at the FTF and decoder
    shapes the taps touch a small part of the value. Operations: one FMA per
    channel for each such corner, one for each tap that has one, and in 3D
    one for each live (tap, frame) pair (the frame lerp)."""
    tr = msda_traffic(value, loc, zero_weight_reads=False, shapes=shapes)
    nbytes = tr["value_bytes"] + sum(t.numel() * t.element_size() for t in (loc, attn, out))
    fmas = tr["corners"] + tr["taps"] + (tr["frame_taps"] if tr["lerp"] else 0)
    return _bound(nbytes, 2 * value.shape[-1] * fmas, value, tr["value_bytes"])


def msda_bwd_bound(value, loc, attn, grad_out, shapes=FLAGSHIP_SHAPES) -> dict:
    """The least time of one MSDA backward call (2D or 3D) on this call's
    data. Bytes: the (frame, pixel) value rows that live corners read
    (zero-weight corners and frames included: the location gradient reads
    them), locations, weights and the upstream gradient once each, d_value
    written once in the value's dtype, and d_loc and d_attn (f32) written
    once. The kernel's f32 scratch, its zeroing and its cast are not
    counted: the function does not need them. Operations per channel: for
    each live corner its tap product, its two location-gradient terms and
    its d_value product and sum (8); for each live tap its d_attn product
    (2); in 3D for each live (tap, frame) pair the frame weight's products
    into the tap and the two location terms and the frame gradient's term
    (8)."""
    tr = msda_traffic(value, loc, zero_weight_reads=True, shapes=shapes)
    f32 = 4
    nbytes = (tr["value_bytes"] + sum(t.numel() * t.element_size() for t in (loc, attn, grad_out))
              + value.numel() * value.element_size() + (loc.numel() + attn.numel()) * f32)
    ops = 8 * tr["corners"] + 2 * tr["taps"] + (8 * tr["frame_taps"] if tr["lerp"] else 0)
    return _bound(nbytes, value.shape[-1] * ops, value, tr["value_bytes"])


# forward kernel against plain: f32, the kernel and the plain version sum
# the same f32 products in another order (~1e-6); bf16, both round an f32
# sum of bf16 taps to bf16 once, so they differ by at most one bf16 step
# (2^-8 relative). (rtol, atol)
FWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (8e-3, 1e-2)}
# (rtol, atol as a share of the largest |reference|) of the backward kernel
# against autograd through the plain version. d_loc and d_attn are f32 sums
# of the same f32 products in another order, whatever the value's dtype;
# d_value is summed with atomics in an order that changes from run to run
# and then cast to the value's dtype: in bf16 the two may round to
# neighbouring values, one bf16 step (at most 2^-7 relative) apart.
BWD_TOL = {"f32": (1e-4, 1e-5), "bf16_d_value": (1e-2, 1e-3)}


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def hold_forward(op, plain, label: str, value, shapes, loc, attn):
    """One forward call of ``op`` (a kernel) against ``plain`` at FWD_TOL;
    returns (the kernel's output, the largest |difference|)."""
    import torch

    got = op(value, shapes, loc, attn)
    torch.cuda.synchronize()
    ref = plain(value, shapes, loc, attn)
    err = (got.float() - ref.float()).abs()
    rtol, atol = FWD_TOL[dtype_name(value.dtype)]
    bad = err > atol + rtol * ref.float().abs()
    if bool(bad.any()):
        raise AssertionError(f"{label}: kernel disagrees with plain, max |err| "
                             f"{float(err.max()):.3e}, {int(bad.sum())} elements out of "
                             f"tolerance (rtol {rtol}, atol {atol})")
    return got, float(err.max())


def hold_backward(op, plain, label: str, value, shapes, loc, attn, g) -> dict:
    """The gradients of ``op`` (through its autograd function, as the model
    calls it) against autograd through ``plain`` at BWD_TOL; returns the
    largest |difference| of each."""
    import torch

    grads = {}
    for which, fn in (("kernel", op), ("plain", plain)):
        ins = [t.detach().clone().requires_grad_(True) for t in (value, loc, attn)]
        fn(ins[0], shapes, ins[1], ins[2]).backward(g)
        torch.cuda.synchronize()
        grads[which] = [t.grad.float() for t in ins]
    errs = {}
    for gname, got, ref in zip(("d_value", "d_loc", "d_attn"), grads["kernel"], grads["plain"]):
        rtol, atol = BWD_TOL["bf16_d_value" if (gname == "d_value" and value.dtype == torch.bfloat16)
                             else "f32"]
        scale = float(ref.abs().max())
        err = (got - ref).abs()
        bad = err > rtol * ref.abs() + atol * scale
        errs[gname] = float(err.max())
        if bool(bad.any()):
            raise AssertionError(
                f"{label} {gname}: kernel disagrees with plain, max |err| {errs[gname]:.3e} "
                f"(scale {scale:.3g}), {int(bad.sum())} elements out of tolerance (rtol {rtol}, "
                f"atol {atol} x scale)")
    return errs


def hold_plan(backward: bool, label: str, value, shapes, loc) -> dict:
    """The 2D kernels' launch plan as the library computes it against
    ``launch_plan`` (its Python mirror); returns it."""
    from tce_rvos_tpu_torch.ops.msda_cuda import kernel_plan, launch_plan

    n, _, m, _ = value.shape
    args = (backward, value.dtype, shapes, n, loc.shape[1], m)
    got, want = kernel_plan(*args), launch_plan(*args)
    if got != want:
        raise AssertionError(f"{label}: the kernel's launch plan {got} is not launch_plan's {want}")
    return got


def phase_kernels(e: int, is_3d: bool = False, shapes=FLAGSHIP_SHAPES) -> dict:
    """Forward kernel against plain at the serving trunk's MSDA call shapes
    (N = 5 frames x E expressions, levels ``shapes``, the 384x640 clip's
    unless given): 2D at the encoder, FTF and decoder shapes; 3D (the
    ``--msda_3d`` trunk) at the encoder and decoder shapes, with frames past
    both ends of the axis, exact-integer and halfway frames. Returns
    per-shape numbers."""
    import torch

    from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_3d_plain, ms_deform_attn_plain
    from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn, ms_deform_attn_3d

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2 if is_3d else 0)
    s = sum(h * w for h, w in shapes)
    n = 5 * e
    op, plain = ((ms_deform_attn_3d, ms_deform_attn_3d_plain) if is_3d
                 else (ms_deform_attn, ms_deform_attn_plain))
    kname = "msda3d_fwd" if is_3d else "msda_fwd"
    cases = [("encoder", n, s)] + ([] if is_3d else [("ftf", n, 8)]) + [("decoder", n, 5)]
    results = {}
    for name, nn_, q in cases:
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{name}/{dtype_name(dtype)}"
            label = f"{kname} {key} N={nn_} Q={q}"
            value, loc, attn = msda_inputs(name, nn_, q, dtype, gen, dev, frames=is_3d,
                                           shapes=shapes)
            plan = {} if is_3d else {"plan": hold_plan(False, label, value, shapes, loc)}
            got, max_err = hold_forward(op, plain, label, value, shapes, loc, attn)
            ms = graph_ms(lambda: op(value, shapes, loc, attn))
            plain_ms = cuda_ms(lambda: plain(value, shapes, loc, attn), reps=5)
            bound = msda_bound(value, loc, attn, got, shapes)
            rtol, atol = FWD_TOL[dtype_name(dtype)]
            results[key] = dict(N=nn_, Q=q, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                                rtol=rtol, atol=atol, levels=shapes, **plan, **bound)
            log(f"[kernels] {kname} {key:18s} N={nn_} Q={q}: max|err|={max_err:.3e} "
                f"(rtol {rtol}, atol {atol}) kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}; {bound['bytes']} bytes, "
                f"value {bound['value_bytes_read']} of {bound['value_bytes_all']})"
                + (f"; plan {plan['plan']}" if plan else ""))
    return results


def phase_backward_kernels(n: int = 5, is_3d: bool = False, shapes=FLAGSHIP_SHAPES) -> dict:
    """The backward kernel (through its autograd function, as the model
    calls it) against autograd through the plain version at the training
    step's MSDA call shapes (b = 1 clip of 5 frames: N = 5): 2D at the
    encoder, FTF and decoder shapes; 3D at the encoder and decoder shapes,
    also at N = 10 (two clips, taps crossing from one into the other). f32
    and bf16 value. Returns per-shape numbers."""
    import torch

    from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_3d_plain, ms_deform_attn_plain
    from tce_rvos_tpu_torch.ops.msda_cuda import (
        ms_deform_attn,
        ms_deform_attn_3d,
        msda3d_backward,
        msda_backward,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3 if is_3d else 1)
    s = sum(h * w for h, w in shapes)
    op, plain, backward = ((ms_deform_attn_3d, ms_deform_attn_3d_plain, msda3d_backward) if is_3d
                           else (ms_deform_attn, ms_deform_attn_plain, msda_backward))
    kname = "msda3d_bwd" if is_3d else "msda_bwd"
    cases = [("encoder", s)] + ([] if is_3d else [("ftf", 8)]) + [("decoder", 5)]
    results = {}
    for name, q in cases:
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{name}/{dtype_name(dtype)}"
            label = f"{kname} {key} N={n} Q={q}"
            value, loc, attn = msda_inputs(name, n, q, dtype, gen, dev, frames=is_3d,
                                           shapes=shapes)
            g = torch.randn(n, q, M * D, generator=gen).to(device=dev, dtype=dtype)
            plan = {} if is_3d else {"plan": hold_plan(True, label, value, shapes, loc)}
            errs = hold_backward(op, plain, label, value, shapes, loc, attn, g)
            ms = graph_ms(lambda: backward(value, shapes, loc, attn, g))
            ins = [t.detach().clone().requires_grad_(True) for t in (value, loc, attn)]
            out = plain(ins[0], shapes, ins[1], ins[2])
            plain_ms = cuda_ms(lambda: torch.autograd.grad(out, ins, g, retain_graph=True), reps=5)
            bound = msda_bwd_bound(value, loc, attn, g, shapes)
            results[key] = dict(N=n, Q=q, max_abs_err=max(errs.values()), errors=errs, ms=ms,
                                plain_ms=plain_ms, library_ms=None, levels=shapes, **plan, **bound)
            log(f"[kernels] {kname} {key:18s} N={n} Q={q}: max|err| " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs.items())
                + f"; kernel {ms:.4f} ms  plain (autograd) {plain_ms:.4f} ms  bound "
                f"{bound['bound_ms']:.5f} ms ({bound['bound_by']}; {bound['bytes']} bytes, "
                f"{bound['ops']} ops, value {bound['value_bytes_read']} of "
                f"{bound['value_bytes_all']}); library: none"
                + (f"; plan {plan['plan']}" if plan else ""))
    return results


def edge_cases(dtype, gen, dev):
    """2D inputs whose results must not rest on the encoder's layout
    (name, level shapes, value, loc, attn, whether the kernels take the
    staged path): a query count that no block run divides; the encoder's
    queries in shuffled order; offsets of about 25 pixels, far outside the
    staged levels and any window; point 1 of every head and level at
    x = -1 (first half of the queries) or y = -1 (second half), beside the
    pixel-centre point 0; and L = 3 levels with P = 2 points (the runtime
    loop), at the encoder and decoder shapes."""
    import torch

    s = sum(h * w for h, w in FLAGSHIP_SHAPES)
    n = 3
    value, loc, attn = msda_inputs("encoder", n, s, dtype, gen, dev)
    q = s - 37
    yield "ragged", FLAGSHIP_SHAPES, value, loc[:, :q].contiguous(), attn[:, :q].contiguous(), 1
    perm = torch.randperm(s, generator=gen).to(dev)
    yield "shuffled", FLAGSHIP_SHAPES, value, loc[:, perm].contiguous(), attn[:, perm].contiguous(), 1
    yield ("far", FLAGSHIP_SHAPES, *msda_inputs("encoder", n, s, dtype, gen, dev, spread=25.0), 1)
    edge = loc.clone()
    half = s // 2
    for lvl, (h, w) in enumerate(FLAGSHIP_SHAPES):
        edge[:, :half, :, lvl, 1, 0] = -0.5 / w  # pixel coordinate exactly -1
        edge[:, half:, :, lvl, 1, 1] = -0.5 / h
    yield "x_or_y_at_-1", FLAGSHIP_SHAPES, value, edge, attn, 1
    shapes3 = FLAGSHIP_SHAPES[:3]
    s3 = sum(h * w for h, w in shapes3)
    yield ("L3_P2_encoder", shapes3,
           *msda_inputs("encoder", n, s3, dtype, gen, dev, shapes=shapes3, points=2), 1)
    yield ("L3_P2_decoder", shapes3,
           *msda_inputs("decoder", n, 5, dtype, gen, dev, shapes=shapes3, points=2), 0)


def edge_cases_3d(dtype, gen, dev):
    """3D inputs whose results must not rest on the encoder's layout or on
    where a tap's frames land, as ``edge_cases`` yields them (the 3D kernels
    have one path, so the last item is None; N = 8 frames, so that
    f_im = f * N - 0.5 is exact at the chosen f): a ragged query count;
    shuffled queries; offsets of about 25 pixels and 6 frames; x = -1 or
    y = -1; point 2 at f_im exactly -1 (first half of the queries) or N - 1
    (second half); points 2 and 3 on integer frames other than the own one
    and halfway between two frames (points 0 and 1 of every case are on the
    own frame and halfway); points 2 and 3 past the first and the last
    frame, partly (one frame inside) or wholly; N = 1; L = 3 with P = 2 at
    the encoder and decoder shapes."""
    import torch

    s = sum(h * w for h, w in FLAGSHIP_SHAPES)
    n = 8
    value, loc, attn = msda_inputs("encoder", n, s, dtype, gen, dev, frames=True)
    q = s - 37
    yield "ragged", FLAGSHIP_SHAPES, value, loc[:, :q].contiguous(), attn[:, :q].contiguous(), None
    perm = torch.randperm(s, generator=gen).to(dev)
    yield ("shuffled", FLAGSHIP_SHAPES, value, loc[:, perm].contiguous(),
           attn[:, perm].contiguous(), None)
    yield ("far", FLAGSHIP_SHAPES, *msda_inputs("encoder", n, s, dtype, gen, dev, frames=True,
                                                spread=25.0, frame_spread=6.0), None)
    half = s // 2
    edge = loc.clone()
    for lvl, (h, w) in enumerate(FLAGSHIP_SHAPES):
        edge[:, :half, :, lvl, 1, 0] = -0.5 / w  # pixel coordinate exactly -1
        edge[:, half:, :, lvl, 1, 1] = -0.5 / h
    yield "x_or_y_at_-1", FLAGSHIP_SHAPES, value, edge, attn, None
    edge = loc.clone()
    edge[:, :half, :, :, 2, 2] = -0.5 / n         # f_im exactly -1
    edge[:, half:, :, :, 2, 2] = (n - 0.5) / n    # f_im exactly N - 1
    yield "f_at_-1_and_N-1", FLAGSHIP_SHAPES, value, edge, attn, None
    edge = loc.clone()
    shape = edge.shape[:4]
    edge[..., 2, 2] = ((torch.randint(0, n, shape, generator=gen).float() + 0.5) / n).to(dev)
    edge[..., 3, 2] = (torch.randint(1, n, shape, generator=gen).float() / n).to(dev)
    yield "integer_and_halfway_frames", FLAGSHIP_SHAPES, value, edge, attn, None
    edge = loc.clone()
    edge[..., 2, 2] = (torch.rand(shape, generator=gen) * -0.4 - 0.05).to(dev)  # f_im -4.1..-0.9
    edge[..., 3, 2] = (torch.rand(shape, generator=gen) * 0.4 + 1.0).to(dev)    # f_im 7.5..10.7
    yield "past_both_ends", FLAGSHIP_SHAPES, value, edge, attn, None
    yield "N1", FLAGSHIP_SHAPES, *msda_inputs("encoder", 1, s, dtype, gen, dev, frames=True), None
    shapes3 = FLAGSHIP_SHAPES[:3]
    s3 = sum(h * w for h, w in shapes3)
    yield ("L3_P2_encoder", shapes3, *msda_inputs("encoder", n, s3, dtype, gen, dev, frames=True,
                                                  shapes=shapes3, points=2), None)
    yield ("L3_P2_decoder", shapes3, *msda_inputs("decoder", n, 5, dtype, gen, dev, frames=True,
                                                  shapes=shapes3, points=2), None)


def phase_edge_kernels() -> dict:
    """The 2D and 3D forward and backward kernels against the plain version
    (and autograd through it) on ``edge_cases`` and ``edge_cases_3d``, f32
    and bf16, at phase 2's tolerances, each 2D case on the path it names
    (the launch plan is held against its mirror). Returns the largest
    errors."""
    import torch

    from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_3d_plain, ms_deform_attn_plain
    from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn, ms_deform_attn_3d

    dev = torch.device("cuda")
    results = {}
    for dim, cases, op, plain in (("2d", edge_cases, ms_deform_attn, ms_deform_attn_plain),
                                  ("3d", edge_cases_3d, ms_deform_attn_3d,
                                   ms_deform_attn_3d_plain)):
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator().manual_seed(5)
            for name, shapes, value, loc, attn, staged in cases(dtype, gen, dev):
                label = (f"[edge {dim}] {name} {dtype_name(dtype)} N={value.shape[0]} "
                         f"Q={loc.shape[1]}")
                if staged is not None:  # the 2D kernels' path
                    for backward in (False, True):
                        plan = hold_plan(backward, label, value, shapes, loc)
                        if plan["staged"] != staged:
                            raise AssertionError(f"{label}: {'backward' if backward else 'forward'}"
                                                 f" plan {plan}, expected staged={staged}")
                _, fwd = hold_forward(op, plain, label, value, shapes, loc, attn)
                g = torch.randn(*loc.shape[:2], M * D, generator=gen).to(device=dev, dtype=dtype)
                bwd = hold_backward(op, plain, label, value, shapes, loc, attn, g)
                results[f"{dim}/{name}/{dtype_name(dtype)}"] = dict(forward=fwd, **bwd)
                path = {None: "one", 0: "flat", 1: "staged"}[staged]
                log(f"{label}: {path} path; max |err| forward "
                    f"{fwd:.3e}, " + ", ".join(f"{k} {v:.3e}" for k, v in bwd.items()))
    return results


AB_DIR = "build/ab"  # git-ignored: other builds of the kernels' entry points, if any
# the file-name prefix of another build in AB_DIR -> (3D?, backward?)
AB_PREFIXES = {"fwd_": (False, False), "bwd_": (False, True), "fwd3d_": (True, False),
               "bwd3d_": (True, True)}


def own_pixel(loc):
    """Encoder-call locations with every tap moved onto the query's own
    reference point (the same at every head, level and point), and in 3D
    onto its own frame: the most local gathers the call can make."""
    import torch

    ref = pixel_grid().to(loc.device)[None, :, None, None, None, :].expand(*loc.shape[:-1], 2)
    return torch.cat([ref, own_frame(loc)[..., 2:]], -1) if loc.shape[-1] == 3 else ref.contiguous()


def own_frame(loc):
    """3D locations with every tap's frame coordinate on the query's own
    frame (zero temporal offset: one frame a tap, as at the model's init)."""
    out = loc.clone()
    out[..., 2] = own_frames(loc.shape[0], loc.dim() - 1).to(loc.device)
    return out


def near_frame(loc, gen):
    """3D locations with every tap's f_im within one frame of the query's
    own frame (uniform in (-1, 1) frames off it): two frames a tap, one of
    them the own frame, as ``temporal_taps`` finds the model's taps with
    ``random_state_dict`` weights."""
    import torch

    n = loc.shape[0]
    out = loc.clone()
    off = (torch.rand(loc.shape[:-1], generator=gen) * 2 - 1) / n
    out[..., 2] = (own_frames(n, loc.dim() - 1) + off).to(loc.device)
    return out


def phase_ab(ab_dir: str = AB_DIR, rounds: int = 3) -> dict:
    """The package's MSDA kernels against other builds of the same C entry
    points, in bf16 at the trunk's calls (forward N = 20 as serving at
    E = 4, backward N = 5 as training; ``msda_inputs``' seeded data), by
    device time (``graph_ms``) taken in turns: each round runs the package
    kernel, then every other build, then the same in reverse, and a build's
    time is the median of its readings. ``ab_dir`` holds the other builds'
    sources, named by ``AB_PREFIXES`` (``fwd_*.cu`` with ``tce_msda_fwd``,
    ``bwd_*.cu`` with ``tce_msda_bwd``, ``fwd3d_*.cu`` with
    ``tce_msda3d_fwd``, ``bwd3d_*.cu`` with ``tce_msda3d_bwd``; e.g. an
    earlier version's sources, from git), built in parallel; without it only
    the package kernels are timed. At the 2D encoder call every build also
    runs on ``own_pixel`` locations; at the 3D encoder call on
    ``frame_coords`` taps, ``near_frame`` taps, ``own_frame`` taps and
    ``own_pixel`` taps (own frame and pixel). Each build's largest
    difference from the plain version (backward: from autograd through it)
    is printed, not held: phase 2 holds the package kernels."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import torch

    from tce_rvos_tpu_torch.ops import _build
    from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_3d_plain, ms_deform_attn_plain
    from tce_rvos_tpu_torch.ops.msda_cuda import (
        _bwd_kernel,
        _fwd_kernel,
        bind,
        launch_backward,
        launch_forward,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    s = sum(h * w for h, w in FLAGSHIP_SHAPES)
    root = Path(__file__).resolve().parent / ab_dir
    sources = sorted(root.glob("*_*.cu")) if root.is_dir() else []
    with ThreadPoolExecutor(max(1, len(sources))) as pool:
        for src, so in zip(sources, pool.map(_build.build, sources)):
            log_build("[ab]", src.name, so)
    results = {}
    for is_3d, backward, n in ((False, False, 20), (False, True, 5), (True, False, 20),
                               (True, True, 5)):
        kname = f"msda{'3d' if is_3d else ''}_{'bwd' if backward else 'fwd'}"
        plain = ms_deform_attn_3d_plain if is_3d else ms_deform_attn_plain
        calls = (("encoder", s), ("decoder", 5)) if is_3d else (("encoder", s), ("ftf", 8),
                                                                ("decoder", 5))
        for call, q in calls:
            value, loc, attn = msda_inputs(call, n, q, torch.bfloat16, gen, dev, frames=is_3d)
            g = torch.randn(n, q, M * D, generator=gen).to(device=dev, dtype=torch.bfloat16)
            kernels = {"package": _bwd_kernel(is_3d) if backward else _fwd_kernel(is_3d)}
            for src in sources:
                prefix = src.name[:src.name.index("_") + 1]
                if AB_PREFIXES.get(prefix) == (is_3d, backward):
                    kernels[src.stem] = bind(src, backward, is_3d)
            inputs = {"": loc}
            if call == "encoder":
                inputs = ({"": loc, "/near_frame": near_frame(loc, gen),
                           "/own_frame": own_frame(loc), "/own_pixel": own_pixel(loc)}
                          if is_3d else {"": loc, "/own_pixel": own_pixel(loc)})
            builds = {f"{k}{tag}": (fn, lc) for tag, lc in inputs.items()
                      for k, fn in kernels.items()}
            if backward:
                ins = [t.detach().clone().requires_grad_(True) for t in (value, loc, attn)]
                want = torch.autograd.grad(plain(ins[0], FLAGSHIP_SHAPES, ins[1], ins[2]), ins, g)
            else:
                want = plain(value, FLAGSHIP_SHAPES, loc, attn)
            runs, errs = {}, {}
            for name, (fn, lc) in builds.items():
                if backward:
                    runs[name] = lambda fn=fn, lc=lc: launch_backward(
                        fn, kname, value, FLAGSHIP_SHAPES, lc, attn, g)
                else:
                    runs[name] = lambda fn=fn, lc=lc: launch_forward(
                        fn, kname, value, FLAGSHIP_SHAPES, lc, attn)
                if lc is loc:
                    got = runs[name]()
                    torch.cuda.synchronize()
                    pairs = zip(got, want) if backward else [(got, want)]
                    errs[name] = [float((a.float() - b.float()).abs().max()) for a, b in pairs]
            order = list(runs) + list(runs)[::-1]
            times = {k: [] for k in runs}
            for _ in range(rounds):
                for name in order:
                    times[name].append(graph_ms(runs[name]))
            key = f"{'3d_' if is_3d else ''}{'backward' if backward else 'forward'}/{call}"
            results[key] = {}
            for name, ts in times.items():
                ms = statistics.median(ts)
                results[key][name] = dict(ms=ms, readings=ts, max_abs_err=errs.get(name))
                log(f"[ab] {kname} {call} N={n} Q={q} bf16 {name:26s} {ms:.4f} ms (readings "
                    + ", ".join(f"{t:.4f}" for t in ts) + ")"
                    + ("" if name not in errs else "; max |err| against plain "
                       + ", ".join(f"{e:.3e}" for e in errs[name])))
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


def temporal_taps(engine, feats, mask, sizes, e: int = 4) -> dict:
    """Where the 3D encoder's taps land in time, in one trunk forward at E
    expressions (N = 5E frames): forward hooks on each encoder layer's 3D
    ``MSDeformAttn`` (its ``sampling_offsets``) rebuild every tap's f_im as
    the module does, and this counts the shares of taps whose f_im is the
    query's own frame exactly, within 1 or 2 frames of it, or farther, and
    of those that lie partly or wholly outside [0, N - 1]. A reading for the
    staging choice of the 3D kernels, not held."""
    import torch

    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    counts = dict(exact=0, within_1=0, within_2=0, farther=0, outside=0, taps=0)

    def hook(module, inputs, out):
        n, q = inputs[0].shape[:2]
        parent = layers[module]
        off = out.reshape(n, q, parent.n_heads, parent.n_levels, parent.n_points, 3)[..., 2]
        ref_f = (torch.arange(n, dtype=torch.float32, device=out.device) + 0.5) / n
        f_im = ((ref_f[:, None, None, None, None] + off / n).float() * n - 0.5)
        dist = (f_im - torch.arange(n, device=out.device)[:, None, None, None, None]).abs()
        counts["exact"] += int((dist == 0).sum())
        counts["within_1"] += int(((dist > 0) & (dist <= 1)).sum())
        counts["within_2"] += int(((dist > 1) & (dist <= 2)).sum())
        counts["farther"] += int((dist > 2).sum())
        counts["outside"] += int(((f_im < 0) | (f_im > n - 1)).sum())
        counts["taps"] += f_im.numel()

    layers = {layer.self_attn.sampling_offsets: layer.self_attn
              for layer in engine.model.transformer.encoder.layers}
    handles = [lin.register_forward_hook(hook) for lin in layers]
    ids, attn = tokenize([CAPTIONS[i % len(CAPTIONS)] for i in range(e)])
    try:
        engine.trunk(feats, mask, ids, attn, sizes)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    shares = {k: v / counts["taps"] for k, v in counts.items() if k != "taps"}
    log(f"[path 3d bfloat16] temporal taps of the 3D encoder, trunk E={e} (N={5 * e}), "
        f"{counts['taps']} taps: " + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
        + " (own frame exact / within 1 / within 2 / farther; outside: partly or wholly "
          "outside [0, N - 1])")
    return dict(shares, taps=counts["taps"])


def phase_path_3d(sd3, frames) -> dict:
    """The temporal-MSDA flagship (``--msda_3d``) serving path in bf16:
    run_video_batch (E = 4, two 5-frame windows) through the kernels, with
    8 3D and 4 2D MSDA forward launches per trunk forward; shapes,
    finiteness, boxes in [0, 1]; times, peak memory and the trunk's stage
    breakdown. The 3D op takes the
    whole batch axis (E x 5 frames) as time, as in the JAX package, so
    expressions are not isolated from each other and batched masks need not
    equal serial ones: their gap is printed as a reading, not held."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.infer import InferenceEngine
    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    cfg = flagship_config(msda_3d=True, compute_dtype="bfloat16")
    engine = InferenceEngine(cfg, sd3, device="cuda")
    label = "[path 3d bfloat16]"
    n_windows = -(-N_FRAMES // engine.window)
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = engine.run_video_batch(frames, list(CAPTIONS), exp_batch=len(CAPTIONS))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    want = {"msda_fwd": 4 * n_windows, "msda_bwd": 0, "msda3d_fwd": 8 * n_windows,
            "msda3d_bwd": 0}
    if counts != want:
        raise AssertionError(f"{label} MSDA launches {counts}, expected {want} (8 3D and 4 2D "
                             f"forward launches per trunk forward x {n_windows})")
    check_outputs(outs, label)
    log(f"{label} run_video_batch E={len(CAPTIONS)}, {n_windows} windows: outputs ok, "
        f"launches {counts} (8 msda3d_fwd + 4 msda_fwd per trunk forward x {n_windows}), "
        f"first call {first_s:.3f} s")
    gaps = [mask_gap(outs[e]["pred_masks"], engine.run_video(frames, cap)["pred_masks"])
            for e, cap in enumerate(CAPTIONS)]
    log(f"{label} batched (E = 4) against serial (E = 1) masks, a reading (the 3D op's time "
        f"axis spans the expressions of a batch): relative RMS "
        + ", ".join(f"{g[0]:.3e}" for g in gaps) + "; share of pixels whose mask differs "
        + ", ".join(f"{g[1]:.3e}" for g in gaps))

    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.run_video_batch(frames, list(CAPTIONS), exp_batch=len(CAPTIONS))
    torch.cuda.synchronize()
    serve_s = (time.perf_counter() - t0) / reps
    serve_rate = len(CAPTIONS) * n_windows / serve_s
    video, mask, size = engine.preprocess(frames[:engine.window])
    sizes = torch.tensor([size], device="cuda")
    feats = engine.backbone(video, mask)
    taps = temporal_taps(engine, feats, mask, sizes)
    trunk = {}
    for e in (1, 4):
        ids, attn = tokenize([CAPTIONS[i % len(CAPTIONS)] for i in range(e)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = cuda_ms(lambda: engine.trunk(feats, mask, ids, attn, sizes), reps=10)
        peak = torch.cuda.max_memory_allocated()
        trunk[e] = dict(ms=ms, peak_gib=peak / 2**30, peak_above_resident_gib=(peak - base) / 2**30)
        log(f"{label} trunk E={e}: {ms:.3f} ms/forward, max_memory_allocated "
            f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the resident "
            f"weights and features)")
    breakdown = stage_breakdown(engine, feats, mask, sizes, label)
    log(f"{label} run_video_batch E={len(CAPTIONS)}: {serve_s * 1e3:.3f} ms for {n_windows} "
        f"windows = {serve_rate:.2f} expression-windows/s")
    del engine
    torch.cuda.empty_cache()
    return dict(launches=counts, first_call_s=first_s, batched_vs_serial=gaps, trunk=trunk,
                serve_ms=serve_s * 1e3, expression_windows_per_s=serve_rate, breakdown=breakdown,
                temporal_taps=taps)


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

    prof = profile_device(lambda: engine.trunk(feats, mask, ids, attn, sizes),
                          f"{label} profiled trunk forward")
    return {"total_ms": total, "stages_ms": ms, **prof}


def profile_device(fn, label: str, top: int = 12, host_top: int = 0) -> dict:
    """One call of ``fn`` under torch.profiler: its wall time (CUDA events),
    the device's busy time (the sum of device-side kernel times), the top
    device ops, the number of device ops, and with ``host_top`` the top
    host ops by their own CPU time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
    wall = a.elapsed_time(b)

    def dev_us(evt):
        return getattr(evt, "self_device_time_total", None) or getattr(
            evt, "self_cuda_time_total", 0)

    # device-side entries only: a CPU op's self device time repeats the
    # time of the kernels it launched, and a user annotation's device span
    # (the optimizer step's) that of the kernels inside it
    kernels = sorted(((dev_us(evt), evt.key, evt.count) for evt in prof.key_averages()
                      if str(evt.device_type).endswith("CUDA") and dev_us(evt) > 0
                      and not getattr(evt, "is_user_annotation", False)),
                     reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    n_ops = sum(k[2] for k in kernels)
    if busy_ms == 0:
        log(f"{label}: the profiler saw no device time")
    else:
        log(f"{label}: wall {wall:.3f} ms, device busy {busy_ms:.3f} ms "
            f"({100.0 * busy_ms / wall:.1f}%) in {n_ops} device ops; top device ops:")
        for us, key, count in kernels[:top]:
            log(f"{label}   {us / 1e3:9.3f} ms  x{count:<5d} {key[:100]}")
        for kname in ("msda_fwd_kernel", "msda_bwd_kernel", "msda3d_fwd_kernel",
                      "msda3d_bwd_kernel"):  # every instantiation of each
            mine = [(us, count) for us, key, count in kernels if f"{kname}<" in key]
            if mine:
                log(f"{label}   {kname}: {sum(u for u, _ in mine) / 1e3:.3f} ms in "
                    f"{sum(c for _, c in mine)} launches")
    host = sorted(((evt.self_cpu_time_total, evt.key, evt.count) for evt in prof.key_averages()
                   if not str(evt.device_type).endswith("CUDA")), reverse=True)
    if host_top:
        log(f"{label}: host ops, own CPU time {sum(h[0] for h in host) / 1e3:.3f} ms in all; "
            f"top {host_top}:")
        for us, key, count in host[:host_top]:
            log(f"{label}   {us / 1e3:9.3f} ms  x{count:<5d} {key[:100]}")
    return {"profiled_wall_ms": wall, "device_busy_ms": busy_ms, "device_ops": n_ops,
            "top_ops": [(key[:100], us / 1e3, count) for us, key, count in kernels[:top]],
            "top_host_ops": [(key[:100], us / 1e3, count) for us, key, count in host[:host_top]]}


def phase_parity(sd, frames, msda_3d: bool = False) -> None:
    """One window, f32 with TF32 off: the GPU path (MSDA kernels) against
    the same weights on the CPU (plain MSDA); E = 1 for the flagship, E = 2
    for ``--msda_3d`` (10 frames on the batch axis, so temporal taps cross
    from one expression into the other on both devices). Tolerance: rtol
    2e-3 plus 2e-3 of each output's largest magnitude, the model-level bar
    of the JAX package's parity with the reference; cuDNN/cuBLAS and the CPU
    libraries sum in other orders."""
    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.infer import InferenceEngine
    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    label = "[parity 3d]" if msda_3d else "[parity]"
    cfg = flagship_config(msda_3d=msda_3d)
    ids, attn = tokenize(list(CAPTIONS[:2 if msda_3d else 1]))
    # one trunk forward; the CPU takes the plain versions
    want = ({"msda_fwd": 4, "msda3d_fwd": 8} if msda_3d else {"msda_fwd": 12, "msda3d_fwd": 0})
    outs = {}
    for dev in ("cuda", "cpu"):
        engine = InferenceEngine(cfg, sd, device=dev)
        video, mask, size = engine.preprocess(frames[:engine.window])
        reset_launch_counts()
        t0 = time.perf_counter()
        out = engine.run_window(video, mask, ids, attn, size)
        outs[dev] = {k: v.float().cpu().numpy() for k, v in out.items()}
        secs = time.perf_counter() - t0
        launched = {k: launch_counts()[k] for k in want}
        log(f"{label} {dev}: one window, E={len(ids)}, in {secs:.3f} s, launches {launched}")
        expected = want if dev == "cuda" else {k: 0 for k in want}
        if launched != expected:
            raise AssertionError(f"{label} {dev} run launched the MSDA kernels {launched} "
                                 f"times, expected {expected}")
        del engine
    errs = {}
    for k in ("pred_logits", "pred_boxes", "pred_masks", "reference_points"):
        errs[k] = compare(outs["cuda"][k], outs["cpu"][k], 2e-3, 2e-3, f"{label} {k}")
    log(f"{label} GPU kernel path vs CPU plain path, max |err|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))


# ---------------------------------------------------------------------------
# phases 5-6: the training path
# ---------------------------------------------------------------------------

TRAIN_T, TRAIN_HW = 5, (384, 640)   # the flagship training clip, b = 1
TRAIN_STEPS, TRAIN_STEPS_CKPT, TRAIN_WARMUP = 10, 6, 2
PARITY_T, PARITY_HW = 2, (192, 320)  # small enough for the CPU's f32 step
# Gradients, per parameter, are held two ways against the model's largest
# |grad| g_max: every element within ELEM_TOL x g_max, and, for a tensor
# whose own largest |grad| reaches SIGNIFICANT x g_max, the difference
# within L2_TOL of its norm. A tensor below that (the text encoder's query
# and key weights: their gradients cancel to ~1e-7 of g_max) is rounding
# of the terms that cancel, whose relative error says nothing: two f32
# runs on the card already differ by 1e-2 of such a tensor's norm. A
# gradient that is zero in exact arithmetic (the text encoder's key biases:
# softmax ignores a constant added to a row of logits) is held below
# ZERO_TOL x g_max on both sides.
SIGNIFICANT, ZERO_TOL = 1e-3, 1e-6
# GPU against CPU, one f32 step: losses and the grad norm at rtol 2e-3
# (the model-level bar of the JAX package's parity with the reference);
# gradients at L2 5e-3 and elements at 1e-3 of g_max. cuDNN, cuBLAS and the
# CPU libraries sum in other orders, and on random weights some pre-ReLU
# activations of the backbone lie within f32 rounding of zero, so the two
# devices let a few different elements through: the first reading on an
# H100 was 1.76e-3 of the norm of backbone conv1's gradient and 2.7e-4 of
# g_max on one element of a layer3 conv (PERF.md), as the JAX-against-port
# CPU test reads on the backbone of the tiny model.
PARITY_L2_TOL, PARITY_ELEM_TOL = 5e-3, 1e-3
# with recomputation against without, one f32 step (TF32 off), dropout off:
# the forward is the same; the backward differs only by the order of
# atomic sums (the MSDA backward's d_value, embedding and other library
# backward kernels): two runs without recomputation differ by about 1e-7
# of g_max. Elements at 1e-6 of g_max, gradients at L2 2e-3. (In
# bf16 those reorderings move bf16 roundings, up to 8e-2 of a gradient's
# norm between two runs without recomputation, so a bf16 reading could not
# tell a fault of the recomputation from noise; tests/test_torch_train.py
# holds bf16 with and without recomputation bitwise equal on the CPU,
# where nothing is reordered.)
CKPT_L2_TOL, CKPT_ELEM_TOL = 2e-3, 1e-6


def train_batch(t: int, hw, seed: int) -> dict:
    """One training batch in collate_batch's format, as numpy: b = 1 clip
    of t random frames (as the JAX package's scripts/bench_train_step.py),
    caption 0, label 0, random boxes, random binary masks, every frame
    valid."""
    import numpy as np

    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    rng = np.random.RandomState(seed)
    h, w = hw
    ids, attn = tokenize([CAPTIONS[0]])
    return {"video": rng.randn(1, t, h, w, 3).astype(np.float32),
            "video_mask": np.zeros((1, t, h, w), bool),
            "text_ids": ids, "text_attn_mask": attn,
            "sizes": np.asarray([[h, w]], np.int32),
            "targets": {"labels": np.zeros((1, t), np.int32),
                        "boxes": rng.rand(1, t, 4).astype(np.float32),
                        "masks": (rng.rand(1, t, h, w) > 0.5).astype(np.float32),
                        "valid": np.ones((1, t), np.int32)}}


def zero_in_exact_arithmetic(name: str) -> bool:
    """Parameters whose gradient is zero in exact arithmetic: a key bias
    adds one constant to a query's row of logits, which softmax ignores
    (the packed in_proj_bias of the other attention blocks also holds q and
    v biases, whose gradients are not zero)."""
    return name.endswith("attention.self.key.bias")


def grad_gap(got: dict, want: dict, label: str, l2_tol: float, elem_tol: float) -> dict:
    """Per-parameter gradients ``got`` against ``want`` (name -> float
    tensor on one device), held as the SIGNIFICANT / ZERO_TOL note above
    says. Returns the worst readings."""
    g_max = max(float(w.abs().max()) for w in want.values())
    worst = dict(l2=0.0, l2_param="", elem=0.0, elem_param="", zero=0.0)
    for name, w in want.items():
        g = got[name]
        scale = float(w.abs().max())
        if zero_in_exact_arithmetic(name):
            zero = max(float(g.abs().max()), scale) / g_max
            worst["zero"] = max(worst["zero"], zero)
            if zero >= ZERO_TOL:
                raise AssertionError(f"{label}: the gradient of {name} should be zero; "
                                     f"|grad| reaches {zero:.3e} of the largest")
            continue
        elem = float((g - w).abs().max()) / g_max
        l2 = float((g - w).norm() / w.norm()) if scale >= SIGNIFICANT * g_max else 0.0
        if elem > worst["elem"]:
            worst.update(elem=elem, elem_param=name)
        if l2 > worst["l2"]:
            worst.update(l2=l2, l2_param=name)
        if l2 > l2_tol or elem > elem_tol:
            raise AssertionError(f"{label}: the gradient of {name} differs by {l2:.3e} of its "
                                 f"norm (limit {l2_tol}) and by up to {elem:.3e} of the "
                                 f"model's largest |grad| (limit {elem_tol})")
    log(f"{label}: largest |grad| {g_max:.4e}; worst element {worst['elem']:.3e} of it "
        f"({worst['elem_param']}); worst gap {worst['l2']:.3e} of a gradient's norm "
        f"({worst['l2_param']}); zero gradients below {worst['zero']:.3e} of it")
    return worst


def launch_counts() -> dict:
    """The launch counters of the four MSDA kernels."""
    from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn, ms_deform_attn_3d

    return {"msda_fwd": ms_deform_attn.launches, "msda_bwd": ms_deform_attn.backward_launches,
            "msda3d_fwd": ms_deform_attn_3d.launches,
            "msda3d_bwd": ms_deform_attn_3d.backward_launches}


def reset_launch_counts() -> None:
    from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn, ms_deform_attn_3d

    for op in (ms_deform_attn, ms_deform_attn_3d):
        op.launches = op.backward_launches = 0


def train_run(state, step, batches, label: str, tag: str, warmup: int = TRAIN_WARMUP) -> dict:
    """train_one_epoch over ``batches``, each step timed to its end on the
    device; MSDA launch counts of the run and peak memory."""
    import torch

    from tce_rvos_tpu_torch.engine import train_one_epoch

    times, losses = [], []

    def timed(st, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, metrics = step(st, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        return st, metrics

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    train_one_epoch(state, timed, batches, epoch=0, print_freq=5)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label} {tag}: a loss is not finite: {losses}")
    ms = statistics.median(times[warmup:])
    n_steps = len(batches)
    out = dict(steps=n_steps, ms_per_step=ms, steps_per_s=1e3 / ms, step_ms=times,
               losses=losses, peak_gib=peak / 2**30, launches=counts["msda_fwd"],
               backward_launches=counts["msda_bwd"], launches_3d=counts["msda3d_fwd"],
               backward_launches_3d=counts["msda3d_bwd"],
               mfu=TRAIN_USEFUL_FLOPS_PER_CLIP / (ms / 1e3) / BF16_DENSE_FLOPS_PER_S)
    log(f"{label} {tag}: {n_steps} steps, losses {[round(x, 4) for x in losses]}; "
        f"{ms:.3f} ms/step (median after {warmup} warm-up steps) = "
        f"{out['steps_per_s']:.3f} steps/s; max_memory_allocated {out['peak_gib']:.3f} GiB; "
        f"MSDA launches forward {counts['msda_fwd']}, backward {counts['msda_bwd']}, "
        f"3D forward {counts['msda3d_fwd']}, 3D backward {counts['msda3d_bwd']}; "
        f"MFU {100 * out['mfu']:.2f}% (useful FLOPs {TRAIN_USEFUL_FLOPS_PER_CLIP:.4e} per clip "
        f"from the JAX package's count of the 2D flagship, over the H100 SXM bf16 dense peak "
        f"of 989 TFLOP/s)")
    return out


def phase_train(sd) -> dict:
    """The flagship training path on the card: train_one_epoch over
    TRAIN_STEPS bf16 steps with dropout, then recomputation (use_checkpoint)
    against none, then steps with recomputation. Returns the numbers."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.config import TrainConfig
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.models.referformer import ReferFormer
    from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn
    from tce_rvos_tpu_torch.parallel.train_step import (
        batch_to_device,
        create_train_state,
        forward_losses,
        make_train_step,
    )

    label = "[train]"
    dev = torch.device("cuda")
    cfg = flagship_config(compute_dtype="bfloat16")
    tcfg = TrainConfig()
    model = ReferFormer(cfg)
    model.load_state_dict(sd, strict=True)
    model.to(dev)  # float32 master weights
    spe = 1000     # an epoch far longer than this run: no LR drop inside it
    state = create_train_state(model, tcfg, steps_per_epoch=spe)
    crit = criterion_from_configs(cfg, tcfg)
    step = make_train_step(crit, cfg.compute_dtype)
    batches = [batch_to_device(train_batch(TRAIN_T, TRAIN_HW, seed=10 + i), dev)
               for i in range(TRAIN_STEPS)]
    start = {n: p.detach().clone() for n, p in model.named_parameters()}

    def run(n_steps: int, tag: str) -> dict:
        return train_run(state, step, batches[:n_steps], label, tag)

    result = {"plain": run(TRAIN_STEPS, "bf16 train_one_epoch, no recomputation")}
    if (result["plain"]["launches"], result["plain"]["backward_launches"]) != (
            12 * TRAIN_STEPS, 12 * TRAIN_STEPS):
        raise AssertionError(f"{label} MSDA launches {result['plain']['launches']} forward / "
                             f"{result['plain']['backward_launches']} backward, expected 12 + 12 "
                             f"per step x {TRAIN_STEPS}")
    for name in ("transformer.encoder.layers.0.self_attn.value_proj.weight",
                 "transformer.encoder.layers.0.self_attn.sampling_offsets.weight"):
        grad = model.get_parameter(name).grad
        if grad is None or float(grad.abs().max()) == 0.0:
            raise AssertionError(f"{label} {name} has no gradient: MSDA's backward is not wired")
    no_grad = [n for n, p in model.named_parameters() if not zero_in_exact_arithmetic(n)
               and (p.grad is None or float(p.grad.abs().max()) == 0.0)]
    still = [n for n, p in model.named_parameters() if not zero_in_exact_arithmetic(n)
             and torch.equal(p.detach(), start[n])]
    if no_grad or still:
        raise AssertionError(f"{label} parameters without a gradient: {no_grad}; "
                             f"parameters that did not move: {still}")
    n_params = sum(1 for _ in model.parameters())
    log(f"{label} all {n_params} parameters have a non-zero gradient and moved (the text "
        f"encoder's key biases, zero in exact arithmetic, aside), value_proj and "
        f"sampling_offsets of encoder layer 0 included")
    del start

    result["profile"] = profile_device(lambda: step(state, batches[0]),
                                       f"{label} profiled bf16 train step (no recomputation)",
                                       host_top=12)

    # recomputation against none: one f32 step's gradients from the same
    # state, dropout off; a second run without recomputation reads the noise
    model.eval()

    def grads_of(ckpt: bool):
        model.transformer.use_checkpoint = ckpt
        model.zero_grad(set_to_none=True)
        ms_deform_attn.launches = ms_deform_attn.backward_launches = 0
        total, _ = forward_losses(model, batches[0], crit, "float32")
        total.backward()
        torch.cuda.synchronize()
        counts = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
        return (float(total.detach()),
                {n: p.grad.float().clone() for n, p in model.named_parameters()}, counts)

    loss0, g0, c0 = grads_of(False)
    loss_n, g_n, _ = grads_of(False)
    loss1, g1, c1 = grads_of(True)
    if c0 != (12, 12) or c1 != (24, 12):
        raise AssertionError(f"{label} MSDA launches (forward, backward) per step: {c0} without "
                             f"recomputation (expected (12, 12)), {c1} with (expected (24, 12))")
    if not (loss0 == loss_n == loss1):
        raise AssertionError(f"{label} the loss with dropout off changed: {loss0}, {loss_n}, {loss1}")
    noise = grad_gap(g_n, g0, f"{label} f32 run-to-run, no recomputation",
                     l2_tol=math.inf, elem_tol=math.inf)
    gap = grad_gap(g1, g0, f"{label} f32 recomputation against none",
                   l2_tol=CKPT_L2_TOL, elem_tol=CKPT_ELEM_TOL)
    log(f"{label} MSDA launches per f32 step: {c0[0]} forward + {c0[1]} backward without "
        f"recomputation, {c1[0]} + {c1[1]} with")
    del g0, g_n, g1
    result.update(ckpt_gap=gap, noise_gap=noise, launches_per_step=c0, launches_per_step_ckpt=c1)

    model.transformer.use_checkpoint = True
    result["ckpt"] = run(TRAIN_STEPS_CKPT, "bf16 train_one_epoch, with recomputation")
    if (result["ckpt"]["launches"], result["ckpt"]["backward_launches"]) != (
            24 * TRAIN_STEPS_CKPT, 12 * TRAIN_STEPS_CKPT):
        raise AssertionError(f"{label} with recomputation: MSDA launches "
                             f"{result['ckpt']['launches']} / {result['ckpt']['backward_launches']}")
    del state, model, batches
    torch.cuda.empty_cache()
    return result


TRAIN_STEPS_3D = 4


def phase_train_3d(sd3) -> dict:
    """The temporal-MSDA flagship (``--msda_3d``) training path on the card:
    train_one_epoch over TRAIN_STEPS_3D bf16 steps with dropout (b = 1,
    5x384x640); finite losses, 8 + 8 3D and 4 + 4 2D MSDA launches per
    step, a non-zero gradient on every trainable parameter, the temporal
    rows (every third) of each 3D ``sampling_offsets.weight`` included, and
    every parameter moved; ms/step and peak memory."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.config import TrainConfig
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.models.referformer import ReferFormer
    from tce_rvos_tpu_torch.models.transformer import MSDeformAttn
    from tce_rvos_tpu_torch.parallel.train_step import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )

    label = "[train 3d]"
    dev = torch.device("cuda")
    cfg = flagship_config(msda_3d=True, compute_dtype="bfloat16")
    tcfg = TrainConfig()
    model = ReferFormer(cfg)
    model.load_state_dict(sd3, strict=True)
    model.to(dev)
    state = create_train_state(model, tcfg, steps_per_epoch=1000)
    step = make_train_step(criterion_from_configs(cfg, tcfg), cfg.compute_dtype)
    batches = [batch_to_device(train_batch(TRAIN_T, TRAIN_HW, seed=30 + i), dev)
               for i in range(TRAIN_STEPS_3D)]
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    result = train_run(state, step, batches, label, "bf16 train_one_epoch", warmup=1)
    per_step = {k: result[k] // TRAIN_STEPS_3D for k in
                ("launches", "backward_launches", "launches_3d", "backward_launches_3d")}
    counts = (result["launches_3d"], result["backward_launches_3d"], result["launches"],
              result["backward_launches"])
    if counts != (8 * TRAIN_STEPS_3D, 8 * TRAIN_STEPS_3D, 4 * TRAIN_STEPS_3D, 4 * TRAIN_STEPS_3D):
        raise AssertionError(f"{label} MSDA launches (3D forward, 3D backward, 2D forward, 2D "
                             f"backward) {counts}, expected 8 + 8 and 4 + 4 per step x "
                             f"{TRAIN_STEPS_3D}")
    no_grad = [n for n, p in model.named_parameters() if not zero_in_exact_arithmetic(n)
               and (p.grad is None or float(p.grad.abs().max()) == 0.0)]
    still = [n for n, p in model.named_parameters() if not zero_in_exact_arithmetic(n)
             and torch.equal(p.detach(), start[n])]
    temporal = {}
    for name, mod in model.named_modules():
        if isinstance(mod, MSDeformAttn) and mod.is_3d:
            g = mod.sampling_offsets.weight.grad.reshape(-1, 3, cfg.hidden_dim)[:, 2]
            temporal[name] = float((g.abs().amax(-1) > 0).float().mean())
    if no_grad or still or len(temporal) != 8 or min(temporal.values()) == 0.0:
        raise AssertionError(f"{label} parameters without a gradient: {no_grad}; parameters "
                             f"that did not move: {still}; share of temporal offset rows with "
                             f"a gradient per 3D module: {temporal}")
    log(f"{label} all {sum(1 for _ in model.parameters())} parameters have a non-zero gradient "
        f"and moved (the text encoder's key biases aside); launches per step {per_step}; share "
        f"of the temporal rows of sampling_offsets.weight with a non-zero gradient, per 3D "
        f"module: " + ", ".join(f"{k.replace('transformer.', '')} {v:.3f}"
                                for k, v in temporal.items()))
    result.update(launches_per_step=per_step, temporal_rows_with_grad=temporal)
    del state, model, batches, start
    torch.cuda.empty_cache()
    return result


def phase_train_parity(sd, msda_3d: bool = False) -> None:
    """One f32 train step (TF32 off, dropout off) from the same weights and
    batch on the GPU (MSDA kernels) and on the CPU (plain MSDA): losses,
    grad norm and every parameter's gradient (before the optimizer, after
    the clip, which scales both by nearly the same factor). For the
    flagship or, with ``msda_3d``, its temporal-MSDA variant."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.config import TrainConfig
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.models.referformer import ReferFormer
    from tce_rvos_tpu_torch.parallel.train_step import create_train_state, make_train_step

    label = "[train parity 3d]" if msda_3d else "[train parity]"
    expected = ({"msda_fwd": 4, "msda_bwd": 4, "msda3d_fwd": 8, "msda3d_bwd": 8} if msda_3d
                else {"msda_fwd": 12, "msda_bwd": 12, "msda3d_fwd": 0, "msda3d_bwd": 0})
    cfg = flagship_config(msda_3d=msda_3d)
    tcfg = TrainConfig()
    batch = train_batch(PARITY_T, PARITY_HW, seed=3)
    metrics, grads = {}, {}
    for dev in ("cuda", "cpu"):
        model = ReferFormer(cfg)
        model.load_state_dict(sd, strict=True)
        model.to(dev).eval()
        state = create_train_state(model, tcfg)
        step = make_train_step(criterion_from_configs(cfg, tcfg))
        reset_launch_counts()
        t0 = time.perf_counter()
        _, m = step(state, batch)
        metrics[dev] = {k: float(v) for k, v in m.items()}
        secs = time.perf_counter() - t0
        launched = launch_counts()
        log(f"{label} {dev}: one f32 step on a {PARITY_T}x{PARITY_HW[0]}x{PARITY_HW[1]} "
            f"clip in {secs:.3f} s, loss {metrics[dev]['loss']:.6f}, MSDA launches {launched}")
        if launched != (expected if dev == "cuda" else {k: 0 for k in expected}):
            raise AssertionError(f"{label} {dev} step launched MSDA kernels {launched}, "
                                 f"expected {expected} on the GPU and none on the CPU")
        grads[dev] = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
        del model, state
    torch.cuda.empty_cache()
    for k, want in metrics["cpu"].items():
        got = metrics["cuda"][k]
        if abs(got - want) > 2e-3 * abs(want) + (2e-3 if k.startswith("loss") else 0.0):
            raise AssertionError(f"{label} {k}: GPU {got} against CPU {want}")
    log(f"{label} GPU against CPU: " + ", ".join(
        f"{k} {metrics['cuda'][k]:.6g}/{metrics['cpu'][k]:.6g}" for k in ("loss", "grad_norm")))
    grad_gap(grads["cuda"], grads["cpu"], f"{label} GPU against CPU",
             l2_tol=PARITY_L2_TOL, elem_tol=PARITY_ELEM_TOL)


def step_gradients(sd, msda_3d: bool, device: str, dtype) -> tuple:
    """One train step's loss and gradients (the phase-6 batch, dropout off,
    no optimizer and no clip) on ``device`` in ``dtype``, with the launches
    of the MSDA kernels it made; gradients as float64 on the CPU. In
    float64 the locations are rounded to f32 as the model passes them, and
    the plain ops compute in float64."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.config import TrainConfig
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.models.referformer import ReferFormer
    from tce_rvos_tpu_torch.parallel.train_step import batch_to_device, forward_losses

    cfg = flagship_config(msda_3d=msda_3d)
    crit = criterion_from_configs(cfg, TrainConfig())
    batch = batch_to_device(train_batch(PARITY_T, PARITY_HW, seed=3), torch.device(device))
    model = ReferFormer(cfg)
    model.load_state_dict(sd, strict=True)
    model.to(device=device, dtype=dtype).eval()
    reset_launch_counts()
    total, _ = forward_losses(model, dict(batch, video=batch["video"].to(dtype)), crit)
    total.backward()
    if device == "cuda":
        torch.cuda.synchronize()
    grads = {n: p.grad.double().cpu() for n, p in model.named_parameters()}
    return float(total), grads, launch_counts()


def phase_train_against_f64(msda_3d: bool = True) -> dict:
    """One f32 train step on the GPU (kernels) and on the CPU (plain MSDA),
    each against the same step in float64 on the CPU, at the weights of
    seeds 0 and 1. How far the CPU's f32 step lies from float64 is a
    reading: on these weights f32 arithmetic itself meets taps within
    rounding of an integer frame, where the 3D op's temporal derivative
    jumps (the right derivative), and two f32 runs may land on either side
    (1.6e-3 of the largest |grad| at seed 0). The GPU's step is held to
    lie no farther from float64 than the CPU's own f32 step does, plus the
    GPU-against-CPU limits (PARITY_L2_TOL of a gradient's norm,
    PARITY_ELEM_TOL of the largest |grad|); its loss within 2e-3 relative
    of float64's plus the CPU's own gap."""
    import torch

    from tce_rvos_tpu_torch import flagship_config

    tag = "3d" if msda_3d else "2d"
    expected = ({"msda_fwd": 4, "msda_bwd": 4, "msda3d_fwd": 8, "msda3d_bwd": 8} if msda_3d
                else {"msda_fwd": 12, "msda_bwd": 12, "msda3d_fwd": 0, "msda3d_bwd": 0})
    readings = {}
    for seed in (0, 1):
        label = f"[train vs f64 {tag}, weights of seed {seed}]"
        sd = random_state_dict(flagship_config(msda_3d=msda_3d), seed=seed)
        runs = {}
        for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                           ("cpu", torch.float64)):
            t0 = time.perf_counter()
            runs[(dev, dtype)] = step_gradients(sd, msda_3d, dev, dtype)
            launched = runs[(dev, dtype)][2]
            want = expected if dev == "cuda" else {k: 0 for k in expected}
            if launched != want:
                raise AssertionError(f"{label} {dev} {dtype} step launched MSDA kernels "
                                     f"{launched}, expected {want}")
            log(f"{label} {dev} {dtype_name(dtype)}: loss {runs[(dev, dtype)][0]:.9f} in "
                f"{time.perf_counter() - t0:.3f} s, launches {launched}")
        del sd
        torch.cuda.empty_cache()
        loss64, g64, _ = runs[("cpu", torch.float64)]
        loss_cpu, g_cpu, _ = runs[("cpu", torch.float32)]
        loss_gpu, g_gpu, _ = runs[("cuda", torch.float32)]
        cpu = grad_gap(g_cpu, g64, f"{label} CPU f32 against f64, a reading",
                       l2_tol=math.inf, elem_tol=math.inf)
        gpu = grad_gap(g_gpu, g64, f"{label} GPU f32 against f64", l2_tol=PARITY_L2_TOL + cpu["l2"],
                       elem_tol=PARITY_ELEM_TOL + cpu["elem"])
        loss_limit = 2e-3 * abs(loss64) + abs(loss_cpu - loss64)
        if abs(loss_gpu - loss64) > loss_limit:
            raise AssertionError(f"{label} GPU f32 loss {loss_gpu} against f64 {loss64}: "
                                 f"limit {loss_limit}")
        log(f"{label} held: the GPU's f32 step lies {gpu['elem']:.3e} of the largest |grad| "
            f"from f64 (limit {PARITY_ELEM_TOL} + the CPU's {cpu['elem']:.3e}) and "
            f"{gpu['l2']:.3e} of a gradient's norm (limit {PARITY_L2_TOL} + {cpu['l2']:.3e}); "
            f"loss gaps GPU {abs(loss_gpu - loss64):.3e}, CPU {abs(loss_cpu - loss64):.3e}")
        readings[seed] = dict(cpu=cpu, gpu=gpu)
    return readings


# ---------------------------------------------------------------------------
# phase 9: the memory envelope and the inference protocols
# ---------------------------------------------------------------------------

# (E, T) points of the envelope fit per compute dtype: E x T frames from 5 to
# 160 in bf16 (the whole-video dispatch of 4 expressions x 40 frames), to 80
# in f32
ENVELOPE_POINTS = {"bfloat16": ((1, 5), (2, 10), (4, 20), (8, 20), (4, 40)),
                   "float32": ((1, 5), (2, 10), (4, 20), (2, 40))}


def phase_envelope(sd, frames, hold: bool = True) -> dict:
    """Peak memory (``max_memory_allocated`` less what was allocated before
    the engine was built; the weights and the window's backbone features
    resident) of one trunk forward at 384x640 at the
    (E, T) points of ENVELOPE_POINTS, per compute dtype; the least-squares
    line peak = base + per_frame x E x T and its largest residual, printed
    for ``infer._ENVELOPE_GIB``. ``hold``: every measured point must lie on
    or under the line of ``infer._ENVELOPE_GIB``, so that the cap it gives
    (``trunk_frame_envelope``) keeps each measured dispatch within the
    card's memory."""
    import numpy as np
    import torch

    from tce_rvos_tpu_torch import flagship_config, infer
    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    total_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    fits = {}
    for name, points in ENVELOPE_POINTS.items():
        label = f"[envelope {name}]"
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated() / 2**30  # left by earlier phases
        engine = infer.InferenceEngine(flagship_config(compute_dtype=name), sd, device="cuda")
        rows = []
        for e, t in points:
            video, mask, size = engine.preprocess([frames[i % len(frames)] for i in range(t)])
            sizes = torch.tensor([size], device=engine.device)
            feats = engine.backbone(video, mask)
            ids, attn = tokenize([CAPTIONS[i % len(CAPTIONS)] for i in range(e)])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = engine.trunk(feats, mask, ids, attn, sizes)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30 - before
            del out, feats, video, mask
            rows.append((e, t, peak))
            log(f"{label} E={e} T={t} (E*T={e * t}): trunk forward peak {peak:.4f} GiB")
        del engine
        torch.cuda.empty_cache()
        x = np.array([e * t for e, t, _ in rows], np.float64)
        y = np.array([peak for _, _, peak in rows], np.float64)
        slope, base = np.polyfit(x, y, 1)
        resid = float(np.abs(y - (base + slope * x)).max())
        ship_base, ship_slope = infer._ENVELOPE_GIB[name]
        cap = infer.trunk_frame_envelope((384, 640), name, device="cuda")
        log(f"{label} fit: peak_gib = {base:.4f} + {slope:.5f} x E*T, largest residual "
            f"{resid:.4f} GiB; infer._ENVELOPE_GIB: {ship_base} + {ship_slope} x E*T; cap on this "
            f"card ({total_gib:.2f} GiB): {cap} frames a dispatch, predicted peak "
            f"{ship_base + ship_slope * cap:.3f} GiB")
        over = [(e, t, peak) for e, t, peak in rows if peak > ship_base + ship_slope * e * t]
        if hold and over:
            raise AssertionError(f"{label} measured peaks above infer._ENVELOPE_GIB's line: {over}")
        fits[name] = dict(points=rows, base=float(base), per_frame=float(slope), resid=resid,
                          cap_frames=cap, total_gib=total_gib)
    return fits


PROTO_HW = (720, 1280)  # frames as stored: downscaled to 360x640 by the engine
PROTO_YTVOS = {"v12": (12, CAPTIONS[:2]), "v36": (36, CAPTIONS)}  # whole-video buckets 16, 40
PROTO_DAVIS = {"d20": (20, [f"{c} {a}" for c in ("the dog", "the horse")
                            for a in ("left", "running", "in front", "near the fence")])}
PROTO_MEVIS = {"m10": (10, CAPTIONS[:3])}
PROTO_SMALL = {"v6": (6, CAPTIONS[:2])}  # windows of 5 with a context frame a side


def write_tree(root: str, kind: str, videos: dict, test_only: dict = None, seed: int = 0,
               absent: dict = None) -> str:
    """A synthetic dataset on disk in the ``kind`` layout: smooth random JPEG
    frames at PROTO_HW and meta_expressions. ytvos, davis, mevis: the valid
    split; ``test_only`` videos are listed in the valid split and in the test
    split (so ytvos must skip them). train: the Ref-YouTube-VOS train split,
    captions given as (expression, object id), with meta.json (object 1 a
    person, 2 a dog) and palette PNG annotations of the two objects moving;
    object 2 leaves the frames ``absent[video]``."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    h, w = PROTO_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    split = "train" if kind == "train" else "valid"
    palette = [c for i in range(256) for c in (i, i, i)]
    meta = {}
    for video, (n, caps) in {**videos, **(test_only or {})}.items():
        d = os.path.join(root, split, "JPEGImages", video)
        os.makedirs(d)
        names = [f"{i:05d}" for i in range(n)]
        for i, name in enumerate(names):
            f = np.stack([0.5 + 0.5 * np.sin((xx * a + yy * b) / 80.0 + c)
                          for a, b, c in rng.rand(3, 3)], -1)
            Image.fromarray((f * 255).astype(np.uint8)).save(os.path.join(d, name + ".jpg"))
            if kind == "train":
                mask = np.zeros((h, w), np.uint8)
                mask[100 + 8 * i: 400 + 8 * i, 200 + 20 * i: 420 + 20 * i] = 1
                if i not in (absent or {}).get(video, ()):
                    mask[450 - 5 * i: 650 - 5 * i, 900 - 10 * i: 1200 - 10 * i] = 2
                png = Image.fromarray(mask, mode="P")
                png.putpalette(palette)
                a_dir = os.path.join(root, split, "Annotations", video)
                os.makedirs(a_dir, exist_ok=True)
                png.save(os.path.join(a_dir, name + ".png"), bits=8)
        meta[video] = {"frames": names, "expressions": {
            str(i): ({"exp": c[0], "obj_id": c[1]} if kind == "train" else {"exp": c})
            for i, c in enumerate(caps)}}
    split_dir = (os.path.join(root, "valid") if kind == "mevis"
                 else os.path.join(root, "meta_expressions", split))
    os.makedirs(split_dir, exist_ok=True)
    with open(os.path.join(split_dir, "meta_expressions.json"), "w") as fh:
        json.dump({"videos": meta}, fh)
    if test_only:
        os.makedirs(os.path.join(root, "meta_expressions", "test"))
        with open(os.path.join(root, "meta_expressions", "test", "meta_expressions.json"),
                  "w") as fh:
            json.dump({"videos": {v: meta[v] for v in test_only}}, fh)
    if kind == "train":
        objects = {"1": {"category": "person"}, "2": {"category": "dog"}}
        with open(os.path.join(root, "train", "meta.json"), "w") as fh:
            json.dump({"videos": {v: {"objects": objects} for v in videos}}, fh)
    return root


def read_png(path: str):
    import numpy as np
    from PIL import Image

    img = Image.open(path)
    return img.mode, np.array(img), img.getpalette()


def check_binary_tree(out_dir: str, videos: dict, label: str) -> int:
    """Every PNG of a ytvos/mevis output tree: present, L mode, 0/255, at
    the original size. Returns the number of files."""
    import os

    n = 0
    for video, (n_frames, caps) in videos.items():
        for e in range(len(caps)):
            for i in range(n_frames):
                path = os.path.join(out_dir, "valid", video, str(e), f"{i:05d}.png")
                if not os.path.exists(path):
                    raise AssertionError(f"{label}: {path} missing")
                mode, m, _ = read_png(path)
                if mode != "L" or m.shape != PROTO_HW or not set(m.ravel().tolist()) <= {0, 255}:
                    raise AssertionError(f"{label}: {path} is {mode} {m.shape}, values "
                                         f"{sorted(set(m.ravel().tolist()))[:5]}")
                n += 1
    return n


def count_trunks(engine) -> list:
    """Wrap ``engine.trunk`` to record (E, T, 2D MSDA forward launches) of
    every trunk forward."""
    from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn

    calls = []
    trunk = engine.trunk

    def counted(feats, mask, ids, attn, sizes):
        before = ms_deform_attn.launches
        out = trunk(feats, mask, ids, attn, sizes)
        calls.append((len(ids), int(mask.shape[1]), ms_deform_attn.launches - before))
        return out

    engine.trunk = counted
    return calls


def expected_trunks(n_exp: int, t_clip: int, dtype: str = "bfloat16", exp_batch: int = 8):
    """(E, T, 2D forward launches) of each trunk forward of one clip, as
    run_video_batch chunks ``n_exp`` expressions under the memory envelope
    at 384x640."""
    from tce_rvos_tpu_torch import infer

    cap = infer.trunk_frame_envelope((384, 640), dtype, device="cuda") // t_clip
    eb = max(1, min(exp_batch, infer._pow2_floor(max(cap, 1))))
    return [(infer._pow2_ceil(min(eb, n_exp - off)), t_clip, 12) for off in range(0, n_exp, eb)]


def timed_protocol(label: str, fn, n_frames: int, n_expression_windows: int) -> dict:
    """Run ``fn`` (one protocol over a tree) with the launch counts at 0 and
    the peak memory reset; wall seconds, frames/s, expression-windows/s,
    peak memory, launches, and the wall time split into JPEG decoding
    (``infer._load_frame``), ``run_video_batch`` (the device's work and the
    copies of its outputs to the host), ``masks_to_original`` (the
    upsample to the original size and its copy to the host), PNG encoding
    (``PIL.Image.Image.save``) and the rest."""
    import torch
    from PIL import Image

    from tce_rvos_tpu_torch import infer

    stages = {"jpeg decode": (infer, "_load_frame"),
              "run_video_batch": (infer.InferenceEngine, "run_video_batch"),
              "masks_to_original": (infer, "masks_to_original"),
              "png encode": (Image.Image, "save")}
    spent = dict.fromkeys(stages, 0.0)
    originals = {k: getattr(owner, name) for k, (owner, name) in stages.items()}

    def timed(stage):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return originals[stage](*args, **kwargs)  # returns host arrays: synchronised
            finally:
                spent[stage] += time.perf_counter() - t
        return call

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for stage, (owner, name) in stages.items():
        setattr(owner, name, timed(stage))
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        for stage, (owner, name) in stages.items():
            setattr(owner, name, originals[stage])
    split = dict(spent, other=secs - sum(spent.values()))
    out = dict(seconds=secs, frames_per_s=n_frames / secs,
               expression_windows_per_s=n_expression_windows / secs,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launch_counts(),
               split_s=split)
    log(f"{label} {secs:.3f} s wall: {out['frames_per_s']:.2f} frames/s, "
        f"{out['expression_windows_per_s']:.2f} expression-windows/s ({n_frames} frames, "
        f"{n_expression_windows} expression-windows); max_memory_allocated "
        f"{out['peak_gib']:.3f} GiB; launches {out['launches']}; wall split: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()))
    return out


def phase_protocols(sd, sd3, root: str) -> dict:
    """The ytvos, davis and mevis protocols on synthetic trees of 720x1280
    JPEG frames under ``root``, flagship weights at full width:
    * ytvos, bf16, whole-video (windows of 16 and 40 frames, E = 2 and 4):
      every PNG present at the original size, the test-only video absent,
      each PNG bitwise the threshold of run_video_batch + select_query +
      masks_to_original on the same engine, 12 2D forward launches per
      trunk forward;
    * davis through ``infer.main`` (the command line on the card, bf16, its
      own seeded init, one 32-frame window, 8 expressions): palette PNGs;
    * mevis, bf16, windows of 5: PNGs;
    * ytvos windowed (5 frames, f_extra = 1) in f32 on the card and on the
      CPU: PNGs may differ only where the CPU's score lies within 2e-3 of
      the threshold;
    * ytvos windowed with the ``--msda_3d`` flagship (weights of seed 1),
      bf16: 8 3D and 4 2D forward launches per trunk forward; the
      whole-video batched-against-serial gap as a reading.
    Prints wall seconds, frames/s, expression-windows/s and peak memory per
    protocol."""
    import os

    import numpy as np
    import torch

    from tce_rvos_tpu_torch import flagship_config, infer

    res = {}
    ytvos = write_tree(os.path.join(root, "ytvos"), "ytvos", PROTO_YTVOS,
                       test_only={"vtest": (3, CAPTIONS[:1])}, seed=10)
    davis = write_tree(os.path.join(root, "davis"), "davis", PROTO_DAVIS, seed=11)
    mevis = write_tree(os.path.join(root, "mevis"), "mevis", PROTO_MEVIS, seed=12)
    small = write_tree(os.path.join(root, "small"), "ytvos", PROTO_SMALL, seed=13)
    out = {k: os.path.join(root, "out_" + k) for k in
           ("ytvos", "davis", "mevis", "cuda", "cpu", "3d")}

    # ytvos, whole-video, bf16
    label = "[protocol ytvos bf16 whole-video]"
    engine = infer.InferenceEngine(flagship_config(compute_dtype="bfloat16"), sd, device="cuda")
    trunks = count_trunks(engine)
    n_frames = sum(n for n, _ in PROTO_YTVOS.values())
    n_exp = sum(len(c) for _, c in PROTO_YTVOS.values())
    res["ytvos"] = timed_protocol(label, lambda: infer.run_ytvos(engine, ytvos, out["ytvos"]),
                                  n_frames, n_exp)
    log(f"{label} trunk forwards (E, T, msda_fwd launches): {trunks}")
    want = [t for n, c in PROTO_YTVOS.values() for t in expected_trunks(len(c), -(-n // 8) * 8)]
    if trunks != want or res["ytvos"]["launches"]["msda_fwd"] != 12 * len(want):
        raise AssertionError(f"{label} trunk forwards {trunks}, launches "
                             f"{res['ytvos']['launches']}; expected {want}, 12 a forward")
    files = check_binary_tree(out["ytvos"], PROTO_YTVOS, label)
    if os.path.exists(os.path.join(out["ytvos"], "valid", "vtest")):
        raise AssertionError(f"{label}: the test split's video was not skipped")
    for video, (n, caps) in PROTO_YTVOS.items():
        frames = [infer._load_frame(os.path.join(ytvos, "valid", "JPEGImages", video,
                                                 f"{i:05d}.jpg")) for i in range(n)]
        outs = engine.run_video_batch(frames, [" ".join(c.lower().split()) for c in caps],
                                      whole_video=True)
        for e, o in enumerate(outs):
            q = infer.select_query(o["pred_logits"])
            scores = infer.masks_to_original(o["pred_masks"][:, q], o["model_size"], PROTO_HW,
                                             device=engine.device)
            for i in range(n):
                _, png, _ = read_png(os.path.join(out["ytvos"], "valid", video, str(e),
                                                  f"{i:05d}.png"))
                if not np.array_equal(png, (scores[i] > 0.5).astype(np.uint8) * 255):
                    raise AssertionError(f"{label} {video}/{e}/{i:05d}.png is not the threshold "
                                         f"of run_video_batch on the same engine")
    log(f"{label} {files} PNGs at {PROTO_HW[0]}x{PROTO_HW[1]}, the test-only video skipped, "
        f"each bitwise the threshold of run_video_batch + select_query + masks_to_original")

    # mevis, windows of 5, bf16 (E = 3, padded to 4)
    label = "[protocol mevis bf16]"
    trunks.clear()
    (n, caps), = PROTO_MEVIS.values()
    windows = -(-n // engine.window)
    res["mevis"] = timed_protocol(label, lambda: infer.run_mevis(engine, mevis, out["mevis"]),
                                  n, len(caps) * windows)
    want = expected_trunks(len(caps), engine.window) * windows
    if trunks != want:
        raise AssertionError(f"{label} trunk forwards {trunks}, expected {want}")
    check_binary_tree(out["mevis"], PROTO_MEVIS, label)
    del engine
    torch.cuda.empty_cache()

    # davis through the command line: bf16, the model's own init, window 32
    label = "[protocol davis bf16, infer.main]"
    (n, caps), = PROTO_DAVIS.values()
    chunks = len(expected_trunks(len(caps), 32))
    argv = ["--dataset_file", "davis", "--davis_path", davis, "--output_dir", out["davis"],
            "--binary", "--with_box_refine", "--f_token", "8", "--qtrans",
            "--compute_dtype", "bfloat16"]
    res["davis"] = timed_protocol(label, lambda: infer.main(argv), n, len(caps))
    if res["davis"]["launches"]["msda_fwd"] != 12 * chunks:
        raise AssertionError(f"{label} launches {res['davis']['launches']}, expected 12 x "
                             f"{chunks} trunk forwards")
    palette = infer.davis_palette()
    for a in range(4):
        for i in range(n):
            path = os.path.join(out["davis"], "valid", f"anno_{a}", "d20", f"{i:05d}.png")
            if not os.path.exists(path):
                raise AssertionError(f"{label}: {path} missing")
            mode, m, pal = read_png(path)
            if (mode != "P" or m.shape != PROTO_HW or pal[:len(palette)] != palette
                    or not set(m.ravel().tolist()) <= {0, 1, 2}):
                raise AssertionError(f"{label}: {path} is {mode} {m.shape}, values "
                                     f"{sorted(set(m.ravel().tolist()))[:5]}")
    log(f"{label} {4 * n} palette PNGs at {PROTO_HW[0]}x{PROTO_HW[1]}, trunk forwards "
        f"(E, T, msda_fwd launches) {expected_trunks(len(caps), 32)}")

    # ytvos windowed, f32 (TF32 off): the card against the CPU
    label = "[protocol ytvos f32 windowed, GPU against CPU]"
    cpu_scores = []
    mto = infer.masks_to_original
    (n, caps), = PROTO_SMALL.values()
    for dev in ("cuda", "cpu"):
        engine = infer.InferenceEngine(flagship_config(), sd, device=dev, window=5)
        if dev == "cpu":
            def recording(*a, **k):
                cpu_scores.append(mto(*a, **k))
                return cpu_scores[-1]

            infer.masks_to_original = recording
        try:
            t0 = time.perf_counter()
            infer.run_ytvos(engine, small, out[dev], whole_video=False, f_extra=1)
            log(f"{label} {dev}: {time.perf_counter() - t0:.3f} s")
        finally:
            infer.masks_to_original = mto
        del engine
    torch.cuda.empty_cache()
    n_diff = n_near = 0
    for e in range(len(caps)):
        for i in range(n):
            _, g, _ = read_png(os.path.join(out["cuda"], "valid", "v6", str(e), f"{i:05d}.png"))
            _, c, _ = read_png(os.path.join(out["cpu"], "valid", "v6", str(e), f"{i:05d}.png"))
            near = np.abs(cpu_scores[e][i] - 0.5) <= 2e-3
            n_near += int(near.sum())
            n_diff += int((g != c).sum())
            if ((g != c) & ~near).any():
                raise AssertionError(f"{label} v6/{e}/{i:05d}.png: pixels differ where the CPU "
                                     f"score is farther than 2e-3 from the threshold")
    res["gpu_vs_cpu"] = dict(pixels_differ=n_diff, pixels_near_threshold=n_near)
    log(f"{label} {n_diff} pixels differ, of {n_near} whose CPU score lies within 2e-3 of the "
        f"threshold ({len(caps) * n * PROTO_HW[0] * PROTO_HW[1]} pixels)")

    # --msda_3d, windowed, bf16
    label = "[protocol ytvos --msda_3d bf16 windowed]"
    engine = infer.InferenceEngine(flagship_config(msda_3d=True, compute_dtype="bfloat16"), sd3,
                                   device="cuda", window=5)
    windows = -(-n // engine.window)
    res["msda_3d"] = timed_protocol(
        label, lambda: infer.run_ytvos(engine, small, out["3d"], whole_video=False, f_extra=1),
        n, len(caps) * windows)
    want = {"msda_fwd": 4 * windows, "msda_bwd": 0, "msda3d_fwd": 8 * windows, "msda3d_bwd": 0}
    if res["msda_3d"]["launches"] != want:
        raise AssertionError(f"{label} launches {res['msda_3d']['launches']}, expected {want}")
    check_binary_tree(out["3d"], PROTO_SMALL, label)
    frames = [infer._load_frame(os.path.join(small, "valid", "JPEGImages", "v6",
                                             f"{i:05d}.jpg")) for i in range(n)]
    batched = engine.run_video_batch(frames, list(caps), whole_video=True)
    gaps = [mask_gap(b["pred_masks"], engine.run_video(frames, c, whole_video=True)["pred_masks"])
            for b, c in zip(batched, caps)]
    res["msda_3d"]["batched_vs_serial"] = gaps
    log(f"{label} whole-video (8 frames) batched E = {len(caps)} against serial, a reading (the "
        f"3D op's time axis spans the batch's E x T frames): relative RMS "
        + ", ".join(f"{g[0]:.3e}" for g in gaps) + "; share of pixels whose mask differs "
        + ", ".join(f"{g[1]:.3e}" for g in gaps))
    del engine
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 9: training through train.main
# ---------------------------------------------------------------------------

# 3 videos x 20 frames x 2 expressions, anchors every 5 frames: 24 samples.
# The dog leaves video t0 for frames 6-13 (frames with valid = 0) and is in
# frame 0 only of t2, whose later clips mostly see no dog and resample.
MAIN_VIDEOS = {f"t{v}": (20, (("a person walking on the left", "1"),
                              ("the dog running to the right", "2"))) for v in range(3)}
MAIN_ABSENT = {"t0": range(6, 14), "t2": range(1, 20)}
MAIN_FLAGS = ["--binary", "--with_box_refine", "--f_token", "8", "--qtrans",
              "--compute_dtype", "bfloat16", "--lr_drop", "1", "--num_workers", "4",
              "--device", "cuda"]
MAIN_WARMUP = 2


@contextlib.contextmanager
def main_probe():
    """Instruments the runs of ``train.main``: each train step timed to its
    end on the device, with the CPU time of the thread that runs it (with
    its base LR, padded (H, W) and invisible frames), the state handed to the first step (to ``rec["on_first"]``),
    checkpoint saves and loads (seconds, bytes) and the dataset's sampling
    attempts (more attempts than samples = resamples of empty clips)."""
    import os
    import threading

    import torch

    from tce_rvos_tpu_torch.data import ytvos
    from tce_rvos_tpu_torch.parallel import train_step
    from tce_rvos_tpu_torch.utils import native_ckpt

    rec = {"steps": [], "on_first": None, "saves": [], "loads": [], "attempts": 0, "samples": 0}
    lock = threading.Lock()
    make, save, load = (train_step.make_train_step, native_ckpt.save_checkpoint,
                        native_ckpt.load_any_checkpoint)
    sample_indices, getitem = ytvos.YTVOSDataset._sample_indices, ytvos.YTVOSDataset.__getitem__

    def make_probed(*args, **kw):
        step = make(*args, **kw)

        def probed(state, batch):
            if rec["on_first"] is not None:
                rec["on_first"](state)
                rec["on_first"] = None
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.thread_time()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            rec["steps"].append(dict(ms=(time.perf_counter() - t0) * 1e3,
                                     cpu_ms=(time.thread_time() - c0) * 1e3, lr=metrics["lr"],
                                     loss=float(metrics["loss"]),
                                     hw=tuple(int(x) for x in batch["video"].shape[2:4]),
                                     invisible=int((batch["targets"]["valid"] == 0).sum())))
            return state, metrics

        return probed

    def save_probed(path, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(path, *args, **kw)
        rec["saves"].append(dict(path=path, s=time.perf_counter() - t0, bytes=sum(
            os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))))

    def load_probed(*args, **kw):
        t0 = time.perf_counter()
        out = load(*args, **kw)
        rec["loads"].append(time.perf_counter() - t0)
        return out

    def count(key, fn):
        def counted(*args, **kw):
            with lock:
                rec[key] += 1
            return fn(*args, **kw)
        return counted

    train_step.make_train_step = make_probed
    native_ckpt.save_checkpoint, native_ckpt.load_any_checkpoint = save_probed, load_probed
    ytvos.YTVOSDataset._sample_indices = count("attempts", sample_indices)
    ytvos.YTVOSDataset.__getitem__ = count("samples", getitem)
    try:
        yield rec
    finally:
        train_step.make_train_step = make
        native_ckpt.save_checkpoint, native_ckpt.load_any_checkpoint = save, load
        ytvos.YTVOSDataset._sample_indices = sample_indices
        ytvos.YTVOSDataset.__getitem__ = getitem


def read_log(out: str) -> list:
    import os

    with open(os.path.join(out, "log.txt")) as fh:
        return [json.loads(line) for line in fh]


def main_run(rec: dict, argv: list, label: str, launches_per_step: dict) -> tuple:
    """One ``train.main`` run under ``main_probe``: the launch counts set to
    0 before it and read after, held at ``launches_per_step`` per step;
    finite losses. Returns (the final TrainState, the run's numbers)."""
    import torch

    from tce_rvos_tpu_torch import train

    first = len(rec["steps"])
    n_saves, n_loads, attempts, samples = (len(rec["saves"]), len(rec["loads"]),
                                           rec["attempts"], rec["samples"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state = train.main(argv)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    steps = rec["steps"][first:]
    want = {k: v * len(steps) for k, v in launches_per_step.items()}
    if counts != want:
        raise AssertionError(f"{label}: MSDA launches {counts} over {len(steps)} steps, expected "
                             f"{launches_per_step} per step")
    losses = [s["loss"] for s in steps]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    out = dict(steps=len(steps), wall_s=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=counts, saves=rec["saves"][n_saves:], loads=rec["loads"][n_loads:],
               attempts=rec["attempts"] - attempts, samples=rec["samples"] - samples,
               invisible_frames=sum(s["invisible"] for s in steps),
               hw=sorted({s["hw"] for s in steps}))
    if len(steps) > MAIN_WARMUP:
        timed = steps[MAIN_WARMUP:]
        ms = statistics.median(s["ms"] for s in timed)
        # steps slower than 1.5x the median against the rest: wall and the
        # step thread's CPU time (CPU time flat while wall grows: the thread
        # waits; CPU time grows with it: the step itself works more)
        slow = [s for s in timed if s["ms"] > 1.5 * ms]
        rest = [s for s in timed if s["ms"] <= 1.5 * ms]
        split = {k: dict(steps=len(g), ms=statistics.median(s["ms"] for s in g),
                         cpu_ms=statistics.median(s["cpu_ms"] for s in g))
                 for k, g in (("slow", slow), ("rest", rest)) if g}
        out.update(ms_per_step=ms, steps_per_s=1e3 / ms, step_ms=[s["ms"] for s in steps],
                   step_cpu_ms=[s["cpu_ms"] for s in steps], slow_split=split)
    log(f"{label}: {len(steps)} steps in {wall:.1f} s of wall time; "
        + (f"{out['ms_per_step']:.3f} ms/step (median after {MAIN_WARMUP} warm-up steps) = "
           f"{out['steps_per_s']:.3f} steps/s; steps over 1.5x the median against the rest "
           "(count, median wall ms, median CPU ms of the step's thread): " + ", ".join(
               f"{k} {v['steps']}, {v['ms']:.3f}, {v['cpu_ms']:.3f}"
               for k, v in out["slow_split"].items()) + "; " if "ms_per_step" in out else "")
        + f"max_memory_allocated {out['peak_gib']:.3f} GiB; MSDA launches {counts}; padded "
        f"(H, W) {out['hw']}; {out['invisible_frames']} invisible frames; "
        f"{out['attempts'] - out['samples']} resamples in {out['samples']} samples; checkpoint "
        + ", ".join(f"save {s['s']:.3f} s ({s['bytes']} bytes)" for s in out["saves"])
        + "".join(f", load {x:.3f} s" for x in out["loads"]))
    return state, out


def assert_state_saved(state, path: str, label: str) -> None:
    """Every parameter, buffer and AdamW state tensor of ``state`` bitwise
    equal to the checkpoint directory ``path``."""
    from tce_rvos_tpu_torch.utils.native_ckpt import load_checkpoint

    sd, opt_sd, _ = load_checkpoint(path)
    for name, value in state.model.state_dict().items():
        if not value.cpu().equal(sd[name]):
            raise AssertionError(f"{label}: {name} is not the saved tensor")
    live = state.optimizer.state_dict()["state"]
    if sorted(live) != sorted(opt_sd["state"]) or not live:
        raise AssertionError(f"{label}: AdamW holds state for {len(live)} parameters, the "
                             f"checkpoint for {len(opt_sd['state'])}")
    for i, entry in opt_sd["state"].items():
        for k, v in entry.items():
            if not live[i][k].cpu().equal(v):
                raise AssertionError(f"{label}: AdamW's {k} of parameter {i} is not the saved one")


def data_share(logs: list) -> list:
    """Per epoch: the logger's seconds per step, of it the wait for data,
    and the share."""
    return [dict(epoch=x["epoch"], time_s=x["train_time"], data_s=x["train_data"],
                 share=x["train_data"] / x["train_time"]) for x in logs]


def main_levels(hw) -> tuple:
    """The MSDA level shapes of a padded (H, W): strides 8, 16, 32, 64."""
    return tuple((-(-hw[0] // s), -(-hw[1] // s)) for s in (8, 16, 32, 64))


def phase_main(root: str) -> dict:
    """``train.main`` on the card at full width and depth (ResNet-50,
    RoBERTa-base, f_token 8, IQT, box refinement, binary, bf16 over f32
    masters) on a synthetic 720x1280 Ref-YouTube-VOS train tree, 24
    samples an epoch:
    1. two epochs with ``--lr_drop 1 --num_workers 4`` (12 + 12 MSDA
       launches per step);
    2. a resume from ``checkpoint/`` for a third epoch: it starts at epoch 2
       with the saved parameters and AdamW state (bitwise) and the
       schedule's LR at step 2 x steps_per_epoch;
    3. a resume from a reference-format ``.pth`` (``{"model", "epoch": 1}``)
       for a third epoch: before its first step AdamW's state is empty and
       ``TrainState.step`` = 2 x steps_per_epoch, its first LR is the
       schedule's there, and after the epoch AdamW's own step counters
       hold steps_per_epoch;
    4. ``--msda_3d --batch_size 2`` for one epoch (8 + 8 3D and 4 + 4 2D
       launches per step, N = 10).
    Gates: one log line per epoch with finite losses, the checkpoint
    directories, the launch counts, frames with valid = 0 and resamples;
    then the 2D forward and backward kernels held against their plain
    versions at the largest padded shape of run 1 (N = 5), and the 2D and
    3D forward and backward at N = 10 at run 4's. Readings: ms/step,
    steps/s, the step thread's CPU time a step, the logger's data time and
    its share, the padded shapes, peak memory, checkpoint seconds and
    bytes."""
    import os
    import shutil

    import numpy as np
    import torch

    label = "[main]"
    tree = write_tree(os.path.join(root, "tree"), "train", MAIN_VIDEOS, seed=20,
                      absent=MAIN_ABSENT)
    out = os.path.join(root, "out")
    flags = ["--dataset_file", "ytvos", "--ytvos_path", tree, *MAIN_FLAGS]
    per_step_2d = {"msda_fwd": 12, "msda_bwd": 12, "msda3d_fwd": 0, "msda3d_bwd": 0}
    res = {}
    with main_probe() as rec:
        _, res["run1"] = main_run(rec, flags + ["--output_dir", out, "--epochs", "2"],
                                  f"{label} run 1, 2 epochs", per_step_2d)
        spe = res["run1"]["steps"] // 2
        logs = read_log(out)
        for name in ("checkpoint", "checkpoint0000", "checkpoint0001"):
            if sorted(os.listdir(os.path.join(out, name))) != ["meta.json", "model.pt",
                                                             "optimizer.pt"]:
                raise AssertionError(f"{label} {name}: {os.listdir(os.path.join(out, name))}")
        shutil.rmtree(os.path.join(out, "checkpoint0000"))  # disk: 2 GB a checkpoint

        def resumed(state):
            if state.step != 2 * spe:
                raise AssertionError(f"{label} run 2 starts at step {state.step}, not {2 * spe}")
            assert_state_saved(state, os.path.join(out, "checkpoint"), f"{label} run 2")

        rec["on_first"] = resumed
        _, res["run2"] = main_run(rec, flags + ["--output_dir", out, "--epochs", "3", "--resume",
                                                os.path.join(out, "checkpoint")],
                                  f"{label} run 2, resumed for epoch 2", per_step_2d)
        if rec["on_first"] is not None:
            raise AssertionError(f"{label} run 2 took no step")
        logs = read_log(out)
        if [x["epoch"] for x in logs] != [0, 1, 2]:
            raise AssertionError(f"{label} log.txt epochs {[x['epoch'] for x in logs]}")
        bad = [x for x in logs if not all(math.isfinite(v) for k, v in x.items()
                                          if k.startswith("train_loss"))]
        if bad:
            raise AssertionError(f"{label} log.txt holds a loss that is not finite: {bad}")
        first_lr = rec["steps"][-res["run2"]["steps"]]["lr"]
        want_lr = float(np.float32(np.float32(0.1) * np.float32(1e-4)))  # one drop, at spe
        if first_lr != want_lr:
            raise AssertionError(f"{label} run 2's first LR {first_lr}, the schedule's at step "
                                 f"{2 * spe} is {want_lr}")
        shutil.rmtree(os.path.join(out, "checkpoint0001"))

        pth = os.path.join(root, "reference.pth")
        torch.save({"model": torch.load(os.path.join(out, "checkpoint", "model.pt"),
                                        weights_only=True), "epoch": 1}, pth)
        shutil.rmtree(out)

        def pth_resumed(state):
            if state.step != 2 * spe or state.optimizer.state:
                raise AssertionError(
                    f"{label} run 3 starts at step {state.step} (expected {2 * spe}) with AdamW "
                    f"state for {len(state.optimizer.state)} parameters (expected 0)")

        rec["on_first"] = pth_resumed
        out_pth = os.path.join(root, "out_pth")
        state, res["run3"] = main_run(rec, flags + ["--output_dir", out_pth, "--epochs", "3",
                                                    "--resume", pth],
                                      f"{label} run 3, resumed from a .pth for epoch 2",
                                      per_step_2d)
        if rec["on_first"] is not None:
            raise AssertionError(f"{label} run 3 took no step")
        first_lr = rec["steps"][-res["run3"]["steps"]]["lr"]
        if first_lr != want_lr:
            raise AssertionError(f"{label} run 3's first LR {first_lr}, the schedule's at step "
                                 f"{2 * spe} is {want_lr}")
        # a fresh AdamW: its own counters count this epoch's steps only
        adam_steps = {float(v["step"]) for v in state.optimizer.state.values()}
        if state.step != 3 * spe or adam_steps != {float(spe)}:
            raise AssertionError(f"{label} run 3 ends at step {state.step} (expected {3 * spe}) "
                                 f"with AdamW step counters {sorted(adam_steps)} (expected {spe})")
        if [x["epoch"] for x in read_log(out_pth)] != [2]:
            raise AssertionError(f"{label} run 3's log.txt epochs "
                                 f"{[x['epoch'] for x in read_log(out_pth)]}")
        del state
        os.remove(pth)
        shutil.rmtree(out_pth)
        torch.cuda.empty_cache()

        out3 = os.path.join(root, "out_3d")
        _, res["run4"] = main_run(
            rec, flags + ["--output_dir", out3, "--epochs", "1", "--msda_3d", "--batch_size", "2"],
            f"{label} run 4, --msda_3d --batch_size 2",
            {"msda_fwd": 4, "msda_bwd": 4, "msda3d_fwd": 8, "msda3d_bwd": 8})
        logs3 = read_log(out3)
        shutil.rmtree(out3)
    torch.cuda.empty_cache()
    if not res["run1"]["invisible_frames"] + res["run2"]["invisible_frames"]:
        raise AssertionError(f"{label} no batch held a frame with valid = 0")
    resamples = sum(r["attempts"] - r["samples"] for r in res.values())
    if not resamples:
        raise AssertionError(f"{label} no clip was resampled")
    res.update(data=data_share(logs), data_3d=data_share(logs3), resamples=resamples,
               steps_per_epoch=spe)
    for row in res["data"] + res["data_3d"]:
        log(f"{label} epoch {row['epoch']}: {row['time_s']:.4f} s a step by the logger, "
            f"{row['data_s']:.4f} s of it waiting for data ({100 * row['share']:.1f}%)")

    hw = max(res["run1"]["hw"], key=lambda x: x[0] * x[1])
    hw3 = max(res["run4"]["hw"], key=lambda x: x[0] * x[1])
    lv, lv3 = main_levels(hw), main_levels(hw3)
    res["hold"] = {"hw": hw, "levels": lv,
                   "fwd": phase_kernels(e=1, shapes=lv),
                   "bwd": phase_backward_kernels(5, shapes=lv),
                   "hw_3d": hw3, "levels_3d": lv3,
                   "fwd_n10": phase_kernels(e=2, shapes=lv3),
                   "bwd_n10": phase_backward_kernels(10, shapes=lv3),
                   "fwd_3d": phase_kernels(e=2, is_3d=True, shapes=lv3),
                   "bwd_3d": phase_backward_kernels(10, is_3d=True, shapes=lv3)}
    log(f"{label} the 2D forward and backward held against plain at run 1's largest padded "
        f"(H, W) {hw}, levels {lv}, N = 5; the 2D and 3D forward and backward at N = 10 at "
        f"run 4's {hw3}, levels {lv3}")
    return res


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def kernels_line(kern: dict, bwd: dict, kern3: dict, bwd3: dict, serve: dict, train: dict,
                 serve3: dict, train3: dict, main_runs: dict) -> dict:
    """The JSON ``kernels`` record: each kernel's main shape in its
    deployment dtype (the encoder call in bf16: E = 4 for the forwards'
    serving paths, N = 5 for the training steps' backwards) in the top-level
    numbers, every measured shape under ``shapes``. ``launches`` counts the
    launches of the kernel's own main path (flagship serving for msda_fwd,
    flagship training for msda_bwd, the --msda_3d serving and training paths
    for the 3D kernels); ``launches_by_path`` gives every path's count,
    ``train.main``'s two runs (phase 9: 2D, two epochs; ``--msda_3d``) among
    them, and ``shapes`` the calls held at those runs' largest padded
    shapes (``main_HxW`` N = 5, ``main_3d_HxW`` N = 10)."""
    def entry(name, source, replaces, also, main, launches, by_path, shapes):
        return {"name": name, "route": "cuda", "source": f"tce_rvos_tpu_torch/csrc/{source}",
                "replaces": f"tce_rvos_tpu/ops/{replaces}",
                "replaces_also": [f"tce_rvos_tpu/ops/{r}" for r in also],
                "launches": launches, "launches_by_path": by_path,
                "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
                "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None, "shapes": shapes}

    def flat(d):
        return {f"{outer}/{k}": v for outer, inner in d.items() for k, v in inner.items()}

    s3 = serve3["launches"]
    m2, m3 = main_runs["run1"]["launches"], main_runs["run4"]["launches"]
    hold = main_runs["hold"]
    run1, run4 = (f"main_{hold['hw'][0]}x{hold['hw'][1]}",
                  f"main_3d_{hold['hw_3d'][0]}x{hold['hw_3d'][1]}")
    at_main = {"fwd": {**{f"{run1}/{k}": v for k, v in hold["fwd"].items()},
                       **{f"{run4}/{k}": v for k, v in hold["fwd_n10"].items()}},
               "bwd": {**{f"{run1}/{k}": v for k, v in hold["bwd"].items()},
                       **{f"{run4}/{k}": v for k, v in hold["bwd_n10"].items()}},
               "fwd3": {f"{run4}/{k}": v for k, v in hold["fwd_3d"].items()},
               "bwd3": {f"{run4}/{k}": v for k, v in hold["bwd_3d"].items()}}

    def by_path(d, kname):
        return {**d, "train_main": m2[kname], "train_main_3d": m3[kname]}

    return {"kernels": [
        entry("msda_fwd", "msda_fwd.cu", "pallas_msda.py:166", ["pallas_msda.py:265"],
              kern["e4"]["encoder/bfloat16"], serve,
              by_path({"serve": serve, "train": train["plain"]["launches"],
                       "serve_3d": s3["msda_fwd"], "train_3d": train3["launches"]}, "msda_fwd"),
              {**flat(kern), **at_main["fwd"]}),
        entry("msda_bwd", "msda_bwd.cu", "pallas_msda_bwd.py:70",
              ["pallas_msda_bwd.py:157", "pallas_msda_bwd.py:232", "pallas_msda_bwd.py:311"],
              bwd["encoder/bfloat16"], train["plain"]["backward_launches"],
              by_path({"serve": 0, "train": train["plain"]["backward_launches"], "serve_3d": 0,
                       "train_3d": train3["backward_launches"]}, "msda_bwd"),
              {**bwd, **at_main["bwd"]}),
        entry("msda3d_fwd", "msda3d_fwd.cu", "pallas_msda_3d.py:51", ["pallas_msda_3d.py:124"],
              kern3["e4"]["encoder/bfloat16"], s3["msda3d_fwd"],
              by_path({"serve": 0, "train": 0, "serve_3d": s3["msda3d_fwd"],
                       "train_3d": train3["launches_3d"]}, "msda3d_fwd"),
              {**flat(kern3), **at_main["fwd3"]}),
        entry("msda3d_bwd", "msda3d_bwd.cu", "pallas_msda_3d_bwd.py:48",
              ["pallas_msda_3d_bwd.py:120", "pallas_msda_3d_bwd.py:175",
               "pallas_msda_3d_bwd.py:247"],
              bwd3["n5"]["encoder/bfloat16"], train3["backward_launches_3d"],
              by_path({"serve": 0, "train": 0, "serve_3d": 0,
                       "train_3d": train3["backward_launches_3d"]}, "msda3d_bwd"),
              {**flat(bwd3), **at_main["bwd3"]}),
    ]}


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
    # E = 32 is N = 160 frames: the whole-video dispatch of 4 expressions x 40
    kern = {"e4": phase_kernels(e=4), "e1": phase_kernels(e=1), "e32": phase_kernels(e=32)}
    bwd = phase_backward_kernels()
    phase_edge_kernels()
    phase_ab()
    kern3 = {"e4": phase_kernels(e=4, is_3d=True), "e1": phase_kernels(e=1, is_3d=True)}
    bwd3 = {"n5": phase_backward_kernels(5, is_3d=True),
            "n10": phase_backward_kernels(10, is_3d=True)}
    from tce_rvos_tpu_torch import flagship_config

    sd = random_state_dict(flagship_config(), seed=0)
    videos = [synthetic_video(seed=v) for v in range(3)]
    paths, masks = {}, {}
    for dtype_name in ("bfloat16", "float32"):
        paths[dtype_name], masks[dtype_name] = phase_path(dtype_name, sd, videos)
    bf16_against_f32(masks)
    del masks
    phase_parity(sd, videos[0])
    train = phase_train(sd)
    phase_train_parity(sd)
    # the 3D f32 step, GPU and CPU each against float64, at two weight seeds
    phase_train_against_f64(msda_3d=True)
    # the 3D model's weights: seed 1. With those of seed 0 the CPU's own f32
    # step lies 1.6e-3 of the largest |grad| from float64 on one tensor,
    # beyond the direct GPU-against-CPU element limit (1e-3); with seed 1,
    # 1.6e-4 (PERF.md)
    sd3 = random_state_dict(flagship_config(msda_3d=True), seed=1)
    serve3 = phase_path_3d(sd3, videos[0])
    phase_parity(sd3, videos[0], msda_3d=True)
    train3 = phase_train_3d(sd3)
    phase_train_parity(sd3, msda_3d=True)
    envelope = phase_envelope(sd, videos[0])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        protocols = phase_protocols(sd, sd3, root)
    del sd, sd3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_main_") as root:
        main_runs = phase_main(root)
    log("[numbers] " + json.dumps({"envelope": envelope, "protocols": protocols,
                                   "main": main_runs}))
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels_line(kern, bwd, kern3, bwd3, paths["bfloat16"]["launches"], train,
                                  serve3, train3, main_runs)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
