"""GPU smoke run of the PyTorch port's inference, training and serving paths on one NVIDIA H100.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --profile-serve  # only a 2-step profile of the serve batch
    python3 chip_smoke.py --profile-stage2 # only a 3-step profile of the stage-2 sampler
    python3 chip_smoke.py --profile-stage1 # only profiles of main path 1's conditioner and
                                           # of 2 of its sampler steps
    python3 chip_smoke.py --profile-train  # only 2-step profiles of training (2×16, 1×48)
    python3 chip_smoke.py --time-block-backward [MAX_T]  # only #7's times, to compare trees
    python3 chip_smoke.py --time-norms     # only K3's, #10's and #9's times (CUDA events
                                           # and device time) against their library calls
    python3 chip_smoke.py --time-frame-attention  # only K2's times at its five main-path
                                           # sites, against #6 and SDPA
    python3 chip_smoke.py --time-frame-backward   # only #5's times at its four training
                                           # sites, against #7 and SDPA's backward
    python3 chip_smoke.py --time-png       # only a 512² Average/Paeth PNG decode, C against
                                           # the plain Python unfilter, on the host's CPU

1. prints the card (nvidia-smi name and power limit) and fails without CUDA;
2. builds the kernels from this checkout (`hi3d_tpu_torch/csrc`);
3. runs each forward kernel (K1, K2, #6 segment attention, K3, #9 GroupNorm
   statistics, #10 LayerNorm) and each backward kernel (#3, #5, #7, and the
   K3 and #10 autograd Functions) against its plain PyTorch version at the
   main paths' shapes (error against a stated tolerance, CUDA-event times),
   beside the one PyTorch call that computes the same function, where there
   is one (`library_ms`), and the least time the card could take (`bound_ms`);
4. runs the full-width stage-1 UNet once at a small input on the card and
   holds its output, then its parameter gradient, against the same weights
   on the CPU (plain versions, fp32 and bf16); the same for the output of the
   full-width stage-2 UNet (17 input channels), and for the stage-1 UNet's
   output and gradient at a 40-frame clip (every frame-axis site on #6/#7);
5. main path 1: `hi3d_tpu_torch.pipelines.i2v.main` on `demo/3.png` at full
   width (configs/inference-v01.yaml, 16×512², random weights); checks the
   frames and every kernel's launch count against the model's plan;
6. main path 2: `hi3d_tpu_torch.train.main` on configs/train-v01.yaml at
   full width (2 videos × 16 × 512² per step, random weights, renders made
   from demo/3.png) for 4 steps; checks finite losses, moved parameters, a
   reloadable checkpoint and the launch counts; then 3 steps on one video of
   48 frames a step (a dense ring of renders, `long_clip_config`): finite
   losses and launch counts with #6/#7 on every frame-axis site;
7. main path 3: `hi3d_tpu_torch.pipelines.v2v.main` at full width
   (configs/inference-v02.yaml, 16×1024², 25 steps, random weights, the DPT's
   included) on the frames main path 1 wrote; checks the refined frames and
   the launch counts;
8. main path 4: `hi3d_tpu_torch.pipelines.serve.main` in orbit mode on two
   images (demo/3.png and a rolled copy) at full width, 2 assets × 48 frames
   × 512² in one batch, 25 steps; checks the frames and the launch counts
   (#6 on every frame-axis site, K2 none);
9. main path 5: `hi3d_tpu_torch.pipelines.full.main` at full width on
   demo/3.png (configs/inference-v01.yaml → configs/inference-v02.yaml, 16 ×
   512² → 16 × 1024², 25 steps each, random weights), background removal by
   a full U²-Net with random weights saved under outputs/ and named by
   HI3D_U2NET_CKPT; checks rgba.png and white.png, that stage 2 read
   white.png, the refined frames, 16 finite scores of each kind in
   metrics.json, the memory released between the stages and the launch
   counts (i2v + v2v + the ViewScorer's ViT-L); prints the stage seconds,
   the U²-Net's ms at 320² and the peak memory;
10. main path 6: `serve.main --mode two_stage` on the two images of path 4,
   --batch 1 (two batches handed from stage 1 to stage 2), 16 frames, 25
   steps each stage, both engines resident: 2 × 16 × 1024² frames, the
   launch counts, peak memory, s/asset;
11. prints the kernel JSON line (launches per path and summed, errors, times,
   bounds), the card line, and the contract line last.

Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
NUM_STEPS = 25  # the configured sampler steps (configs/inference-v01.yaml)
TRAIN_STEPS = 4  # optimizer steps of configs/train-v01.yaml
STAGE2_STEPS = 25  # the configured sampler steps (configs/inference-v02.yaml)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of `fn()` over `reps` runs after one warm-up."""
    import torch

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
    times.sort()
    return times[len(times) // 2]


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA H100 datasheet)
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (same source)


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time one H100 could take for
    work that moves `nbytes` (each input read once, each output written
    once) and does `flops` operations."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


class Results(dict):
    """{kernel name: {"err", "ms", "plain_ms", "library_ms", "bound_ms",
    "bound_by"}}: the worst error over a kernel's cases and its times summed
    over them. `library_ms` is None when some case has no single PyTorch
    call that computes the same function; `bound_by` is that of the case
    with the largest bound."""

    def add(self, name, err, ms, plain_ms, library_ms, nbytes, flops):
        b_ms, b_by = bound(nbytes, flops)
        r = self.setdefault(name, {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                                   "bound_ms": 0.0, "bound_by": b_by, "_top": 0.0})
        r["err"] = max(r["err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["library_ms"] = None if library_ms is None or r["library_ms"] is None \
            else r["library_ms"] + library_ms
        r["bound_ms"] += b_ms
        if b_ms > r["_top"]:
            r["_top"], r["bound_by"] = b_ms, b_by
        return b_ms, b_by


def _fmt(x) -> str:
    return "none" if x is None else f"{x:.3f} ms"


def _sdpa_frames(x, h, d):
    """A (B, T, S, H·D) projection as SDPA's (B, S·H, T, D) view: attention
    along the frame axis, one "head" per (location, head)."""
    b, t, s, _ = x.shape
    return x.view(b, t, s * h, d).transpose(1, 2)


def flash_inputs(b, sq, sk, h, d, g):
    """q (B, Sq, H, D), k and v (B, Sk, H, D): head-strided bf16 views of one
    (B, max(Sq, Sk), 3·H·D) projection, as the UNet hands them to K1."""
    import torch

    x = torch.randn((b, max(sq, sk), 3 * h * d), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    return (x[:, :sq, :h * d].view(b, sq, h, d), x[:, :sk, h * d:2 * h * d].view(b, sk, h, d),
            x[:, :sk, 2 * h * d:].view(b, sk, h, d))


PLAIN_SCORES_MAX = 2**30  # fp32 score entries the plain version builds in one call (4 GB)


def _flash_slices(q, k):
    """The (b, h) slices of a (B, S, H, D) tensor, as index tuples, where the
    plain version's fp32 scores for q and k would pass PLAIN_SCORES_MAX;
    None where the whole call fits."""
    if q.shape[0] * q.shape[2] * q.shape[1] * k.shape[1] <= PLAIN_SCORES_MAX:
        return None
    return [(slice(i, i + 1), slice(None), slice(j, j + 1))
            for i in range(q.shape[0]) for j in range(q.shape[2])]


def plain_flash(q, k, v):
    """K1's plain version, one (b, h) slice at a time where the whole call's
    fp32 scores would pass PLAIN_SCORES_MAX."""
    import torch

    from hi3d_tpu_torch.ops import flash_attention as fa

    slices = _flash_slices(q, k)
    if slices is None:
        return fa.flash_attention_reference(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), device=q.device)
    for sl in slices:
        out[sl], lse[sl[0], sl[2]] = fa.flash_attention_reference(q[sl], k[sl], v[sl])
    return out, lse


# K2's main-path sites (B, T, S, C), D = 64: the stage-1 UNet's four
# frame-axis sites (one CFG-batched call over 2 × 16 frames, 64² to 8²) and
# stage 2's level-1 site (128²)
K2_SITES = ((2, 16, 4096, 320), (2, 16, 1024, 640), (2, 16, 256, 1280), (2, 16, 64, 1280),
            (2, 16, 16384, 320))
# #5's sites: the training step's (2 × 16 frames, the stage-1 UNet's four
# frame-axis sites at 64² to 8²)
B5_SITES = K2_SITES[:4]

# K3's cases (shape, act, time-stack view): the 2-D norms of a stage-1 UNet
# call at 64² (2 × 16 frames), a 32² time stack, the stage-1 and serve (4
# videos × 48 frames) time-stack views at 64², and a stage-2 2-D norm at 128²
K3_CASES = (((32, 320, 64, 64), None, False), ((32, 320, 64, 64), "silu", False),
            ((2, 640, 16, 32, 32), "silu", False), ((2, 320, 16, 64, 64), "silu", True),
            ((4, 320, 48, 64, 64), "silu", True), ((32, 320, 128, 128), "silu", False))


def frame_attention_work(b, t, s, c):
    """(bytes, flops) of K2 at one site: q, k, v read and O written once;
    4·T²·D flops a segment."""
    return 4 * b * t * s * c * 2, 4 * b * s * c * t * t


def group_norm_work(shape):
    """(bytes, flops) of K3 on bf16 x of `shape`: x read and y written once,
    fp32 γ and β read; about 8 flops an element."""
    n = int(np.prod(shape))
    return 2 * n * 2 + 2 * shape[1] * 4, 8 * n


def _k3_input(shape, view: bool, gen):
    """bf16 x of `shape` (N, C, *spatial), O(3) around 1; with `view`, the
    (B, C, T, H, W) permuted view of a contiguous (B, T, C, H, W) tensor."""
    import torch

    if not view:
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16) * 3 + 1
    b, c, t, h, w = shape
    x = torch.randn((b, t, c, h, w), generator=gen, device="cuda", dtype=torch.bfloat16) * 3 + 1
    return x.permute(0, 2, 1, 3, 4)


def kernel_phase() -> Results:
    """Each forward kernel against its plain version at main-path shapes,
    with the time of the one PyTorch call that computes the same function
    (`library_ms`, a yardstick the port never calls) and the bound."""
    import torch
    import torch.nn.functional as F

    from hi3d_tpu_torch.ops import flash_attention as fa
    from hi3d_tpu_torch.ops import group_norm as gn
    from hi3d_tpu_torch.ops import layer_norm as ln
    from hi3d_tpu_torch.ops import temporal_attention as ta

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    results = Results()

    def record(name, err, tol, ms, plain_ms, label, library_ms, nbytes, flops, summed=True):
        """Print one case and fail past `tol`; `summed=False` keeps the case
        out of the kernel's summed times in the JSON line."""
        if summed:
            b_ms, b_by = results.add(name, err, ms, plain_ms, library_ms, nbytes, flops)
        else:
            b_ms, b_by = bound(nbytes, flops)
            label += " (not in the JSON sums)"
        print(f"[kernel] {name} {label}: max_abs_err={err:.3e} (tol {tol:.1e}) "
              f"kernel={ms:.3f} ms plain={plain_ms:.3f} ms library={_fmt(library_ms)} "
              f"bound={b_ms:.4f} ms ({b_by})", flush=True)
        if not err <= tol:
            raise AssertionError(f"{name} {label}: max abs error {err} > {tol}")

    # K1: bf16 inputs, fp32 softmax in both; P is rounded to bf16 before P·V in
    # both, so the gap is a few bf16 ulps of the output. |O| shrinks as S grows
    # (about sqrt(e/S) for these inputs: max ≈ 0.07 at S = 16384), so O is held
    # within 2e-2 absolute and within 2e-2 of max |plain O|; lse (fp32 in both)
    # within 1e-3. Library: F.scaled_dot_product_attention on (B, H, S, D) views.
    def flash_errors(q, k, v):
        """(max |O − plain O|, its tolerance, max |lse − plain lse|, max |plain O|)."""
        out, lse = fa.flash_attention(q, k, v)
        ref, ref_lse = plain_flash(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        return err, min(2e-2, 2e-2 * scale), lse_err, scale

    def check_flash(b, s, h, d, g, summed=True):
        q, k, v = flash_inputs(b, s, s, h, d, g)
        err, tol, lse_err, scale = flash_errors(q, k, v)
        if not lse_err <= 1e-3:
            raise AssertionError(f"flash_attention lse error {lse_err}")
        qt, kt, vt = (y.transpose(1, 2) for y in (q, k, v))
        record("flash_attention", err, tol,
               time_ms(lambda: fa.flash_attention(q, k, v)),
               time_ms(lambda: plain_flash(q, k, v), reps=3),
               f"B={b} S={s} H={h} D={d} (strided BSHD view, max |O| {scale:.3e}, "
               f"lse err {lse_err:.1e})",
               time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
               4 * b * s * h * d * 2 + b * h * s * 4, 4 * b * h * s * s * d, summed)

    for b, s, h, d in ((4, 4096, 5, 64), (4, 1024, 10, 64), (4, 64, 20, 64)):
        check_flash(b, s, h, d, gen)

    # K1 off the main paths' shapes, correctness only: D = 80 (zero-padded to
    # 128 columns in the kernel) and D = 128, query and key lengths that are
    # no multiple of a tile, Sq ≠ Sk
    for b, sq, sk, h, d in ((2, 1000, 777, 3, 80), (2, 777, 1000, 2, 128), (3, 200, 65, 4, 64)):
        err, tol, lse_err, scale = flash_errors(*flash_inputs(b, sq, sk, h, d, gen))
        print(f"[kernel] flash_attention B={b} Sq={sq} Sk={sk} H={h} D={d} (correctness only): "
              f"max_abs_err={err:.3e} (tol {tol:.1e}, max |O| {scale:.3e}), lse {lse_err:.3e} "
              f"(tol 1.0e-03)", flush=True)
        if not (err <= tol and lse_err <= 1e-3):
            raise AssertionError(f"flash_attention Sq={sq} Sk={sk} D={d}: errors {err}, {lse_err}")

    # K2: softmax in fp32 in both, P rounded to bf16 before P·V in the
    # kernel (as the Pallas kernel), so the gap is a few bf16 ulps of O; a
    # second call gives bitwise the same O. At the stage-1 UNet's four
    # frame-axis sites (T = 16, 64² to 8²) and stage 2's level-1 site (128²)
    for b, t, s, c in K2_SITES:
        h = c // 64
        base = [torch.randn((b, t, s, c), generator=gen, device=dev, dtype=bf16)
                for _ in range(3)]
        q, k, v = (x.view(b, t, s, h, 64) for x in base)
        out = ta.temporal_attention(q, k, v)
        ref = ta.temporal_attention_reference(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.equal(ta.temporal_attention(q, k, v), out):
            raise AssertionError(f"temporal_attention B={b} T={t} S={s}: not repeatable")
        lib = [_sdpa_frames(x, h, 64) for x in base]
        record("temporal_attention", err, 2e-2,
               time_ms(lambda: ta.temporal_attention(q, k, v)),
               time_ms(lambda: ta.temporal_attention_reference(q, k, v), reps=3),
               f"B={b} T={t} S={s} C={c}",
               time_ms(lambda: F.scaled_dot_product_attention(*lib)),
               *frame_attention_work(b, t, s, c))
    # K2 off the main paths' shapes, correctness only: every T from 1 to 32
    # that changes the tiling (one or two query tiles, padded keys), D = 64
    # and 128, S = 67 locations (groups of segments that do not divide them)
    for t in (1, 2, 16, 17, 32):
        for d in (64, 128):
            q, k, v = (torch.randn((2, t, 67, 2 * d), generator=gen, device=dev, dtype=bf16)
                       .view(2, t, 67, 2, d) for _ in range(3))
            err = (ta.temporal_attention(q, k, v).float()
                   - ta.temporal_attention_reference(q, k, v).float()).abs().max().item()
            print(f"[kernel] temporal_attention B=2 T={t} S=67 H=2 D={d} (correctness only): "
                  f"max_abs_err={err:.3e} (tol 2.0e-02)", flush=True)
            if not err <= 2e-2:
                raise AssertionError(f"temporal_attention T={t} D={d}: error {err}")

    # #6 at the serve path's four frame-axis sites (2 assets × CFG = 4 videos
    # of 48 frames at 512²), a ragged T = 33, T = 64 at D = 128, and past 128
    # frames (T = 136: two query chunks and three key blocks; T = 256; printed,
    # not in the JSON sums); the inputs are (B, T, S, C) projections handed
    # over as (B, S, T, H, D) views, as the UNet does. Out within 2e-2
    # absolute and within 2e-2 of max |plain O| (bf16 output, P rounded to
    # bf16 before P·V), lse within 1e-3 (fp32 in both).
    for b, t, s, c, d, summed in ((4, 48, 4096, 320, 64, True), (4, 48, 1024, 640, 64, True),
                                  (4, 48, 256, 1280, 64, True), (4, 48, 64, 1280, 64, True),
                                  (4, 33, 256, 1280, 64, True), (2, 64, 256, 1280, 128, True),
                                  (1, 136, 256, 1280, 64, False),
                                  (1, 256, 256, 1280, 64, False)):
        h = c // d
        base = [torch.randn((b, t, s, c), generator=gen, device=dev, dtype=bf16)
                for _ in range(3)]
        q, k, v = (x.view(b, t, s, h, d).transpose(1, 2) for x in base)
        out, lse = ta._block_forward(q, k, v, None)
        ref, ref_lse = ta.temporal_block_attention_reference(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= 1e-3:
            raise AssertionError(f"temporal_block_attention T={t} lse error {lse_err}")
        lib = [_sdpa_frames(x, h, d) for x in base]
        record("temporal_block_attention", err, min(2e-2, 2e-2 * scale),
               time_ms(lambda: ta.segment_attention(q, k, v)),
               time_ms(lambda: ta.temporal_block_attention_reference(q, k, v), reps=3),
               f"B={b} T={t} S={s} C={c} D={d} (transposed views, max |O| {scale:.3e}, "
               f"lse err {lse_err:.3e}, tol 1.0e-03)",
               time_ms(lambda: F.scaled_dot_product_attention(*lib)),
               4 * b * t * s * c * 2 + b * h * s * t * 4, 4 * b * s * c * t * t, summed)

    # K3: same one-pass fp32 arithmetic, so the gap is a bf16 rounding flip
    # from a different summation order; γ = 1 + 0.1·randn and β = 0.1·randn
    # keep |y| < 8 (x̂ within ±6 over 10⁸ values), where one flip is at most
    # 3.1e-2, under the 6e-2 tolerance (γ = randn reached |y| ≥ 8, where a
    # flip is 6.25e-2). A second call gives bitwise the same y. The
    # time-stack cases hand K3 the (B, C, T, H, W) view of a (B, T, C, H, W)
    # tensor, as the UNet does. Library: F.group_norm (on a contiguous copy
    # for a view), for the cases without SiLU (with it no single call
    # computes the same)
    for shape, act, view in K3_CASES:
        x = _k3_input(shape, view, gen)
        w = 1 + 0.1 * torch.randn((shape[1],), generator=gen, device=dev)
        bia = 0.1 * torch.randn((shape[1],), generator=gen, device=dev)
        out = gn.group_norm(x, w, bia, 32, 1e-5, act)
        ref = gn.group_norm_reference(x, w, bia, 32, 1e-5, act)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.equal(gn.group_norm(x, w, bia, 32, 1e-5, act), out):
            raise AssertionError(f"group_norm x{shape}: not repeatable")
        wx, bx = w.to(bf16), bia.to(bf16)
        xc = x.contiguous()
        record("group_norm", err, 6e-2,
               time_ms(lambda: gn.group_norm(x, w, bia, 32, 1e-5, act)),
               time_ms(lambda: gn.group_norm_reference(x, w, bia, 32, 1e-5, act), reps=3),
               f"x{tuple(shape)} act={act}{' (time-stack view)' if view else ''}",
               None if act else time_ms(lambda: F.group_norm(xc, 32, wx, bx, 1e-5)),
               *group_norm_work(shape))

    # the stage-2 cases draw from their own generator, so the stage-1 cases
    # above keep their inputs. K1 at stage 2's level-1 site (S = 16384, H5):
    # B1 H1, and B2 H5 (2 of the 32 frame images of one CFG-batched UNet
    # call; the plain version runs one (b, h) slice at a time there). B2 H5
    # is timed and printed but left out of the JSON sums, which keep the
    # cases they summed before it was added.
    gen = torch.Generator(device=dev).manual_seed(1)
    check_flash(1, 16384, 1, 64, gen)
    check_flash(2, 16384, 5, 64, gen, summed=False)

    def stats_err(got, want):
        """Largest |kernel − plain| of (mean, inv_std), relative to the plain
        value's largest magnitude; both are fp32 sums of the same values in
        another order."""
        return max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))

    # #10: the fused pass's y in x's dtype against the plain fp32 apply (bf16:
    # |y| < 8, so one bf16 ulp is ≤ 3.1e-2; fp32: summation order, 1e-4), and
    # its (mean, inv_std) through `row_stats` (1e-4 relative). Library:
    # F.layer_norm with γ, β in x's dtype
    for m, c, dtype, eps in ((32 * 16384, 320, bf16, 1e-5), (16 * 577, 768, torch.float32, 1e-6)):
        x = torch.randn((m, c), generator=gen, device=dev, dtype=dtype) * 3 + 1
        w = 1 + 0.1 * torch.randn((c,), generator=gen, device=dev)
        bia = 0.1 * torch.randn((c,), generator=gen, device=dev)
        y = ln.layer_norm(x, w, bia, eps)
        ref = ln.layer_norm_reference(x, w, bia, eps)
        torch.cuda.synchronize()
        rel = stats_err(ln.row_stats(x, eps), ln.row_stats_reference(x, eps))
        if not rel <= 1e-4:
            raise AssertionError(f"row_stats ({m}, {c}): relative error {rel}")
        err = (y.float() - ref.float()).abs().max().item()
        wx, bx = w.to(dtype), bia.to(dtype)
        record("layer_norm", err, 6e-2 if dtype == bf16 else 1e-4,
               time_ms(lambda: ln.layer_norm(x, w, bia, eps)),
               time_ms(lambda: ln.layer_norm_reference(x, w, bia, eps), reps=3),
               f"({m}, {c}) {str(dtype).split('.')[-1]} (stats rel err {rel:.1e})",
               time_ms(lambda: F.layer_norm(x, (c,), wx, bx, eps)),
               2 * m * c * x.element_size() + 2 * c * 4, 8 * m * c)

    # #9: fp32 (mean, inv_std) against the plain version, within 1e-4 of
    # their largest magnitude (4.19 M-element sums folded in another order).
    # Library: torch.var_mean over the group view
    for shape, eps in (((1, 128, 1024, 1024), 1e-6), ((16, 256, 96, 96), 1e-5)):
        x = torch.randn(shape, generator=gen, device=dev) * 3 + 1
        got = gn.group_stats(x, 32, eps)
        want = gn.group_stats_reference(x, 32, eps)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        scale = max(b.abs().max().item() for b in want)
        xg = x.view(shape[0], 32, -1)
        record("group_stats", err, 1e-4 * scale,
               time_ms(lambda: gn.group_stats(x, 32, eps)),
               time_ms(lambda: gn.group_stats_reference(x, 32, eps), reps=3),
               f"x{tuple(shape)} fp32 (mean, inv_std up to {scale:.3f})",
               time_ms(lambda: torch.var_mean(xg, dim=-1, correction=0)),
               x.numel() * 4 + shape[0] * 32 * 2 * 4, 3 * x.numel())
    return results


# #7's shapes: the serve path's four frame-axis sites, a ragged T = 33, T = 64
# at D = 128, and past 64 frames (B1 S256 C1280); (B, T, S, C, D, in the
# JSON sums)
BLOCK_BACKWARD_CASES = ((4, 48, 4096, 320, 64, True), (4, 48, 1024, 640, 64, True),
                        (4, 48, 256, 1280, 64, True), (4, 48, 64, 1280, 64, True),
                        (4, 33, 256, 1280, 64, True), (2, 64, 256, 1280, 128, True),
                        (1, 136, 256, 1280, 64, False), (1, 256, 256, 1280, 64, False),
                        (1, 512, 256, 1280, 64, False))


def frame_backward_work(b, t, s, c):
    """(bytes, flops) of #5 at one site: q, k, v, O, dO read and dq, dk, dv
    written once; 10·T²·D flops a segment."""
    return 8 * b * t * s * c * 2, 10 * b * s * c * t * t


def block_backward_work(b, t, s, c, d):
    """(bytes, flops) of #7 at one shape: q, k, v, O, dO read and dq, dk, dv
    written once, lse read; 10·T²·D flops a segment."""
    return 8 * b * t * s * c * 2 + b * (c // d) * s * t * 4, 10 * b * s * c * t * t


def block_backward_case(b, t, s, c, d, gen, plain=True, reps=10):
    """#7 on (B, T, S, C) projections as (B, S, T, H, D) views, from #6's own
    O and lse: (its gradients, the plain version's (None unless `plain`),
    kernel ms, plain ms, SDPA backward ms)."""
    import torch
    import torch.nn.functional as F

    from hi3d_tpu_torch.ops import temporal_attention as ta

    h = c // d
    base = [torch.randn((b, t, s, c), generator=gen, device="cuda", dtype=torch.bfloat16)
            for _ in range(4)]
    q, k, v, dout = (x.view(b, t, s, h, d).transpose(1, 2) for x in base)
    out, lse = ta._block_forward(q, k, v, None)
    got = ta.temporal_block_attention_backward(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    want, plain_ms = None, None
    if plain:
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        ref = ta.temporal_block_attention_reference(*leaves)[0]
        want = torch.autograd.grad(ref, leaves, dout, retain_graph=True)
        plain_ms = time_ms(lambda: torch.autograd.grad(ref, leaves, dout, retain_graph=True),
                           reps=3)
        del ref, leaves
    ms = time_ms(lambda: ta.temporal_block_attention_backward(q, k, v, out, lse, dout), reps)
    leaves = [x.detach().requires_grad_() for x in base[:3]]
    lib = F.scaled_dot_product_attention(*(_sdpa_frames(y, h, d) for y in leaves))
    library_ms = time_ms(lambda: torch.autograd.grad(lib, leaves, _sdpa_frames(base[3], h, d),
                                                     retain_graph=True), reps)
    return got, want, ms, plain_ms, library_ms


def time_png_decode(size: int = 512, reps: int = 5) -> None:
    """Seconds to decode one size² RGBA PNG whose scanlines alternate the
    Average and Paeth filters, with `read_png` (the C unfilter; best of
    `reps`, its build excluded) and with the plain Python unfilter, on this
    host's CPU. The scanlines are random bytes: any bytes are a valid
    filtered image, and both decoders must give the same one."""
    import struct
    import zlib

    from hi3d_tpu_torch.utils import png

    stride = size * 4
    rows = np.random.RandomState(0).randint(0, 256, (size, 1 + stride)).astype(np.uint8)
    rows[:, 0] = np.arange(size) % 2 + 3
    raw = rows.tobytes()
    os.makedirs(os.path.join(ROOT, "outputs"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_png_",
                                     dir=os.path.join(ROOT, "outputs")) as tmp:
        path = os.path.join(tmp, "frame.png")
        with open(path, "wb") as f:
            f.write(png._SIGNATURE)
            f.write(png._chunk(b"IHDR", struct.pack(">IIBBBBB", size, size, 8, 6, 0, 0, 0)))
            f.write(png._chunk(b"IDAT", zlib.compress(raw, 6)))
            f.write(png._chunk(b"IEND", b""))
        fast = png.read_png(path)  # builds the C unfilter
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            png.read_png(path)
            times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    plain = png._unfilter_reference(raw, size, stride, 4)
    plain_s = time.perf_counter() - t0
    if not np.array_equal(fast.reshape(size, stride), plain):
        raise AssertionError("read_png and the plain unfilter disagree")
    print(f"[png] {size}² RGBA, Average/Paeth rows: read_png {min(times):.4f} s, plain "
          f"unfilter {plain_s:.4f} s ({plain_s / min(times):.0f}×)", flush=True)


def time_block_backward(max_t: int = 1 << 30) -> None:
    """#7's kernel and SDPA-backward times alone, at every case of
    BLOCK_BACKWARD_CASES up to `max_t` frames (20 runs each), for comparing
    two trees on one card:

        python3 chip_smoke.py --time-block-backward [MAX_T]"""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    for b, t, s, c, d, _ in BLOCK_BACKWARD_CASES:
        if t > max_t:
            continue
        _, _, ms, _, library_ms = block_backward_case(b, t, s, c, d, gen, plain=False, reps=20)
        nbytes, flops = block_backward_work(b, t, s, c, d)
        b_ms, b_by = bound(nbytes, flops)
        print(f"[time] temporal_block_attention_backward B={b} T={t} S={s} C={c} D={d}: "
              f"kernel={ms:.3f} ms ({flops / ms / 1e9:.1f} TF/s, {100 * b_ms / ms:.1f}% of the "
              f"bound) sdpa_bwd={library_ms:.3f} ms bound={b_ms:.4f} ms ({b_by})", flush=True)


def backward_kernel_phase() -> Results:
    """#3, #5 and #7 against autograd through their plain versions, and K3's
    Function (kernel forward, plain fp32 backward) against autograd of
    `group_norm_reference`, at the training and serve paths' shapes.

    Error measure: max |kernel − plain| over dq/dk/dv (dx/dγ/dβ) divided by
    max |plain| of the same gradient; tolerance 2e-2. Both sides read the
    same bf16 inputs; the kernels round P and dS to bf16 before their tensor
    -core products (as the Pallas kernels do) and every gradient is rounded
    to bf16 once, so the gap is a few bf16 ulps of the largest entry.

    Returns `Results` like `kernel_phase`; "plain ms" times the plain
    version's backward alone (graph kept), "library ms" the autograd
    backward of F.scaled_dot_product_attention on the same views."""
    import torch
    import torch.nn.functional as F

    from hi3d_tpu_torch.ops import flash_attention as fa
    from hi3d_tpu_torch.ops import group_norm as gn
    from hi3d_tpu_torch.ops import layer_norm as ln
    from hi3d_tpu_torch.ops import temporal_attention as ta

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    bf16 = torch.bfloat16
    results = Results()
    tol = 2e-2

    def check(name, label, got, want, ms, plain_ms, library_ms=None, nbytes=0, flops=0,
              summed=True):
        abs_err, rel = 0.0, 0.0
        for tag, a, b in zip(("d0", "d1", "d2"), got, want):
            e = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            if not (torch.isfinite(a).all() and scale > 0):
                raise AssertionError(f"{name} {label}: {tag} not finite or reference all zero")
            abs_err, rel = max(abs_err, e), max(rel, e / scale)
        if summed:
            b_ms, b_by = results.add(name, abs_err, ms, plain_ms, library_ms, nbytes, flops)
        else:  # as `record` in `kernel_phase`
            b_ms, b_by = bound(nbytes, flops)
            label += " (not in the JSON sums)"
        print(f"[bwd] {name} {label}: max_abs_err={abs_err:.3e} rel={rel:.3e} (tol {tol:.0e}) "
              f"kernel={ms:.3f} ms plain={plain_ms:.3f} ms library={_fmt(library_ms)} "
              f"bound={b_ms:.4f} ms ({b_by})", flush=True)
        if not rel <= tol:
            raise AssertionError(f"{name} {label}: relative error {rel} > {tol}")

    def plain_grads(fn, ins, dout):
        leaves = [t.detach().requires_grad_() for t in ins]
        out = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, dout, retain_graph=True)
        ms = time_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True), reps=3)
        return grads, ms

    def library_grad_ms(fn, ins, dout):
        leaves = [t.detach().requires_grad_() for t in ins]
        out = fn(*leaves)
        return time_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True), reps=3)

    def sdpa_bshd(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2))

    def plain_flash_grads(q, k, v, dout):
        """Autograd through K1's plain version, one (b, h) slice at a time
        past PLAIN_SCORES_MAX score entries (times summed over the slices)."""
        fn = lambda *a: fa.flash_attention_reference(*a)[0]  # noqa: E731
        slices = _flash_slices(q, k)
        if slices is None:
            return plain_grads(fn, (q, k, v), dout)
        grads, total = [torch.empty_like(t) for t in (q, k, v)], 0.0
        for sl in slices:
            part, ms = plain_grads(fn, (q[sl], k[sl], v[sl]), dout[sl])
            for whole, g in zip(grads, part):
                whole[sl] = g
            total += ms
        return grads, total

    # #3 at the training path's four sites and stage 2's level-1 site
    # (B2 S16384 H5, as in `kernel_phase`: printed, not in the JSON sums)
    for b, s, h in ((4, 4096, 5), (4, 1024, 10), (4, 256, 20), (4, 64, 20), (2, 16384, 5)):
        d = 64
        q, k, v = flash_inputs(b, s, s, h, d, gen)
        dout = torch.randn((b, s, h, d), generator=gen, device=dev, dtype=bf16)
        out, lse = fa.flash_attention(q, k, v)
        got = fa.flash_attention_backward(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        want, plain_ms = plain_flash_grads(q, k, v, dout)
        ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout))
        check("flash_attention_backward", f"B={b} S={s} H={h} D={d}", got, want, ms, plain_ms,
              library_grad_ms(sdpa_bshd, (q, k, v), dout.transpose(1, 2)),
              8 * b * s * h * d * 2 + b * h * s * 4, 10 * b * h * s * s * d, summed=s != 16384)
        del want

    # #3 off the main paths' shapes, correctness only (as K1's in `kernel_phase`)
    for b, sq, sk, h, d in ((2, 1000, 777, 3, 80), (2, 777, 1000, 2, 128), (3, 200, 65, 4, 64)):
        q, k, v = flash_inputs(b, sq, sk, h, d, gen)
        dout = torch.randn(q.shape, generator=gen, device=dev, dtype=bf16)
        out, lse = fa.flash_attention(q, k, v)
        got = fa.flash_attention_backward(q, k, v, out, lse, dout)
        want, _ = plain_flash_grads(q, k, v, dout)
        rel = max(((a.float() - w.float()).abs().max() / w.float().abs().max()).item()
                  for a, w in zip(got, want))
        print(f"[bwd] flash_attention_backward B={b} Sq={sq} Sk={sk} H={h} D={d} (correctness "
              f"only): rel={rel:.3e} (tol {tol:.0e})", flush=True)
        if not (rel <= tol and all(torch.isfinite(a).all() for a in got)):
            raise AssertionError(f"flash_attention_backward Sq={sq} Sk={sk} D={d}: rel {rel}")

    for b, t, s, c in B5_SITES:
        h = c // 64
        base = [torch.randn((b, t, s, c), generator=gen, device=dev, dtype=bf16)
                for _ in range(4)]
        q, k, v, dout = (x.view(b, t, s, h, 64) for x in base)
        out = ta.temporal_attention(q, k, v)
        got = ta.temporal_attention_backward(q, k, v, out, dout)
        torch.cuda.synchronize()
        want, plain_ms = plain_grads(ta.temporal_attention_reference, (q, k, v), dout)
        ms = time_ms(lambda: ta.temporal_attention_backward(q, k, v, out, dout))
        check("temporal_attention_backward", f"B={b} T={t} S={s} C={c}", got, want, ms,
              plain_ms, library_grad_ms(
                  lambda *a: F.scaled_dot_product_attention(*(_sdpa_frames(y, h, 64) for y in a)),
                  base[:3], _sdpa_frames(base[3], h, 64)),
              *frame_backward_work(b, t, s, c))

    # #5 off the training path's T, correctness only: one frame (dq, dk are 0
    # exactly: the one probability is 1), two 16-frame tiles (T = 17, 32),
    # both head dims, S = 67 (the last group of segments is not full); a
    # second call must be bitwise the same (no atomics)
    for t in (1, 17, 32):
        for d in (64, 128):
            q, k, v, dout = (torch.randn((2, t, 67, 5 * d), generator=gen, device=dev,
                                         dtype=bf16).view(2, t, 67, 5, d) for _ in range(4))
            out = ta.temporal_attention(q, k, v)
            got = ta.temporal_attention_backward(q, k, v, out, dout)
            again = ta.temporal_attention_backward(q, k, v, out, dout)
            want, _ = plain_grads(ta.temporal_attention_reference, (q, k, v), dout)
            rel = 0.0
            for a, w in zip(got, want):
                top = w.float().abs().max().item()
                if not torch.isfinite(a).all() or (top == 0 and a.any()):
                    raise AssertionError(f"temporal_attention_backward T={t} D={d}: not finite, "
                                         "or not 0 where the plain gradient is 0")
                if top > 0:
                    rel = max(rel, (a.float() - w.float()).abs().max().item() / top)
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"[bwd] temporal_attention_backward B=2 T={t} S=67 H=5 D={d} (correctness "
                  f"only): rel={rel:.3e} (tol {tol:.0e}), bitwise repeat {repeat}", flush=True)
            if not (rel <= tol and repeat):
                raise AssertionError(f"temporal_attention_backward T={t} D={d}: rel {rel}, "
                                     f"bitwise repeat {repeat}")

    # #7 at #6's shapes, from #6's own O and lse (past 64 frames several
    # frame blocks a segment; T = 136, 256, 512 printed, not in the JSON sums)
    for b, t, s, c, d, summed in BLOCK_BACKWARD_CASES:
        got, want, ms, plain_ms, library_ms = block_backward_case(b, t, s, c, d, gen)
        check("temporal_block_attention_backward", f"B={b} T={t} S={s} C={c} D={d}", got, want,
              ms, plain_ms, library_ms, *block_backward_work(b, t, s, c, d), summed)

    for shape, act in (((32, 320, 64, 64), "silu"), ((32, 320, 64, 64), None),
                       ((2, 320, 16, 64, 64), "silu")):
        x = torch.randn(shape, generator=gen, device=dev, dtype=bf16) * 3 + 1
        w = torch.randn((shape[1],), generator=gen, device=dev)
        bia = torch.randn((shape[1],), generator=gen, device=dev)
        dy = torch.randn(shape, generator=gen, device=dev, dtype=bf16)
        leaves = [t.detach().requires_grad_() for t in (x, w, bia)]
        y = gn.group_norm(*leaves, 32, 1e-5, act)
        if y.grad_fn is None:
            raise AssertionError("group_norm output on the card has no grad_fn")
        got = torch.autograd.grad(y, leaves, dy, retain_graph=True)
        want, plain_ms = plain_grads(
            lambda *a: gn.group_norm_reference(*a, 32, 1e-5, act), (x, w, bia), dy)
        ms = time_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True), reps=3)
        check("group_norm_backward", f"x{tuple(shape)} act={act}", got, want, ms, plain_ms)

    # #10's Function: kernel forward, plain fp32 backward from the saved
    # (mean, inv_std), against autograd of `layer_norm_reference`
    for m, c in ((32 * 4096, 320), (32 * 256, 1280)):
        x = torch.randn((m, c), generator=gen, device=dev, dtype=bf16) * 3 + 1
        w = 1 + 0.1 * torch.randn((c,), generator=gen, device=dev)
        bia = 0.1 * torch.randn((c,), generator=gen, device=dev)
        dy = torch.randn((m, c), generator=gen, device=dev, dtype=bf16)
        leaves = [t.detach().requires_grad_() for t in (x, w, bia)]
        y = ln.layer_norm(*leaves, 1e-5)
        if y.grad_fn is None:
            raise AssertionError("layer_norm output on the card has no grad_fn")
        got = torch.autograd.grad(y, leaves, dy, retain_graph=True)
        want, plain_ms = plain_grads(lambda *a: ln.layer_norm_reference(*a, 1e-5), (x, w, bia), dy)
        ms = time_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True), reps=3)
        check("layer_norm_backward", f"({m}, {c}) bf16", got, want, ms, plain_ms)
    return results


KERNELS = (
    # name, route, source, TPU kernel it replaces
    ("flash_attention", "cuda", "hi3d_tpu_torch/csrc/flash_attention.cu",
     "hi3d_tpu/ops/flash_attention.py:245"),
    ("temporal_attention", "cuda", "hi3d_tpu_torch/csrc/temporal_attention.cu",
     "hi3d_tpu/ops/temporal_attention.py:375"),
    ("group_norm", "cuda", "hi3d_tpu_torch/csrc/group_norm.cu",
     "hi3d_tpu/ops/group_norm.py:105"),
    ("flash_attention_backward", "cuda", "hi3d_tpu_torch/csrc/flash_attention.cu",
     "hi3d_tpu/ops/flash_attention.py:493"),
    ("temporal_attention_backward", "cuda", "hi3d_tpu_torch/csrc/temporal_attention.cu",
     "hi3d_tpu/ops/temporal_attention.py:392"),
    ("group_stats", "cuda", "hi3d_tpu_torch/csrc/norm_stats.cu",
     "hi3d_tpu/ops/group_norm.py:392"),
    ("layer_norm", "cuda", "hi3d_tpu_torch/csrc/norm_stats.cu",
     "hi3d_tpu/ops/group_norm.py:461"),
    ("temporal_block_attention", "cuda", "hi3d_tpu_torch/csrc/block_attention.cu",
     "hi3d_tpu/ops/temporal_attention.py:152"),
    ("temporal_block_attention_backward", "cuda", "hi3d_tpu_torch/csrc/block_attention.cu",
     "hi3d_tpu/ops/temporal_attention.py:173"),
)


def _wrappers() -> dict:
    """The launch-counting wrapper of every kernel, by kernel name."""
    from hi3d_tpu_torch.ops import flash_attention as fa
    from hi3d_tpu_torch.ops import group_norm as gn
    from hi3d_tpu_torch.ops import layer_norm as ln
    from hi3d_tpu_torch.ops import temporal_attention as ta

    return {"flash_attention": fa.flash_attention, "temporal_attention": ta.temporal_attention,
            "group_norm": gn.group_norm, "flash_attention_backward": fa.flash_attention_backward,
            "temporal_attention_backward": ta.temporal_attention_backward,
            "group_stats": gn.group_stats, "layer_norm": ln.layer_norm,
            "temporal_block_attention": ta.temporal_block_attention,
            "temporal_block_attention_backward": ta.temporal_block_attention_backward}


def reset_launches() -> None:
    for w in _wrappers().values():
        w.launches = 0


def read_launches(names) -> dict:
    wrappers = _wrappers()
    return {name: wrappers[name].launches for name in names}


def norm_sites(config_path: str) -> dict:
    """#10 and #9 launches per call of each model part of the config: its
    LayerNorm32 and FoldedGroupNorm modules, counted on the meta device
    (each runs once per call of its part)."""
    import torch

    from hi3d_tpu_torch.config import instantiate_from_config, load_config
    from hi3d_tpu_torch.models.attention import LayerNorm32
    from hi3d_tpu_torch.models.clip import vit_h_14, vit_l_14
    from hi3d_tpu_torch.models.dpt import DPTDepthModel
    from hi3d_tpu_torch.models.layers import FoldedGroupNorm
    from hi3d_tpu_torch.models.vae import Decoder, Encoder

    p = load_config(config_path)["model"]["params"]
    dd = p["first_stage_config"]["params"]["ddconfig"]

    def count(build, cls) -> int:
        with torch.device("meta"):
            return sum(isinstance(m, cls) for m in build().modules())

    return {"unet": count(lambda: instantiate_from_config(p["network_config"]), LayerNorm32),
            "vit_h": count(vit_h_14, LayerNorm32), "vit_l": count(vit_l_14, LayerNorm32),
            "dpt_ln": count(DPTDepthModel, LayerNorm32), "dpt_gn": count(DPTDepthModel, FoldedGroupNorm),
            "encoder": count(lambda: Encoder(**dd), FoldedGroupNorm),
            "decoder": count(lambda: Decoder(**dd), FoldedGroupNorm)}


def _chunks(n: int, chunk) -> int:
    return -(-n // (chunk or n))


def _embedder(cfg: dict, target_suffix: str) -> dict:
    (emb,) = [e for e in cfg["model"]["params"]["conditioner_config"]["params"]["emb_models"]
              if e["target"].endswith(target_suffix)]
    return emb.get("params") or {}


def _frame_kernels(t: int, fwd: int, bwd: int) -> dict:
    """Launches of the frame-axis kernels at `t` frames: the route that
    `ops.attention.frame_attention_kernel` picks carries `fwd` forward and
    `bwd` backward launches, the other route none."""
    from hi3d_tpu_torch.ops.attention import frame_attention_kernel

    frame = frame_attention_kernel(t)
    counts = {}
    for name in ("temporal_attention", "temporal_block_attention"):
        counts[name] = fwd if name == frame else 0
        counts[f"{name}_backward"] = bwd if name == frame else 0
    return counts


def expected_launches(config_path: str, steps: int, path: str, clip_size=None,
                      assets: int = 1) -> dict:
    """Launches per kernel that the model's plan predicts for one run of
    `path` ("i2v", "train", "v2v", "serve": `assets` assets of `clip_size`
    frames in one batch, "refine": stage 2 on `assets` videos in one batch,
    or "unet_grad": one forward and backward of the UNet alone at
    `clip_size` frames; the config's clip length by default). The two-stage
    paths sum these (`full_launches`, `two_stage_launches`).

    UNet, per call (inference: one CFG-batched call per sampler step): K1
    and the frame-axis kernel once per transformer block of every
    SpatialVideoTransformer — K2 up to 32 frames, #6 above, as
    `ops.attention.frame_attention_kernel` decides; K3 four times per
    VideoResBlock (spatial and time-stack in/out norms), once per
    transformer `norm`, once for the UNet's `out.0`; #10 once per
    LayerNorm32 of the UNet. Training (`accumulate_grad_batches` UNet calls
    per step): with `use_checkpoint` every VideoResBlock and
    SpatialVideoTransformer runs its forward twice (forward, then recompute
    in the backward), so K1, the frame kernel, #10 and the blocks' K3
    launches double while `out.0` stays at one; #3 and the frame kernel's
    backward (#5 or #7) run once per transformer block. Inference launches
    no backward kernel.

    Conditioning and VAE, once per run (per UNet call in training): #10 once
    per LayerNorm32 of the CLIP towers (ViT-H; ViT-L at stage 1) and of the
    DPT (stage 2); #9 once per FoldedGroupNorm of each VAE encode or decode
    call (frames in chunks of `en_and_decode_n_samples_a_time`) and of the
    DPT (one call on all 16 frames)."""
    from hi3d_tpu_torch.config import load_config
    from hi3d_tpu_torch.models.unet import _build_plan

    cfg = load_config(config_path)
    mp = cfg["model"]["params"]
    p = mp["network_config"]["params"]
    depth = p.get("transformer_depth", 1)
    depth = [depth] * len(p["channel_mult"]) if isinstance(depth, int) else depth
    inp, mid, out = _build_plan(p["model_channels"], p["channel_mult"], p["num_res_blocks"],
                                p["attention_resolutions"], depth)
    specs = [s for block in inp + [mid] + out for s in block]
    blocks = sum(s[2] for s in specs if s[0] == "attn")
    n_attn = sum(1 for s in specs if s[0] == "attn")
    n_res = sum(1 for s in specs if s[0] == "res")
    sites = norm_sites(config_path)
    t = clip_size or mp["num_samples"]
    engine_chunk = mp.get("en_and_decode_n_samples_a_time")
    enc_chunk = _embedder(cfg, "VideoPredictionEmbedderWithEncoder").get(
        "en_and_decode_n_samples_a_time")
    if path in ("train", "unet_grad"):
        calls = 1 if path == "unet_grad" else steps * cfg.get("lightning", {}).get(
            "trainer", {}).get("accumulate_grad_batches", 1)
        fwd = 2 if p.get("use_checkpoint") else 1
        grad = {"flash_attention": calls * fwd * blocks,
                **_frame_kernels(t, calls * fwd * blocks, calls * blocks),
                "group_norm": calls * (fwd * (4 * n_res + n_attn) + 1),
                "flash_attention_backward": calls * blocks}
        if path == "unet_grad":  # one UNet forward and backward, nothing else
            return {**grad, "group_stats": 0, "layer_norm": fwd * sites["unet"]}
        batch = cfg["data"]["params"]["batch_size"]
        # the VAE encodes the batch's frames, the conditioner each video's frame 0
        return {**grad,
                "group_stats": calls * sites["encoder"] * (_chunks(batch * t, engine_chunk)
                                                           + _chunks(batch, enc_chunk)),
                "layer_norm": calls * (fwd * sites["unet"] + sites["vit_h"] + sites["vit_l"])}
    unet = {"flash_attention": steps * blocks, "flash_attention_backward": 0,
            **_frame_kernels(t, steps * blocks, 0),
            "group_norm": steps * (4 * n_res + n_attn + 1)}
    if path in ("i2v", "serve"):  # the conditioner encodes each asset's frame 0; the
        # engine decodes the assets' T frames
        return {**unet,
                "group_stats": sites["encoder"] * _chunks(assets, enc_chunk)
                + sites["decoder"] * _chunks(assets * t, engine_chunk),
                "layer_norm": steps * sites["unet"] + sites["vit_h"] + sites["vit_l"]}
    # v2v, refine: the conditioner (DPT on all the frames in one call, then
    # the VAE embedder) and the engine each encode the assets' T frames; the
    # engine decodes them
    frames = assets * t
    return {**unet,
            "group_stats": sites["dpt_gn"] + sites["encoder"] * (_chunks(frames, enc_chunk)
                                                                 + _chunks(frames, engine_chunk))
            + sites["decoder"] * _chunks(frames, engine_chunk),
            "layer_norm": steps * sites["unet"] + sites["vit_h"] + sites["dpt_ln"]}


def _sum_launches(*plans) -> dict:
    return {name: sum(p.get(name, 0) for p in plans) for name in plans[0]}


def full_launches(stage1: str, stage2: str, steps: int) -> dict:
    """`pipelines.full`: stage 1 as i2v, stage 2 as v2v, then the ViewScorer's
    ViT-L twice (the views, then the reference image): #10 at each of its
    LayerNorm32s a call. The U²-Net launches no kernel (convolutions, an
    fp32 BatchNorm affine and resizes)."""
    scorer = {"layer_norm": 2 * norm_sites(stage1)["vit_l"]}
    return _sum_launches(expected_launches(stage1, steps, "i2v"),
                         expected_launches(stage2, steps, "v2v"), scorer)


def two_stage_launches(stage1: str, stage2: str, steps: int, batches: int, assets: int,
                       clip_size: int) -> dict:
    """serve --mode two_stage: per batch, stage 1 as serve and stage 2 as
    refine on the batch's assets."""
    per_batch = (expected_launches(stage1, steps, "serve", clip_size=clip_size, assets=assets),
                 expected_launches(stage2, steps, "refine", clip_size=clip_size, assets=assets))
    return _sum_launches(*(per_batch * batches))


def _full_width_unet(config_path: str, b: int = 2, t: int = 4):
    """The config's full-width UNet on the card, fp32 weights, seeded; the
    zero-initialised leaves (out convs, proj_out) get random values: with
    them at zero the output would be 0 whatever the kernels do. Inputs: `b`
    videos of `t` frames at a 16² latent."""
    import torch

    from hi3d_tpu_torch.config import instantiate_from_config, load_config

    cfg = load_config(config_path)["model"]["params"]["network_config"]
    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(0)
        unet = instantiate_from_config(cfg).eval()
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for p in unet.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=gen)
    p = cfg["params"]
    hw = 16
    inputs = dict(
        x=torch.randn((b * t, p["in_channels"], hw, hw), generator=gen, device="cuda"),
        timesteps=0.25 * torch.log(torch.rand((b * t,), generator=gen, device="cuda") * 100 + 0.01),
        context=torch.randn((b, 1, p["context_dim"]), generator=gen, device="cuda"),
        y=torch.randn((b, p["adm_in_channels"]), generator=gen, device="cuda"),
        image_only_indicator=torch.zeros((b, t), device="cuda"),
    )
    return unet, inputs, t


def _run_unet(net, inputs, t, dev):
    return net(**{k: v.to(dev) for k, v in inputs.items()}, num_video_frames=t)


def _check_frame_route(t: int, backward: bool) -> None:
    """The frame-axis kernels that ran since the last `reset_launches` are
    the route's for `t` frames (and its backward when `backward`), and the
    other route's did not run."""
    want = _frame_kernels(t, 1, 1 if backward else 0)
    got = read_launches(want)
    if {n: min(c, 1) for n, c in got.items()} != want:
        raise AssertionError(f"frame-axis kernels at T={t}: launches {got}, route {want}")


def unet_reference_phase(config_path: str, b: int = 2, t: int = 4) -> float:
    """The full-width UNet of the config, one call at a small input (`b`
    videos × `t` frames, 16² latent): bf16 on the card through K1, the frame
    kernel of `t` frames (K2 or #6) and K3, held against the same weights in
    fp32 on the CPU through the plain versions.

    Tolerance: bf16 itself is ~1.6e-2 of relative L2 error here (the plain
    versions in bf16 on the CPU measure that in the same run), so the card's
    error may exceed the plain bf16 path's by at most half of it."""
    import copy

    import torch

    t0 = time.perf_counter()
    unet, inputs, t = _full_width_unet(config_path, b, t)
    cpu_fp32 = copy.deepcopy(unet).to("cpu", torch.float32)
    cpu_bf16 = copy.deepcopy(unet).to("cpu", torch.bfloat16)
    unet.to(torch.bfloat16)
    reset_launches()
    with torch.no_grad():
        out = _run_unet(unet, inputs, t, "cuda").float().cpu()
        _check_frame_route(t, backward=False)
        ref, plain = (_run_unet(net, inputs, t, "cpu").float() for net in (cpu_fp32, cpu_bf16))
    if not torch.isfinite(out).all():
        raise AssertionError("UNet output on the card is not finite")
    rel, plain_rel = (((a - ref).norm() / ref.norm()).item() for a in (out, plain))
    print(f"[smoke] full-width UNet of {os.path.basename(config_path)}, {b}×{t} frames at 16² "
          f"latent, vs CPU fp32: card bf16 "
          f"relative L2 error {rel:.3e}, plain bf16 {plain_rel:.3e} (tol {1.5 * plain_rel:.3e}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not rel <= 1.5 * plain_rel:
        raise AssertionError(f"UNet on the card: error {rel} > 1.5 × plain bf16 {plain_rel}")
    return rel


def unet_gradient_phase(config_path: str, b: int = 2, t: int = 4) -> dict:
    """The gradient of a loss on the full-width UNet (same set-up as
    `unet_reference_phase`) with respect to every parameter, training's way
    on the card — fp32 weights, bf16 compute under the UNet's autocast,
    `use_checkpoint` as configured, K1/frame kernel/K3 forward and #3/the
    frame kernel's backward (#5 or #7)/K3 backward — against the CPU with
    the plain versions in fp32 (the reference) and with fp32 weights under
    bf16 autocast (the plain bf16 path).

    Loss: mean of the output times a fixed random cotangent. Pass: the
    relative L2 error of the flattened gradient is at most 1.5× the plain
    bf16 path's; every parameter's gradient on the card is finite, and
    nonzero wherever the fp32 reference's is (the only exact zeros are the
    to_q / to_k / norm2 of the cross-attentions over one context token,
    whose softmax over one key is constant); the card's launches equal the
    UNet's plan for one forward and backward. Returns those launches."""
    import copy

    import torch

    t0 = time.perf_counter()
    unet, inputs, t = _full_width_unet(config_path, b, t)
    cpu = copy.deepcopy(unet).to("cpu")
    cpu.use_checkpoint = False
    gen = torch.Generator().manual_seed(5)
    out_shape = (inputs["x"].shape[0], 4, *inputs["x"].shape[2:])
    cot = torch.randn(out_shape, generator=gen)

    def grads(net, dev, dtype):
        net.dtype = dtype
        net.zero_grad(set_to_none=True)
        loss = (_run_unet(net, inputs, t, dev).float() * cot.to(dev)).mean()
        loss.backward()
        gs = [torch.zeros(p.numel()) if p.grad is None else p.grad.detach().float().flatten().cpu()
              for p in net.parameters()]
        return gs, loss.item()

    expected = expected_launches(config_path, 1, "unet_grad", clip_size=t)
    reset_launches()
    card, card_loss = grads(unet, "cuda", torch.bfloat16)
    launches = read_launches(expected)
    _check_launches(launches, expected)
    ref, ref_loss = grads(cpu, "cpu", torch.float32)
    plain, _ = grads(cpu, "cpu", torch.bfloat16)
    names = [n for n, _ in unet.named_parameters()]
    zero_ref = 0
    for name, g, r in zip(names, card, ref):
        if not torch.isfinite(g).all():
            raise AssertionError(f"gradient of {name} on the card is not finite")
        if r.any() and not g.any():
            raise AssertionError(f"gradient of {name} is 0 on the card, nonzero in the reference")
        zero_ref += not r.any()
    card, ref, plain = (torch.cat(v) for v in (card, ref, plain))
    rel, plain_rel = (((a - ref).norm() / ref.norm()).item() for a in (card, plain))
    print(f"[smoke] full-width UNet gradient, {b}×{t} frames ({len(names)} tensors, "
          f"{ref.numel()} values), loss card {card_loss:.6f} ref {ref_loss:.6f}: card relative L2 "
          f"error {rel:.3e}, plain bf16 {plain_rel:.3e} (tol {1.5 * plain_rel:.3e}); every "
          f"gradient finite, nonzero where the reference's is ({zero_ref} structurally zero in "
          f"both) ({time.perf_counter() - t0:.1f} s)", flush=True)
    if not rel <= 1.5 * plain_rel:
        raise AssertionError(f"UNet gradient on the card: error {rel} > 1.5 × plain bf16 {plain_rel}")
    del unet, cpu
    torch.cuda.empty_cache()
    return launches


def _check_frames(frame_dir: str, shape) -> None:
    from hi3d_tpu_torch.utils.video import import_video

    frames = import_video(frame_dir)
    print(f"[smoke] frames {frames.shape} {frames.dtype} mean {frames.mean():.2f} "
          f"std {frames.std():.2f}", flush=True)
    if frames.shape != shape or frames.dtype != np.uint8:
        raise AssertionError(f"unexpected frames {frames.shape} {frames.dtype}, want {shape} uint8")


def _check_launches(launches: dict, expected: dict) -> None:
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != the model's plan {expected}")


def main_path(steps: int):
    """Stage-1 CLI at full width; returns the launch count of each kernel and
    the output directory (its frames feed main path 3)."""
    import torch

    from hi3d_tpu_torch.pipelines import i2v

    config = os.path.join(ROOT, "configs", "inference-v01.yaml")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "outputs"))
    expected = expected_launches(config, steps, "i2v")
    reset_launches()
    t0 = time.perf_counter()
    i2v.main(["--denoise_config", config, "--image_path", os.path.join(ROOT, "demo", "3.png"),
              "--output_dir", out_dir, "--skip_rembg", "--device", "cuda", "--seed", "0",
              "--num_steps", str(steps)])
    launches = read_launches(expected)
    print(f"[smoke] main path 1 {time.perf_counter() - t0:.1f} s, launches {launches}", flush=True)
    torch.cuda.empty_cache()
    _check_frames(os.path.join(out_dir, "first_step", "frames"), (16, 512, 512, 3))
    _check_launches(launches, expected)
    return launches, out_dir


def stage2_path(steps: int, stage1_dir: str) -> dict:
    """Stage-2 CLI at full width on main path 1's frames (16×512² → 16×1024²,
    random weights, the DPT's included); returns the launch count of each
    kernel."""
    import torch

    from hi3d_tpu_torch.pipelines import v2v

    config = os.path.join(ROOT, "configs", "inference-v02.yaml")
    expected = expected_launches(config, steps, "v2v")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    v2v.main(["--denoise_config", config, "--image_path", os.path.join(ROOT, "demo", "3.png"),
              "--output_dir", stage1_dir, "--device", "cuda", "--seed", "0",
              "--num_steps", str(steps)])
    launches = read_launches(expected)
    print(f"[smoke] main path 3 {time.perf_counter() - t0:.1f} s, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches {launches}", flush=True)
    torch.cuda.empty_cache()
    _check_frames(os.path.join(stage1_dir, "second_step_video", "frames"), (16, 1024, 1024, 3))
    _check_launches(launches, expected)
    return launches


def _demo_rgba() -> np.ndarray:
    """demo/3.png as RGBA, alpha 0 on its white background."""
    from hi3d_tpu_torch.utils.image import load_image_rgb

    img = load_image_rgb(os.path.join(ROOT, "demo", "3.png"))
    alpha = np.where(img.min(axis=-1) < 245, 255, 0).astype(np.uint8)[..., None]
    return np.concatenate([img, alpha], axis=-1)


def write_renders(root: str, folders: int = 2, frames: int = 96) -> str:
    """Orbit-render stand-ins: `folders` folders of `frames` RGBA 512² PNGs
    made from demo/3.png (`_demo_rgba`), rolled by an amount that grows with
    the azimuth and the elevation band, written with the port's PNG writer."""
    from hi3d_tpu_torch.utils.png import write_png

    rgba = _demo_rgba()
    for f in range(folders):
        d = os.path.join(root, f"obj{f:02d}")
        os.makedirs(d, exist_ok=True)
        for i in range(frames):
            band, az = divmod(i, 16)
            write_png(os.path.join(d, f"{i:03d}.png"),
                      np.roll(rgba, (8 * band - 20, 32 * az + 13 * f), axis=(0, 1)))
    return root


def training_path(steps: int) -> dict:
    """`hi3d_tpu_torch.train.main` on configs/train-v01.yaml at full width
    (16×512², the config's batch, random weights) for `steps` steps: finite
    losses, parameters moved, a checkpoint that reloads to the trained
    state, launch counts equal to the UNet plan with checkpointing. Returns
    the launch count of each kernel."""
    import shutil
    import statistics

    import torch

    from hi3d_tpu_torch import train
    from hi3d_tpu_torch.config import instantiate_from_config, load_config

    config = os.path.join(ROOT, "configs", "train-v01.yaml")
    cfg = load_config(config)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=os.path.join(ROOT, "outputs"))
    t0 = time.perf_counter()
    renders = write_renders(os.path.join(out_dir, "renders"))
    print(f"[train] wrote 2×96 RGBA 512² renders in {time.perf_counter() - t0:.1f} s", flush=True)

    # the seeded initial UNet, built as train.main builds it, kept on the host
    seed = 0
    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(seed)
        params = dict(cfg["model"]["params"])
        params.pop("ckpt_path", None)
        init_model = instantiate_from_config({"target": cfg["model"]["target"], "params": params})
    init = {n: p.detach().cpu() for n, p in init_model.model.diffusion_model.named_parameters()}
    del init_model
    torch.cuda.empty_cache()

    expected = expected_launches(config, steps, "train")
    reset_launches()
    t0 = time.perf_counter()
    trainer = train.main(["--base", config, "--max_steps", str(steps), "--no_test", "True",
                          "--device", "cuda", "--seed", str(seed), "--logdir", out_dir,
                          f"data.params.base_folder={renders}", "data.params.num_workers=4"])
    launches = read_launches(expected)
    wall = time.perf_counter() - t0
    rows = [json.loads(line) for line in open(os.path.join(trainer.logdir, "metrics.jsonl"))]
    batch = cfg["data"]["params"]["batch_size"]
    s_per_step = statistics.median(r["sec_per_step"] for r in rows[1:])
    peak = max(r["peak_mem_gb"] for r in rows)
    print(f"[train] {steps} steps in {wall:.1f} s (build, data and checkpoint included); "
          f"batch {batch} videos × 16 frames × 512²; s/step (median of steps 2-{steps}) "
          f"{s_per_step:.3f}; peak allocated {peak:.2f} GB; losses "
          f"{[round(r['loss'], 5) for r in rows]}; launches {launches}", flush=True)
    if [r["step"] for r in rows] != list(range(1, steps + 1)):
        raise AssertionError(f"metrics rows {[r['step'] for r in rows]}")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows):
        raise AssertionError("a training loss or gradient norm is not finite")

    # From random init most tensors cannot move yet: the UNet's zero-initialised
    # out convs leave everything below them without a gradient at step 1, and
    # the warm-up LR (base × 1e-6 … × 3e-3 over steps 1-4) gives updates below
    # fp32 resolution. out.2, the first layer with a gradient, must move.
    unet = trainer.engine.model.diffusion_model
    trained = set(trainer.param_names)
    moved = {n for n, p in unet.named_parameters()
             if f"diffusion_model.{n}" in trained and not torch.equal(p.detach().cpu(), init[n])}
    if not {"out.2.weight", "out.2.bias"} <= moved:
        raise AssertionError(f"out.2 did not move ({len(moved)} of {len(trained)} tensors moved)")
    t0 = time.perf_counter()
    state = trainer.checkpointer.load()
    if state["step"] != steps:
        raise AssertionError(f"checkpoint at step {state['step']}, expected {steps}")
    for n, p in unet.state_dict().items():
        if not torch.equal(state["model"][n], p.cpu()):
            raise AssertionError(f"checkpoint tensor {n} differs from the trained model")
    if len(state["optimizer"]["state"]) != len(trained):
        raise AssertionError("checkpoint optimizer state does not cover the trainable parameters")
    print(f"[train] {len(moved)} of {len(trained)} trainable tensors moved, out.2 among them; "
          f"checkpoint {os.path.realpath(trainer.checkpointer.last)} reloads to the trained state "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    _check_launches(launches, expected)
    del state, trainer, unet
    shutil.rmtree(out_dir)  # tens of GB of checkpoint
    torch.cuda.empty_cache()
    return launches


LONG_CLIP = 48  # frames a clip of the long-clip training run: a 48-view ring
LONG_CLIP_STEPS = 3


def write_ring(root: str, frames: int = LONG_CLIP) -> str:
    """One folder of `frames` RGBA 512² PNGs made from demo/3.png
    (`_demo_rgba`), one ring at one elevation: view i rolled by i/frames of
    the width."""
    from hi3d_tpu_torch.utils.png import write_png

    rgba = _demo_rgba()
    d = os.path.join(root, "ring00")
    os.makedirs(d, exist_ok=True)
    for i in range(frames):
        write_png(os.path.join(d, f"{i:03d}.png"),
                  np.roll(rgba, (0, rgba.shape[1] * i // frames), axis=(0, 1)))
    return root


def dense_orbit_data(**params):
    """The `data:` module of a dense-orbit fine-tune, as a config target
    (`data.target=chip_smoke.dense_orbit_data`), with VideoDataset's params:
    every folder under `base_folder` holds one ring of views at one elevation
    (10°), and a sample is a cyclic window of `sample_frames` of them from a
    random start. VideoDataset, in the port as in the JAX package, takes its
    window inside one 16-frame elevation band of a render folder, so it
    yields at most 16 frames a clip whatever `sample_frames` says."""
    from hi3d_tpu_torch.data.video_dataset import VideoDataset, VideoTrainDataset

    class RingDataset(VideoTrainDataset):
        def sample(self, rng):
            folder = self.folders[int(rng.randint(len(self.folders)))]
            path = os.path.join(self.base_folder, folder)
            names = sorted(os.listdir(path))
            start = int(rng.randint(len(names)))
            chosen = [names[(start + i) % len(names)] for i in range(self.sample_frames)]
            return {"video": np.stack([self._load_frame(os.path.join(path, n)) for n in chosen]),
                    "elevation": np.float32(10.0), "caption": f"{folder}_{chosen[0]}",
                    "fps_id": np.int32(7), "motion_bucket_id": np.int32(127)}

    class RingData(VideoDataset):
        def setup(self):
            self.train_dataset = RingDataset(self.base_folder, self.width, self.height,
                                             self.sample_frames)
            return self

    return RingData(**params)


def long_clip_config(path: str, frames: int = LONG_CLIP, renders: str = "") -> str:
    """configs/train-v01.yaml for one video of `frames` frames a step, written
    whole to `path`: model.params.num_samples, the loss's num_frames and the
    n_copies of every embedder tied to the clip length (the cond-frame VAE
    latent's: n_copies equal to num_samples) set to `frames`, batch 1, data
    from `dense_orbit_data` under `renders`. These are the keys both
    trainers read; a CLI dotlist cannot reach n_copies inside the emb_models
    list in either package, so the config is written out."""
    import yaml

    from hi3d_tpu_torch.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs", "train-v01.yaml"))
    mp = cfg["model"]["params"]
    for emb in mp["conditioner_config"]["params"]["emb_models"]:
        if (emb.get("params") or {}).get("n_copies") == mp["num_samples"]:
            emb["params"]["n_copies"] = frames
    mp["num_samples"] = frames
    mp["loss_fn_config"]["params"]["num_frames"] = frames
    cfg["data"]["target"] = "chip_smoke.dense_orbit_data"
    cfg["data"]["params"].update(base_folder=renders, batch_size=1, sample_frames=frames)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


def long_clip_training_path(steps: int = LONG_CLIP_STEPS, frames: int = LONG_CLIP) -> dict:
    """`hi3d_tpu_torch.train.main` at full width on one video of `frames`
    frames at 512² a step (`long_clip_config`) for `steps` steps: every
    frame-axis site on #6 forward and #7 backward. Checks finite losses and
    launch counts equal to the plan; prints s/step (median of steps 2 on)
    and peak allocated memory. Returns the launch count of each kernel."""
    import shutil
    import statistics

    import torch

    from hi3d_tpu_torch import train

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train48_", dir=os.path.join(ROOT, "outputs"))
    renders = write_ring(os.path.join(out_dir, "renders"), frames)
    config = long_clip_config(os.path.join(out_dir, "train-long.yaml"), frames, renders)
    expected = expected_launches(config, steps, "train")
    reset_launches()
    t0 = time.perf_counter()
    trainer = train.main(["--base", config, "--max_steps", str(steps), "--no_test", "True",
                          "--device", "cuda", "--seed", "0", "--logdir", out_dir,
                          "data.params.num_workers=4"])
    launches = read_launches(expected)
    wall = time.perf_counter() - t0
    rows = [json.loads(line) for line in open(os.path.join(trainer.logdir, "metrics.jsonl"))]
    s_per_step = statistics.median(r["sec_per_step"] for r in rows[1:])
    peak = max(r["peak_mem_gb"] for r in rows)
    print(f"[train48] {steps} steps in {wall:.1f} s (build, data and checkpoint included); "
          f"batch 1 video × {frames} frames × 512²; s/step (median of steps 2-{steps}) "
          f"{s_per_step:.3f}; peak allocated {peak:.2f} GiB; losses "
          f"{[round(r['loss'], 5) for r in rows]}; launches {launches}", flush=True)
    if [r["step"] for r in rows] != list(range(1, steps + 1)):
        raise AssertionError(f"metrics rows {[r['step'] for r in rows]}")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows):
        raise AssertionError("a training loss or gradient norm is not finite")
    _check_launches(launches, expected)
    del trainer
    shutil.rmtree(out_dir)  # tens of GB of checkpoint
    torch.cuda.empty_cache()
    return launches


SERVE_CLIP = 48  # a 48-view orbit: three times the 16 views, 7.5° apart
SERVE_ASSETS = 2


def write_serve_images(root: str) -> str:
    """demo/3.png and a copy of it rolled by a quarter of its width, as PNGs
    in `root`."""
    from hi3d_tpu_torch.utils.image import load_image_rgb
    from hi3d_tpu_torch.utils.png import write_png

    img = load_image_rgb(os.path.join(ROOT, "demo", "3.png"))
    os.makedirs(root, exist_ok=True)
    write_png(os.path.join(root, "asset0.png"), img)
    write_png(os.path.join(root, "asset1.png"), np.roll(img, img.shape[1] // 4, axis=1))
    return root


def serve_path(steps: int) -> dict:
    """The serve CLI in orbit mode at full width (configs/inference-v01.yaml,
    2 assets × 48 frames × 512² in one batch, random weights): 2 × 48 uint8
    frames, launch counts equal to the plan (every frame-axis site on #6),
    peak memory, s per batch, sampler s/step. Returns the launch counts."""
    import torch

    from hi3d_tpu_torch.pipelines import serve

    config = os.path.join(ROOT, "configs", "inference-v01.yaml")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_", dir=os.path.join(ROOT, "outputs"))
    image_dir = write_serve_images(os.path.join(out_dir, "images"))
    expected = expected_launches(config, steps, "serve", clip_size=SERVE_CLIP, assets=SERVE_ASSETS)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9
    reset_launches()
    t0 = time.perf_counter()
    result = serve.main(["--image_dir", image_dir, "--output_dir", os.path.join(out_dir, "orbits"),
                         "--mode", "orbit", "--batch", str(SERVE_ASSETS), "--clip_size",
                         str(SERVE_CLIP), "--device", "cuda", "--seed", "0",
                         "--stage1_config", config])
    launches = read_launches(expected)
    wall = time.perf_counter() - t0
    phases = result["phases"]
    per_batch = sum(phases.values()) / result["batches"]
    print(f"[serve] main path 4 {wall:.1f} s (model build included): {SERVE_ASSETS} assets × "
          f"{SERVE_CLIP} × 512² in {result['batches']} batch; {per_batch:.3f} s per batch, "
          f"{per_batch / SERVE_ASSETS:.3f} s/asset; sampler {phases['sampler']:.3f} s "
          f"({phases['sampler'] / steps:.4f} s/step); peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({held:.2f} GB held before the "
          f"path); phases "
          f"{json.dumps({k: round(v, 3) for k, v in phases.items()})}; launches {launches}",
          flush=True)
    torch.cuda.empty_cache()
    if len(result["outputs"]) != SERVE_ASSETS:
        raise AssertionError(f"serve wrote {result['outputs']}, want {SERVE_ASSETS} assets")
    for name in ("asset0", "asset1"):
        _check_frames(os.path.join(out_dir, "orbits", name, "frames"), (SERVE_CLIP, 512, 512, 3))
    _check_launches(launches, expected)
    return launches


def write_u2net(path: str, seed: int = 0) -> str:
    """A full U²-Net, random weights from `seed`, saved in upstream's layout
    as `path` (whose name must not contain "u2netp")."""
    import torch

    from hi3d_tpu_torch.models.u2net import U2Net

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        torch.save(U2Net(full=True).state_dict(), path)
    return path


def time_u2net(path: str) -> float:
    """ms of one forward of the U²-Net saved at `path` on the card at 320²
    (CUDA events, median of 10 after a warm-up)."""
    import torch

    from hi3d_tpu_torch.convert import load_u2net
    from hi3d_tpu_torch.models.u2net import U2Net, preprocess

    sd, full = load_u2net(path)
    model = U2Net(full=full)
    model.load_state_dict(sd, strict=True)
    model = model.to("cuda").eval()
    img = np.asarray(np.random.RandomState(0).randint(0, 256, (512, 512, 3)), np.uint8)
    x = preprocess(img, device="cuda")
    with torch.no_grad():
        ms = time_ms(lambda: model(x))
    del model
    torch.cuda.empty_cache()
    return ms


FULL_CLIP = 16


def full_path(steps: int) -> dict:
    """Main path 5: `hi3d_tpu_torch.pipelines.full.main` at full width on
    demo/3.png (configs/inference-v01.yaml → configs/inference-v02.yaml,
    16 × 512² → 16 × 1024², `steps` sampler steps each, random weights),
    background removal by a full U²-Net saved here with random weights and
    named by HI3D_U2NET_CKPT (restored afterwards). Checks temp_image's
    rgba.png (4 channels) and white.png, that stage 2 read white.png, 16 ×
    1024² uint8 frames, 16 finite clip_similarity and aesthetic scores, that
    stage 1's release brought the allocated memory back within 0.5 GB, and
    launches equal to the plan. Prints the stage seconds, the U²-Net's ms at
    320² and the peak memory. Returns the launch counts."""
    import torch

    from hi3d_tpu_torch.pipelines import full, v2v
    from hi3d_tpu_torch.utils.png import read_png

    stage1 = os.path.join(ROOT, "configs", "inference-v01.yaml")
    stage2 = os.path.join(ROOT, "configs", "inference-v02.yaml")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_full_", dir=os.path.join(ROOT, "outputs"))
    ckpt = write_u2net(os.path.join(out_dir, "u2net.pth"))
    expected = full_launches(stage1, stage2, steps)
    read = []
    run_v2v = v2v.run_pipeline

    def spy(model, image_path, *args, **kwargs):
        read.append(image_path)
        return run_v2v(model, image_path, *args, **kwargs)

    old_env = os.environ.get("HI3D_U2NET_CKPT")
    os.environ["HI3D_U2NET_CKPT"] = ckpt
    v2v.run_pipeline = spy
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        result = full.main(["--stage1_config", stage1, "--stage2_config", stage2,
                            "--image_path", os.path.join(ROOT, "demo", "3.png"),
                            "--output_dir", out_dir, "--clip_size", str(FULL_CLIP), "--seed", "0",
                            "--num_steps", str(steps), "--device", "cuda"])
    finally:
        v2v.run_pipeline = run_v2v
        if old_env is None:
            del os.environ["HI3D_U2NET_CKPT"]
        else:
            os.environ["HI3D_U2NET_CKPT"] = old_env
    launches = read_launches(expected)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    u2net_ms = time_u2net(ckpt)
    mem = result["allocated_gb"]
    metrics = result["metrics"]
    print(f"[full] main path 5 {wall:.1f} s: stage 1 {result['stage1_sec']} s, stage 2 "
          f"{result['stage2_sec']} s (model builds and background removal included); U²-Net "
          f"{u2net_ms:.3f} ms a 320² forward; allocated {mem['before_stage1']:.3f} GB before "
          f"stage 1, {mem['after_stage1_released']:.3f} GB after its release; peak allocated "
          f"{peak:.2f} GB; clip_similarity_mean {metrics['clip_similarity_mean']}, "
          f"aesthetic_mean {metrics['aesthetic_mean']}; launches {launches}", flush=True)
    temp = os.path.join(out_dir, "temp_image")
    rgba = read_png(os.path.join(temp, "rgba.png"))
    white = os.path.join(temp, "white.png")
    if rgba.ndim != 3 or rgba.shape[-1] != 4 or read_png(white).shape != rgba.shape[:2] + (3,):
        raise AssertionError(f"background removal wrote rgba {rgba.shape}")
    if read != [white]:
        raise AssertionError(f"stage 2 read {read}, want {white}")
    _check_frames(os.path.join(out_dir, "second_step_video", "frames"), (16, 1024, 1024, 3))
    for key in ("clip_similarity", "aesthetic"):
        if len(metrics[key]) != FULL_CLIP or not np.all(np.isfinite(metrics[key])):
            raise AssertionError(f"metrics {key} {metrics[key]}")
    if not abs(mem["after_stage1_released"] - mem["before_stage1"]) <= 0.5:
        raise AssertionError(f"stage 1 was not released: {mem}")
    _check_launches(launches, expected)
    return launches


TWO_STAGE_ASSETS = 2  # two batches of one: generate_stream hands stage 2 two batches


def two_stage_path(steps: int) -> dict:
    """Main path 6: the serve CLI in two_stage mode at full width on two
    images (demo/3.png and a rolled copy), --batch 1, 16 frames, `steps`
    sampler steps each stage, both engines resident: 2 × 16 × 1024² uint8
    frames, launches equal to the plan, peak memory, s/asset. Returns the
    launch counts."""
    import torch

    from hi3d_tpu_torch.pipelines import serve

    stage1 = os.path.join(ROOT, "configs", "inference-v01.yaml")
    stage2 = os.path.join(ROOT, "configs", "inference-v02.yaml")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_two_stage_", dir=os.path.join(ROOT, "outputs"))
    image_dir = write_serve_images(os.path.join(out_dir, "images"))
    expected = two_stage_launches(stage1, stage2, steps, batches=TWO_STAGE_ASSETS, assets=1,
                                  clip_size=FULL_CLIP)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9
    reset_launches()
    t0 = time.perf_counter()
    result = serve.main(["--image_dir", image_dir, "--output_dir", os.path.join(out_dir, "views"),
                         "--mode", "two_stage", "--batch", "1", "--clip_size", str(FULL_CLIP),
                         "--device", "cuda", "--seed", "0", "--stage1_config", stage1,
                         "--stage2_config", stage2])
    launches = read_launches(expected)
    wall = time.perf_counter() - t0
    phases = result["phases"]
    serving = sum(v for k, v in phases.items() if k.startswith("stage2_"))
    print(f"[two_stage] main path 6 {wall:.1f} s (both model builds included): "
          f"{TWO_STAGE_ASSETS} assets × {FULL_CLIP} × 1024² in {result['batches']} batches; "
          f"{serving / TWO_STAGE_ASSETS:.3f} s/asset from the first stage-1 launch to the last "
          f"write; peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({held:.2f} GB held before the path); phases "
          f"{json.dumps({k: round(v, 3) for k, v in phases.items()})}; launches {launches}",
          flush=True)
    torch.cuda.empty_cache()
    if len(result["outputs"]) != TWO_STAGE_ASSETS:
        raise AssertionError(f"serve wrote {result['outputs']}, want {TWO_STAGE_ASSETS} assets")
    for name in ("asset0", "asset1"):
        _check_frames(os.path.join(out_dir, "views", name, "frames"), (FULL_CLIP, 1024, 1024, 3))
    _check_launches(launches, expected)
    return launches


def _device_kernels(prof) -> list:
    """The profiler's device events that are kernels: not the user
    annotations (such as Optimizer.step) that it also puts on the device's
    timeline."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def _profile_report(prof, label: str, steps: int, host_ms: float) -> None:
    """Print host ms/step, launches a step, the device's idle share of the
    traced span, device time by bucket and the 20 largest kernels."""
    import torch

    kernels = _device_kernels(prof)
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    idle = 1.0 - busy / (spans[-1][1] - spans[0][0])
    # the keys name both the current kernels and the ones they replaced
    # (K2's `temporal_attn_kernel`, #5's `temporal_attn_bwd_kernel`, K3's
    # Triton `_gn_*`, #9's `_gn_fold_kernel`, #10's `_ln_kernel`), so that a
    # parent tree's trace buckets the same way
    buckets = (("#7 block attention backward", ("block_attn_bwd",)),
               ("#6 block attention", ("block_attn",)),
               ("#3 flash attention backward", ("fa_bwd",)),
               ("#5 temporal attention backward", ("k2_bwd", "temporal_attn_bwd")),
               ("K1 flash attention", ("fa_fwd",)),
               ("K2 temporal attention", ("k2_fwd", "temporal_attn_kernel")),
               ("#10 LayerNorm", ("_ln_kernel", "norm_rows_kernel")),
               ("#9 GroupNorm statistics", ("_gn_fold_kernel", "group_moments_kernel")),
               ("K3 GroupNorm", ("group_norm_kernel", "_gn_")),
               ("strided elementwise", ("elementwise_kernel",)),
               ("convolutions", ("conv", "fprop", "dgrad", "wgrad", "implicit")),
               ("GEMMs", ("nvjet", "gemm", "cutlass", "xmma")),
               ("NCHW↔NHWC transposes", ("nchwToNhwc", "nhwcToNchw")))
    totals = {name: [0.0, 0] for name, _ in buckets + (("other", ()),)}
    for e in kernels:
        name = next((n for n, keys in buckets if any(k in e.name for k in keys)), "other")
        totals[name][0] += (e.time_range.end - e.time_range.start) / 1e3
        totals[name][1] += 1
    print(f"[profile] {label}, {steps} steps: {host_ms:.2f} ms/step on the host clock, "
          f"{len(kernels) / steps:.0f} launches a step, device idle {100 * idle:.2f}% of the "
          f"span; card {card_line()}", flush=True)
    for name, (ms, n) in sorted(totals.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] {name}: {ms / steps:.2f} ms/step, {n // steps} launches a step, "
              f"{100 * ms / (busy / 1e3):.1f}% of busy", flush=True)
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"[profile] kernel: {ms / steps:.2f} ms/step, {n // steps} a step: {name[:140]}",
              flush=True)


def profile_serve(steps: int = 2) -> None:
    """torch.profiler over `steps` sampler steps of the serve path's batch
    (2 assets × 48 × 512², full width, random weights) after a 1-step
    warm-up: host ms/step, launches a step, device idle share of the span,
    and device time by bucket.

        python3 chip_smoke.py --profile-serve"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hi3d_tpu_torch.pipelines.common import load_inference_model
    from hi3d_tpu_torch.pipelines.serve import OrbitServer, load_images

    config = os.path.join(ROOT, "configs", "inference-v01.yaml")
    image_dir = write_serve_images(tempfile.mkdtemp(prefix="chip_profile_",
                                                    dir=os.path.join(ROOT, "outputs")))
    model = load_inference_model(config, None, "cuda", tag="profile", clip_size=SERVE_CLIP)
    images = load_images(sorted(os.path.join(image_dir, f) for f in os.listdir(image_dir)),
                         (512, 512))
    gen = torch.Generator(device="cuda").manual_seed(0)
    c, uc = OrbitServer(model).condition(images, generator=gen)
    shape = (SERVE_ASSETS * SERVE_CLIP, 64, 64, 4)
    with torch.no_grad():
        model.sample(c, uc, shape, num_video_frames=SERVE_CLIP, generator=gen, num_steps=1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.sample(c, uc, shape, num_video_frames=SERVE_CLIP, generator=gen,
                         num_steps=steps)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / steps
    _profile_report(prof, f"serve sampler, {SERVE_ASSETS}×{SERVE_CLIP} frames at 512²", steps,
                    host_ms)


def profile_train(steps: int = 2) -> None:
    """torch.profiler over `steps` optimizer steps at full width, after one
    step that is not traced, at configs/train-v01.yaml as written (2 videos
    × 16 frames × 512²) and at `long_clip_config` (1 × 48): random videos in
    [-1, 1] made on the card (the loader is not in the window, as it is not
    in the trainer's s/step); the same report as `profile_serve`.

        python3 chip_smoke.py --profile-train"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hi3d_tpu_torch.config import instantiate_from_config, load_config
    from hi3d_tpu_torch.training.trainer import Trainer

    out_dir = tempfile.mkdtemp(prefix="chip_profile_train_", dir=os.path.join(ROOT, "outputs"))
    long_cfg = long_clip_config(os.path.join(out_dir, "train-long.yaml"))
    for config in (os.path.join(ROOT, "configs", "train-v01.yaml"), long_cfg):
        cfg = load_config(config)
        params = dict(cfg["model"]["params"])
        params.pop("ckpt_path", None)
        params.setdefault("base_learning_rate", cfg["model"].get("base_learning_rate"))
        with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
            torch.manual_seed(0)
            engine = instantiate_from_config({"target": cfg["model"]["target"], "params": params})
        b, t = cfg["data"]["params"]["batch_size"], params["num_samples"]
        trainer = Trainer(engine, logdir=os.path.join(out_dir, f"run{t}"), batch_size=b)
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = {"video": torch.rand((b, t, 3, 512, 512), generator=gen, device="cuda") * 2 - 1,
                 "elevation": torch.full((b,), 10.0, device="cuda")}
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        for i in range(1 + steps):
            if i == 1:
                torch.cuda.synchronize()
                prof.start()
                t0 = time.perf_counter()
            trainer.train_step(engine.add_custom_cond(batch, infer=False, generator=gen), gen)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        prof.stop()
        _profile_report(prof, f"training, {b} × {t} frames at 512², peak allocated "
                        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", steps, host_ms)
        del trainer, engine, batch, prof
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


# #10's and #9's shapes in the kernel table (PERF.md §6): (kernel, shape, dtype, eps)
NORM_CASES = (("layer_norm", (16 * 577, 768), "float32", 1e-6),
              ("layer_norm", (32 * 16384, 320), "bfloat16", 1e-5),
              ("group_stats", (1, 128, 1024, 1024), "float32", 1e-6),
              ("group_stats", (16, 256, 96, 96), "float32", 1e-5))


def _device_time(fn, calls: int):
    """(device µs a kernel, kernels a call, kernel names) of `calls` calls of
    `fn`, from the profiler's kernel spans after one call that is not traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    if not kernels:
        raise AssertionError("the profiler caught no kernel")
    spans = sum(e.time_range.end - e.time_range.start for e in kernels)
    return spans / len(kernels), len(kernels) / calls, sorted({e.name[:40] for e in kernels})


def _time_calls(tag: str, label: str, fns: dict, nbytes: float, flops: float,
                calls: int) -> None:
    """One line for `fns` ({label: call}) at one shape: the CUDA-event ms of
    one call (median of 10, as the kernel table), the µs a call over `calls`
    back-to-back calls, the device µs a kernel and kernels a call by the
    profiler; and the bound."""
    b_ms, b_by = bound(nbytes, flops)
    parts = []
    for name, fn in fns.items():
        one_ms = time_ms(fn)
        call_us = time_ms(lambda: [fn() for _ in range(calls)]) / calls * 1e3
        dev_us, per_call, names = _device_time(fn, calls)
        parts.append(f"{name} {one_ms:.4f} ms a call, {call_us:.1f} us a call over {calls}, "
                     f"device {dev_us:.1f} us a kernel, {per_call:.2f} kernels a call "
                     f"({dev_us * per_call:.1f} us a call) {names}")
    print(f"[{tag}] {label}: " + "; ".join(parts) + f"; bound {b_ms:.4f} ms ({b_by}); "
          f"card {card_line()}", flush=True)


def time_norms(calls: int = 100) -> None:
    """K3 through `GroupNorm32` (the UNet's module, so a time-stack view
    costs whatever copy the tree makes of it) at K3_CASES beside
    F.group_norm (on a contiguous x, γ and β in bf16), #10
    (`ln.layer_norm`) and #9 (`gn.group_stats`) at NORM_CASES beside
    F.layer_norm (γ, β in x's dtype) and torch.var_mean (over the group
    view); each with `_time_calls`. Only the public calls run, so the same
    script times a parent tree:

        python3 chip_smoke.py --time-norms"""
    import torch
    import torch.nn.functional as F

    from hi3d_tpu_torch.models.layers import GroupNorm32
    from hi3d_tpu_torch.ops import group_norm as gn
    from hi3d_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape, act, view in K3_CASES:
        x = _k3_input(shape, view, gen)
        norm = GroupNorm32(shape[1], act=act).to("cuda")
        with torch.no_grad():
            norm.weight.normal_(generator=gen)
            norm.bias.normal_(generator=gen)
        xc = x.contiguous()
        wx, bx = norm.weight.to(torch.bfloat16), norm.bias.to(torch.bfloat16)
        with torch.no_grad():
            fns = {"GroupNorm32": lambda: norm(x),
                   "F.group_norm": lambda: F.group_norm(xc, 32, wx, bx, 1e-5)}
            _time_calls("norms", f"group_norm {tuple(shape)} bfloat16 act={act}"
                        f"{' (time-stack view)' if view else ''}", fns, *group_norm_work(shape),
                        calls)
        del x, xc, fns
    for name, shape, dtype, eps in NORM_CASES:
        dt = getattr(torch, dtype)
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(dt)
        if name == "layer_norm":
            c = shape[-1]
            w = 1 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
            bia = 0.1 * torch.randn((c,), generator=gen, device="cuda")
            wx, bx = w.to(dt), bia.to(dt)
            fns = {"kernel": lambda: ln.layer_norm(x, w, bia, eps),
                   "F.layer_norm": lambda: F.layer_norm(x, (c,), wx, bx, eps)}
            nbytes, flops = 2 * x.numel() * x.element_size() + 2 * c * 4, 8 * x.numel()
        else:
            xg = x.view(shape[0], 32, -1)
            fns = {"kernel": lambda: gn.group_stats(x, 32, eps),
                   "torch.var_mean": lambda: torch.var_mean(xg, dim=-1, correction=0)}
            nbytes, flops = x.numel() * x.element_size() + shape[0] * 32 * 2 * 4, 3 * x.numel()
        _time_calls("norms", f"{name} {tuple(shape)} {dtype}", fns, nbytes, flops, calls)
        del x, fns


def time_frame_attention(calls: int = 100) -> None:
    """K2 (`ta.temporal_attention`) at K2_SITES beside #6
    (`ta.segment_attention` on the (B, S, T, H, D) transposed views) and
    SDPA on (B, S·H, T, D) views, each with `_time_calls`. Only public calls
    run, so the same script times a parent tree:

        python3 chip_smoke.py --time-frame-attention"""
    import torch
    import torch.nn.functional as F

    from hi3d_tpu_torch.ops import temporal_attention as ta

    gen = torch.Generator(device="cuda").manual_seed(4)
    for b, t, s, c in K2_SITES:
        h = c // 64
        base = [torch.randn((b, t, s, c), generator=gen, device="cuda", dtype=torch.bfloat16)
                for _ in range(3)]
        q, k, v = (x.view(b, t, s, h, 64) for x in base)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = [_sdpa_frames(x, h, 64) for x in base]
        fns = {"K2": lambda: ta.temporal_attention(q, k, v),
               "#6": lambda: ta.segment_attention(qt, kt, vt),
               "SDPA": lambda: F.scaled_dot_product_attention(*lib)}
        _time_calls("frames", f"temporal_attention B={b} T={t} S={s} C={c}", fns,
                    *frame_attention_work(b, t, s, c), calls)
        del base, q, k, v, qt, kt, vt, lib, fns


def time_frame_backward(calls: int = 100) -> None:
    """#5 (`ta.temporal_attention_backward`, fed K2's O) at B5_SITES beside
    #7 (`ta.temporal_block_attention_backward` on the (B, S, T, H, D)
    transposed views, fed #6's O and lse) and the autograd backward of SDPA
    on (B, S·H, T, D) views, each with `_time_calls`. Only calls that the
    parent tree has too run, so the same script times a parent tree:

        python3 chip_smoke.py --time-frame-backward"""
    import torch
    import torch.nn.functional as F

    from hi3d_tpu_torch.ops import temporal_attention as ta

    gen = torch.Generator(device="cuda").manual_seed(5)
    for b, t, s, c in B5_SITES:
        h = c // 64
        base = [torch.randn((b, t, s, c), generator=gen, device="cuda", dtype=torch.bfloat16)
                for _ in range(4)]
        q, k, v, dout = (x.view(b, t, s, h, 64) for x in base)
        out = ta.temporal_attention(q, k, v)
        qt, kt, vt, dt = (x.transpose(1, 2) for x in (q, k, v, dout))
        out7, lse7 = ta._block_forward(qt, kt, vt, None)
        leaves = [x.detach().requires_grad_() for x in base[:3]]
        lib = F.scaled_dot_product_attention(*(_sdpa_frames(x, h, 64) for x in leaves))
        lib_dout = _sdpa_frames(base[3], h, 64)
        fns = {"#5": lambda: ta.temporal_attention_backward(q, k, v, out, dout),
               "#7": lambda: ta.temporal_block_attention_backward(qt, kt, vt, out7, lse7, dt),
               "SDPA bwd": lambda: torch.autograd.grad(lib, leaves, lib_dout, retain_graph=True)}
        _time_calls("frames-bwd", f"temporal_attention_backward B={b} T={t} S={s} C={c}", fns,
                    *frame_backward_work(b, t, s, c), calls)
        del base, q, k, v, dout, out, qt, kt, vt, dt, out7, lse7, leaves, lib, lib_dout, fns


def profile_stage1(steps: int = 2) -> None:
    """torch.profiler over main path 1's conditioner (configs/
    inference-v01.yaml at full width, random weights: the CLIP towers and the
    VAE encode of the cond frame from demo/3.png at 512²) after one call that
    is not traced, then over `steps` sampler steps (one CFG-batched UNet call
    over 2 × 16 frames at a 64² latent a step) after a 1-step warm-up; the
    same report as `profile_serve` for each.

        python3 chip_smoke.py --profile-stage1"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hi3d_tpu_torch.pipelines import i2v
    from hi3d_tpu_torch.pipelines.common import load_inference_model
    from hi3d_tpu_torch.utils.video import range_from_uint8

    config = os.path.join(ROOT, "configs", "inference-v01.yaml")
    model = load_inference_model(config, None, "cuda", tag="profile")
    t = model.num_samples
    frames = i2v.prepare_frames(os.path.join(ROOT, "demo", "3.png"), t, (512, 512))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def condition():  # as i2v.generate_orbit does
        video = range_from_uint8(torch.as_tensor(frames).to("cuda"))
        batch = {"video": video.permute(0, 3, 1, 2)[None],
                 "elevation": torch.zeros((1,), dtype=torch.float32, device="cuda")}
        batch = model.add_custom_cond(batch, infer=True, generator=gen)
        return model.conditioner.get_unconditional_conditioning(
            batch, force_uc_zero_embeddings=list(i2v.UC_ZERO_KEYS))

    shape = (t, 64, 64, 4)
    with torch.no_grad():
        condition()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            c, uc = condition()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        _profile_report(prof, "stage-1 conditioner (CLIP towers, VAE encode), 1 call", 1,
                        host_ms)
        model.sample(c, uc, shape, num_video_frames=t, generator=gen, num_steps=1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.sample(c, uc, shape, num_video_frames=t, generator=gen, num_steps=steps)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / steps
    _profile_report(prof, f"stage-1 sampler, {t} frames at 512²", steps, host_ms)


def profile_stage2(steps: int = 3) -> None:
    """torch.profiler over `steps` stage-2 sampler steps (configs/
    inference-v02.yaml at full width, random weights: one CFG-batched UNet
    call over 2 × 16 frames at a 128² latent a step) inside
    `blend_refine_batch` on 16 random 1024² frames, after 1 step that is not
    traced; the same report as `profile_serve`.

        python3 chip_smoke.py --profile-stage2"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hi3d_tpu_torch.pipelines.common import load_inference_model
    from hi3d_tpu_torch.pipelines.v2v import blend_refine_batch

    config = os.path.join(ROOT, "configs", "inference-v02.yaml")
    model = load_inference_model(config, None, "cuda", tag="profile")
    video = np.random.default_rng(0).integers(0, 256, (1, model.num_samples, 1024, 1024, 3),
                                              dtype=np.uint8)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    sampler = model.sampler
    inner, calls, clock = sampler.sampler_step, [0], {}

    def traced_step(*args, **kwargs):  # trace steps 2 .. steps + 1
        if calls[0] == 1:
            torch.cuda.synchronize()
            prof.start()
            clock["t0"] = time.perf_counter()
        out = inner(*args, **kwargs)
        calls[0] += 1
        if calls[0] == 1 + steps:
            torch.cuda.synchronize()
            clock["t1"] = time.perf_counter()
            prof.stop()
        return out

    sampler.sampler_step = traced_step
    try:
        blend_refine_batch(model, video, generator=torch.Generator(device="cuda").manual_seed(0),
                           num_steps=1 + steps)
    finally:
        del sampler.sampler_step
    _profile_report(prof, f"stage-2 sampler, {model.num_samples} frames at 1024²", steps,
                    (clock["t1"] - clock["t0"]) * 1e3 / steps)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}",
          flush=True)
    sys.path.insert(0, ROOT)
    if sys.argv[1:] == ["--time-png"]:
        time_png_decode()
        return
    os.makedirs(os.path.join(ROOT, "outputs"), exist_ok=True)

    from hi3d_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.load_library()
    nvcc_s = build.build_seconds if build.build_seconds is not None else 0.0
    print(f"[build] {build.library_path().name}: nvcc {nvcc_s:.1f} s "
          f"(0 = reused), build+load {time.perf_counter() - t0:.1f} s", flush=True)
    if sys.argv[1:] == ["--profile-serve"]:
        profile_serve()
        return
    if sys.argv[1:] == ["--profile-stage2"]:
        profile_stage2()
        return
    if sys.argv[1:] == ["--profile-stage1"]:
        profile_stage1()
        return
    if sys.argv[1:] == ["--profile-train"]:
        profile_train()
        return
    if sys.argv[1:] == ["--time-norms"]:
        time_norms()
        return
    if sys.argv[1:] == ["--time-frame-attention"]:
        time_frame_attention()
        return
    if sys.argv[1:] == ["--time-frame-backward"]:
        time_frame_backward()
        return
    if sys.argv[1:2] == ["--time-block-backward"]:
        time_block_backward(*map(int, sys.argv[2:3]))
        return

    measured = kernel_phase()
    print("[smoke] kernel phase ok", flush=True)
    measured.update(backward_kernel_phase())
    print("[smoke] backward kernel phase ok", flush=True)
    inference = os.path.join(ROOT, "configs", "inference-v01.yaml")
    unet_reference_phase(inference)
    unet_gradient_phase(inference)
    unet_reference_phase(os.path.join(ROOT, "configs", "inference-v02.yaml"))
    # a long clip: every frame-axis site on #6 forward and #7 backward
    unet_reference_phase(inference, b=1, t=40)
    by_path = {"unet_grad_t40": unet_gradient_phase(inference, b=1, t=40)}
    print(f"[smoke] main path 1: configs/inference-v01.yaml, 16×512², {NUM_STEPS} steps, "
          "random weights", flush=True)
    by_path["i2v"], stage1_dir = main_path(NUM_STEPS)
    print(f"[smoke] main path 2: configs/train-v01.yaml, {TRAIN_STEPS} steps, random weights",
          flush=True)
    by_path["train"] = training_path(TRAIN_STEPS)
    print(f"[smoke] main path 2b: configs/train-v01.yaml at 1 × {LONG_CLIP} frames, "
          f"{LONG_CLIP_STEPS} steps, random weights (#7 on every frame-axis site)", flush=True)
    by_path["train48"] = long_clip_training_path()
    print(f"[smoke] main path 3: configs/inference-v02.yaml, 16×1024², {STAGE2_STEPS} steps, "
          "random weights, on main path 1's frames", flush=True)
    by_path["v2v"] = stage2_path(STAGE2_STEPS, stage1_dir)
    print(f"[smoke] main path 4: serve --mode orbit, configs/inference-v01.yaml, "
          f"{SERVE_ASSETS} assets × {SERVE_CLIP}×512², {NUM_STEPS} steps, random weights",
          flush=True)
    by_path["serve"] = serve_path(NUM_STEPS)
    print(f"[smoke] main path 5: pipelines.full, configs/inference-v01.yaml → "
          f"configs/inference-v02.yaml, 16×512² → 16×1024², {NUM_STEPS} steps each, random "
          "weights, U²-Net background removal", flush=True)
    by_path["full"] = full_path(NUM_STEPS)
    print(f"[smoke] main path 6: serve --mode two_stage, {TWO_STAGE_ASSETS} assets × "
          f"{FULL_CLIP}×1024² in batches of 1, {NUM_STEPS} steps each stage, random weights",
          flush=True)
    by_path["two_stage"] = two_stage_path(NUM_STEPS)
    print(f"[smoke] all phases passed in {time.perf_counter() - start:.1f} s", flush=True)

    rows = []
    for name, route, source, replaces in KERNELS:
        m = measured[name]
        counts = {path: launches.get(name, 0) for path, launches in by_path.items()}
        rows.append({"name": name, "route": route, "source": source, "replaces": replaces,
                     "launches": sum(counts.values()), "launches_by_path": counts,
                     "max_abs_err": m["err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
                     "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                     "library_ms": m["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
