"""GPU smoke run of the PyTorch port's inference, training (stage 1 and 2; one process,
and in a process group), serving, autoencoder, text-to-image and module-surface paths on
one NVIDIA H100.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --profile-serve  # only a 2-step profile of the serve batch
    python3 chip_smoke.py --profile-stage2 # only a 3-step profile of the stage-2 sampler
    python3 chip_smoke.py --profile-stage1 # only profiles of main path 1's conditioner and
                                           # of 2 of its sampler steps
    python3 chip_smoke.py --profile-train  # only 2-step profiles of training (2×16, 1×48)
    python3 chip_smoke.py --profile-train2 # only stage-2 training's step in parts, and its
                                           # 2-step profile (1 × 16 × 1024²)
    python3 chip_smoke.py --time-block-backward [MAX_T]  # only #7's times, to compare trees
    python3 chip_smoke.py --time-norms     # only K3's, #10's and #9's times (CUDA events
                                           # and device time) against their library calls
    python3 chip_smoke.py --time-frame-attention  # only K2's times at its five main-path
                                           # sites, against #6 and SDPA
    python3 chip_smoke.py --time-frame-backward   # only #5's times at its four training
                                           # sites, against #7 and SDPA's backward
    python3 chip_smoke.py --time-png       # only a 512² Average/Paeth PNG decode, C against
                                           # the plain Python unfilter, on the host's CPU
    python3 chip_smoke.py --replay-degradation [PLANS]  # only the stage-2 degradation on
                                           # the card against its CPU replay at 1024²
    python3 chip_smoke.py --t2i            # only main paths 14 and 15 with their phases
    python3 chip_smoke.py --module-surface # only main path 16 (16 random frames stand in
                                           # for path 1's)

1. prints the card (nvidia-smi name and power limit) and fails without CUDA;
2. builds the kernels from this checkout (`hi3d_tpu_torch/csrc`);
3. runs each forward kernel (K1, K2, #6 segment attention, K3, #9 GroupNorm
   statistics, #10 LayerNorm) and each backward kernel (#3, #5, #7, and the
   K3 and #10 autograd Functions) against its plain PyTorch version at the
   main paths' shapes, K2 and K3 also at the half batch of --cfg_interval's
   single passes, #3 and #5 also at stage-2 training's level-0 site (B16
   S16384 H5, B1 T16 S16384 C320) (error against a stated tolerance,
   CUDA-event times),
   beside the one PyTorch call that computes the same function, where there
   is one (`library_ms`), and the least time the card could take (`bound_ms`);
4. runs the full-width stage-1 UNet once at a small input on the card and
   holds its output, then its parameter gradient, against the same weights
   on the CPU (plain versions, fp32 and bf16); the same for the output and
   the gradient of the full-width stage-2 UNet (17 input channels), and for
   the stage-1 UNet's gradient and, from the same passes, its output at a
   33-frame clip (every frame-axis site on #6/#7);
5. main path 1: `hi3d_tpu_torch.pipelines.i2v.main` on `demo/3.png` at full
   width (configs/inference-v01.yaml, 16×512², random weights); checks the
   frames and every kernel's launch count against the model's plan;
6. main path 2: `hi3d_tpu_torch.train.main` on configs/train-v01.yaml at
   full width (2 videos × 16 × 512² per step, random weights, renders made
   from demo/3.png) for 4 steps with the JAX CLI's defaults: the image
   logger dumps at the last step (`batch_frequency` set to the step count),
   the post-train test pass runs on an eval folder holding demo/3.png, and
   `--outckpt` exports the weights; checks finite losses, moved parameters,
   a reloadable checkpoint, every media file of the dump (`_check_dump`),
   that the test pass ended as JAX's does, the export's keys and a sample of
   its values (`_check_export`) and the launch counts (training plus one
   `log_images`); then 3 steps on one video of 48 frames a step (a dense
   ring of renders, `long_clip_config`, `--no_test True`): finite losses and
   launch counts with #6/#7 on every frame-axis site;
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
11. main path 7: `i2v.main --cfg_interval 0.3 6` as path 1 (CFG on steps
   15–19, one conditioned pass of 16 frames on the other 20) on
   tests/data/torch_jpeg/demo3_q90.jpg (demo/3.png as a JPEG); main path 8:
   `v2v.main --encoder_reuse 3` on path 1's frames (9 whole UNet calls, 16
   from the encoder cache); main path 9: `generate_orbit` on one stage-1
   engine with each other sampler (Heun, Euler ancestral, DPM++(2S) at η =
   1, LMS at order 4, DPM++(2M)), 4 steps each, then Heun with
   encoder_reuse=2. Each checks its frames, its UNet calls (`UNetProbe`: by
   kind and batch, with the median CUDA-event ms of a call) and launches
   against the plan (`unet_calls`), and prints its sampler seconds beside
   path 1's or 3's (path 8 also its peak memory);
12. main path 10: `hi3d_tpu_torch.train.main` on configs/train-v02.yaml at
   full width (1 video × 16 × 1024² a step, all parameters trained, random
   weights) for 3 steps on 96 RGBA 1024² renders made from demo/3.png; the
   conditioning video is degraded on the card (data/degradation.py). Checks
   finite losses and gradient norms, that out.2 moved, step 1's degraded
   video (finite, in [-1, 1], frame 0 clean, background white, the other
   frames changed; each of its operations against the CPU on the card's
   input; two more runs of its plan on the card bit-equal), a reloadable
   checkpoint (written and deleted: weights and AdamW moments, ~24 GB), the
   dump, the test pass and the export as path 2 does, and the launch counts;
   prints s/step, `cond_s`, peak memory and the degradation's seconds a
   step;
13. main path 11: `hi3d_tpu_torch.train.main` on configs/train-v01.yaml
   under a world-1 NCCL process group, as `torchrun --nproc_per_node 1`
   starts it (the environment set for the call and put back after), 2
   steps at full width with `--no_test True`, trained data parallel with
   the ZeRO-2 AdamW (`parallel/zero.py`): finite losses, launches equal to
   the training plan, the consolidated checkpoint with path 2's keys and
   shapes and AdamW's state over every trained tensor, resumed by a plain
   Trainer (no group); from that state, one plain step and one ZeRO step
   of one batch with one generator seed (cuDNN deterministic for both):
   the loss and every parameter bit-equal, the gradient norm within 1e-6;
   then the same step with `param_sharding="fsdp"`, held to the same;
   prints s/step, peak memory and the reduce-scatter and all-gather ms
   beside path 2's, and the bytes of trained state each step keeps between
   steps;
14. main path 12: `training.ae_step.AutoencoderTrainer` on an
   `AutoencodingEngine` with configs/inference-v01.yaml's VAE (Encoder,
   2-D Decoder, a sampling Gaussian regularizer), a 3-layer PatchGAN and a
   VGG16 LPIPS, 4 steps (generator, discriminator, twice) on 2 × 512²
   render frames with TF32 off: finite losses and d_weight, the encoder and
   decoder moving on generator steps and the discriminator on the others,
   #9 launches equal to the plan, and one 1 × 128² generator pass on the
   card against the CPU (`ae_pass_errors`); prints s/step by pass and the
   peak;
15. main path 13: SVD's first stage (`models.autoencoding.
   SVD_FIRST_STAGE_CONFIG`: Encoder, conv-only temporal VideoDecoder)
   encodes main path 1's 16 frames and decodes them as one video, and a
   time_mode "all" VideoDecoder decodes the same latents: finite outputs,
   #9 and #10 launches equal to the plan (no K2 or #6: the frame attention
   of head dim 512 in fp32 is plain), skip_video equal to the 2-D decoder;
   prints seconds and the peak;
16. main path 14: SD 2.1 text-to-image from hi3d_tpu_torch/configs/sd_2_1.yaml
   at full width (865 M UNet, OpenCLIP ViT-H/14 text `penultimate`, random
   weights): first the UNetModel at a 16² latent in bf16 on the card against
   fp32 on the CPU (within 1.5 × the plain bf16 error) and its gradient at a
   32² latent through use_checkpoint (every gradient finite, #3 once per
   transformer block); then the conditioner on 2 prompts' ids and the empty
   prompt's, 25 EulerEDMSampler steps (LegacyDDPMDiscretization, VanillaCFG
   7.5) over 2 × 4 × 64² latents, one B4 ConcatConditionWrapper(UNetModel)
   call under DiscreteDenoiser a step, the fp32 AutoencoderKL decode to 2 ×
   512² PNGs (outputs/t2i/); finite outputs, 25 calls, launches equal to
   `t2i_launches`, seconds and the peak;
17. main path 15: FrozenCLIPT5Encoder (CLIP ViT-L/14 text, a T5 encoder at
   google/t5-v1_1-xl's widths) and FrozenCLIPEmbedder (hidden layer 11) in
   bf16 against fp32 on the CPU, InceptionV3 on main path 1's 16 frames in
   fp32 on both sides, and every other new embedder once (finite, JAX's
   shapes); launches equal to `towers_launches` (`--t2i` runs paths 14–15
   alone);
18. prints the kernel JSON line (launches per path and summed, errors, times,
   bounds), the card line, and the contract line last.

The training paths log metrics every step (`metrics_every_step`; the CLI
logs every 10th, as JAX's) so that every step's sec_per_step is read.

Any failure raises and exits non-zero.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
NUM_STEPS = 25  # the configured sampler steps (configs/inference-v01.yaml)
TRAIN_STEPS = 4  # optimizer steps of configs/train-v01.yaml
# frames of the UNet checks on #6/#7: the shortest clip past K2's 32 frames
# (the host CPU's fp32 and bf16 passes of the full-width UNet scale with it)
LONG_UNET_CLIP = 33
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
# K2 at the single-pass steps of --cfg_interval (one video, not CFG-doubled)
# at stage 1's 64² site: printed, not in the JSON sums
K2_HALF_SITES = ((1, 16, 4096, 320),)

# K3's cases (shape, act, time-stack view): the 2-D norms of a stage-1 UNet
# call at 64² (2 × 16 frames), a 32² time stack, the stage-1 and serve (4
# videos × 48 frames) time-stack views at 64², and a stage-2 2-D norm at 128²
K3_CASES = (((32, 320, 64, 64), None, False), ((32, 320, 64, 64), "silu", False),
            ((2, 640, 16, 32, 32), "silu", False), ((2, 320, 16, 64, 64), "silu", True),
            ((4, 320, 48, 64, 64), "silu", True), ((32, 320, 128, 128), "silu", False))
# K3 at the single-pass steps of --cfg_interval (16 frames of one video): a
# 2-D norm at 64² and the time-stack view; printed, not in the JSON sums
K3_HALF_CASES = (((16, 320, 64, 64), "silu", False), ((1, 320, 16, 64, 64), "silu", True))


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
    for (b, t, s, c), summed in [(site, True) for site in K2_SITES] + [
            (site, False) for site in K2_HALF_SITES]:
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
               *frame_attention_work(b, t, s, c), summed)
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
    for (shape, act, view), summed in [(case, True) for case in K3_CASES] + [
            (case, False) for case in K3_HALF_CASES]:
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
               *group_norm_work(shape), summed)

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
    # (and main path 13's fp32 time_mix_block rows, 16 frames × 4096 tokens × 512)
    for m, c, dtype, eps in ((32 * 16384, 320, bf16, 1e-5), (16 * 577, 768, torch.float32, 1e-6),
                             (16 * 4096, 512, torch.float32, 1e-5)):
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
    # Library: torch.var_mean over the group view. The third case is main path
    # 13's time stack: (B, C, T, H, W) of SVD's decoder at the 64² latent
    for shape, eps in (((1, 128, 1024, 1024), 1e-6), ((16, 256, 96, 96), 1e-5),
                       ((1, 512, 16, 64, 64), 1e-6)):
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
    from torch.nn.attention import SDPBackend, sdpa_kernel

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

    def library_grad_ms(fn, ins, dout, backend=None):
        """`backend`: the SDPA backend to hold the call to (its default
        choice otherwise)."""
        leaves = [t.detach().requires_grad_() for t in ins]
        with contextlib.nullcontext() if backend is None else sdpa_kernel(backend):
            out = fn(*leaves)
            return time_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True),
                           reps=3)

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

    # #3 at the training path's four sites, stage 2's level-1 site (B2
    # S16384 H5, as in `kernel_phase`) and stage-2 training's level-0 site
    # (B16 S16384 H5, main path 10); the S16384 cases printed, not in the
    # JSON sums
    for b, s, h in ((4, 4096, 5), (4, 1024, 10), (4, 256, 20), (4, 64, 20), (2, 16384, 5),
                    (16, 16384, 5)):
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

    # #5 at the training path's four sites, and at stage-2 training's
    # level-0 site (B1 T16 S16384 C320, main path 10; printed, not in the
    # JSON sums). There SDPA's (1, 81920, 16, 64) view is past what its
    # default (cuDNN) backend launches, so the library call is SDPA's math
    # backend
    for b, t, s, c, summed in [(*site, True) for site in B5_SITES] + [(1, 16, 16384, 320, False)]:
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
                  base[:3], _sdpa_frames(base[3], h, 64),
                  None if summed else SDPBackend.MATH),
              *frame_backward_work(b, t, s, c), summed=summed)

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

    def count(build, cls, prefix: str = "") -> int:
        with torch.device("meta"):
            return sum(isinstance(m, cls) for name, m in build().named_modules()
                       if name.startswith(prefix))

    def unet():
        return instantiate_from_config(p["network_config"])

    return {"unet": count(unet, LayerNorm32),
            "unet_dec": count(unet, LayerNorm32, "output_blocks."),
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


def _has_embedder(cfg: dict, target_suffix: str) -> bool:
    return any(e["target"].endswith(target_suffix)
               for e in cfg["model"]["params"]["conditioner_config"]["params"]["emb_models"])


def _frame_kernels(route: str, fwd: int, bwd: int) -> dict:
    """Launches of the frame-axis kernels on `route`, the answer of
    `ops.attention.frame_attention_kernel`: its kernel carries `fwd`
    forward and `bwd` backward launches, the other kernel none; "plain"
    launches neither."""
    counts = {}
    for name in ("temporal_attention", "temporal_block_attention"):
        counts[name] = fwd if name == route else 0
        counts[f"{name}_backward"] = bwd if name == route else 0
    return counts


def unet_frame_route(config_path: str, t: int) -> str:
    """`ops.attention.frame_attention_kernel` at the config's UNet sites:
    `t` frames of its head dim."""
    from hi3d_tpu_torch.config import load_config
    from hi3d_tpu_torch.ops.attention import frame_attention_kernel

    mp = load_config(config_path)["model"]["params"]
    return frame_attention_kernel(t, mp["network_config"]["params"]["num_head_channels"])


TWO_CALL_SAMPLERS = ("HeunEDMSampler", "DPMPP2SAncestralSampler")


def unet_calls(sampler: str, steps: int, encoder_reuse: int = 0):
    """(whole, decoder-only) UNet calls of `steps` steps of sampler class
    `sampler`: Heun and DPM++(2S) call the UNet twice a step but once on
    the last (σ_next = 0: the correction / the midpoint is skipped), the
    others once; with `encoder_reuse` k, every call of a step that
    `reuse_flags` marks decodes from the cache. A CFG-doubled and a
    single-pass call launch the same kernels."""
    from hi3d_tpu_torch.diffusion.encoder_reuse import reuse_flags

    reuse = reuse_flags(steps, encoder_reuse) if encoder_reuse else [False] * steps
    calls = [2 if sampler in TWO_CALL_SAMPLERS and i < steps - 1 else 1 for i in range(steps)]
    return (sum(c for c, r in zip(calls, reuse) if not r),
            sum(c for c, r in zip(calls, reuse) if r))


def expected_launches(config_path: str, steps: int, path: str, clip_size=None,
                      assets: int = 1, sampler=None, encoder_reuse: int = 0) -> dict:
    """Launches per kernel that the model's plan predicts for one run of
    `path` ("i2v", "train", "v2v", "serve": `assets` assets of `clip_size`
    frames in one batch, "refine": stage 2 on `assets` videos in one batch,
    "unet_grad": one forward and backward of the UNet alone at `clip_size`
    frames, or "log_images": the engine's `log_images` on one video with
    `steps` sampler steps; the config's clip length by default), inference
    with `sampler` (a class name; the config's by default) and
    `encoder_reuse` (`unet_calls`). The two-stage paths sum these
    (`full_launches`, `two_stage_launches`).

    UNet, per call (inference: one CFG-batched call per sampler step): K1
    and the frame-axis kernel once per transformer block of every
    SpatialVideoTransformer — K2 up to 32 frames, #6 above, as
    `ops.attention.frame_attention_kernel` decides; K3 four times per
    VideoResBlock (spatial and time-stack in/out norms), once per
    transformer `norm`, once for the UNet's `out.0`; #10 once per
    LayerNorm32 of the UNet. A decoder-only call (encoder reuse) runs the
    output blocks and `out` alone: their share of each count. Training (`accumulate_grad_batches` UNet calls
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
    DPT (one call on all 16 frames). Stage-2 training encodes every frame
    twice (the engine's latents, the conditioner's cond-video latents), in
    chunks of 1 each."""
    from hi3d_tpu_torch.config import load_config
    from hi3d_tpu_torch.models.unet import _build_plan

    cfg = load_config(config_path)
    mp = cfg["model"]["params"]
    p = mp["network_config"]["params"]
    depth = p.get("transformer_depth", 1)
    depth = [depth] * len(p["channel_mult"]) if isinstance(depth, int) else depth
    inp, mid, out = _build_plan(p["model_channels"], p["channel_mult"], p["num_res_blocks"],
                                p["attention_resolutions"], depth)

    def part(plan):
        """(transformer blocks, SpatialVideoTransformers, VideoResBlocks)"""
        specs = [s for block in plan for s in block]
        return (sum(s[2] for s in specs if s[0] == "attn"),
                sum(1 for s in specs if s[0] == "attn"), sum(1 for s in specs if s[0] == "res"))

    blocks, n_attn, n_res = part(inp + [mid] + out)
    dec_blocks, dec_attn, dec_res = part(out)
    sites = norm_sites(config_path)
    t = clip_size or mp["num_samples"]
    route = unet_frame_route(config_path, t)
    engine_chunk = mp.get("en_and_decode_n_samples_a_time")
    enc_chunk = _embedder(cfg, "VideoPredictionEmbedderWithEncoder").get(
        "en_and_decode_n_samples_a_time")
    if path == "log_images":
        # one video: i2v's plan (stage 2: refine's), the engine's encode of
        # the frames at stage 1 (refine has it), the reconstructions' decode;
        # stage 2 then conditions again with ucg off and decodes the
        # conditioning latents
        depth = _has_embedder(cfg, "DepthEmbedder")
        base = expected_launches(config_path, steps, "refine" if depth else "i2v", clip_size=t)
        decode = {"group_stats": sites["decoder"] * _chunks(t, engine_chunk)}
        if not depth:
            encode = {"group_stats": sites["encoder"] * _chunks(t, engine_chunk)}
            return _sum_launches(base, encode, decode)
        again = {"group_stats": sites["dpt_gn"] + sites["encoder"] * _chunks(t, enc_chunk),
                 "layer_norm": sites["vit_h"] + sites["dpt_ln"]}
        return _sum_launches(base, decode, again, decode)
    if path in ("train", "unet_grad"):
        calls = 1 if path == "unet_grad" else steps * cfg.get("lightning", {}).get(
            "trainer", {}).get("accumulate_grad_batches", 1)
        fwd = 2 if p.get("use_checkpoint") else 1
        grad = {"flash_attention": calls * fwd * blocks,
                **_frame_kernels(route, calls * fwd * blocks, calls * blocks),
                "group_norm": calls * (fwd * (4 * n_res + n_attn) + 1),
                "flash_attention_backward": calls * blocks}
        if path == "unet_grad":  # one UNet forward and backward, nothing else
            return {**grad, "group_stats": 0, "layer_norm": fwd * sites["unet"]}
        batch = cfg["data"]["params"]["batch_size"]
        frames = batch * t
        if _has_embedder(cfg, "DepthEmbedder"):
            # stage 2: ViT-H on frame 0, the DPT on all the frames in one
            # call, the VAE embedder on every frame
            cond_gs = sites["dpt_gn"] + sites["encoder"] * _chunks(frames, enc_chunk)
            cond_ln = sites["vit_h"] + sites["dpt_ln"]
        else:
            # stage 1: ViT-H on frame 0, the aesthetic ViT-L, the VAE
            # embedder on each video's frame 0
            cond_gs = sites["encoder"] * _chunks(batch, enc_chunk)
            cond_ln = sites["vit_h"] + sites["vit_l"]
        # and the engine's VAE encodes the batch's frames
        return {**grad,
                "group_stats": calls * (sites["encoder"] * _chunks(frames, engine_chunk)
                                        + cond_gs),
                "layer_norm": calls * (fwd * sites["unet"] + cond_ln)}
    sampler = sampler or mp["sampler_config"]["target"].rsplit(".", 1)[1]
    whole, dec = unet_calls(sampler, steps, encoder_reuse)
    attn = whole * blocks + dec * dec_blocks
    unet = {"flash_attention": attn, "flash_attention_backward": 0,
            **_frame_kernels(route, attn, 0),
            "group_norm": whole * (4 * n_res + n_attn + 1) + dec * (4 * dec_res + dec_attn + 1)}
    unet_ln = whole * sites["unet"] + dec * sites["unet_dec"]
    if path in ("i2v", "serve"):  # the conditioner encodes each asset's frame 0; the
        # engine decodes the assets' T frames
        return {**unet,
                "group_stats": sites["encoder"] * _chunks(assets, enc_chunk)
                + sites["decoder"] * _chunks(assets * t, engine_chunk),
                "layer_norm": unet_ln + sites["vit_h"] + sites["vit_l"]}
    # v2v, refine: the conditioner (DPT on all the frames in one call, then
    # the VAE embedder) and the engine each encode the assets' T frames; the
    # engine decodes them
    frames = assets * t
    return {**unet,
            "group_stats": sites["dpt_gn"] + sites["encoder"] * (_chunks(frames, enc_chunk)
                                                                 + _chunks(frames, engine_chunk))
            + sites["decoder"] * _chunks(frames, engine_chunk),
            "layer_norm": unet_ln + sites["vit_h"] + sites["dpt_ln"]}


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


def _full_width_unet(config_path: str, b: int = 2, t: int = 4, hw: int = 16, overrides=None):
    """The config's full-width UNet on the card, fp32 weights, seeded; the
    zero-initialised leaves (out convs, proj_out) get random values: with
    them at zero the output would be 0 whatever the kernels do. `overrides`
    replace network parameters (main path 16's options). Inputs: `b` videos
    of `t` frames at an `hw`² latent."""
    import torch

    from hi3d_tpu_torch.config import instantiate_from_config, load_config

    cfg = load_config(config_path)["model"]["params"]["network_config"]
    cfg = {**cfg, "params": {**cfg["params"], **(overrides or {})}}
    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(0)
        unet = instantiate_from_config(cfg).eval()
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for p in unet.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=gen)
    p = cfg["params"]
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


def unet_module_launches(net, t: int, time_context: bool = False) -> dict:
    """Launches of one forward of a VideoUNet, counted from the module: K1
    once per BasicTransformerBlock, the frame kernel of `t` frames once per
    frame self-attention its SpatialVideoTransformers run
    (`frame_self_attentions`: two a temporal block without the spatial
    context or a time_context), K3 once per GroupNorm32 and #10 once per
    LayerNorm32."""
    from hi3d_tpu_torch.models.attention import BasicTransformerBlock, LayerNorm32
    from hi3d_tpu_torch.models.layers import GroupNorm32
    from hi3d_tpu_torch.models.video_attention import SpatialVideoTransformer
    from hi3d_tpu_torch.ops.attention import frame_attention_kernel

    mods = list(net.modules())
    svt = [m for m in mods if isinstance(m, SpatialVideoTransformer)]
    frames = sum(m.frame_self_attentions(time_context) for m in svt)
    d = svt[0].transformer_blocks[0].attn1.dim_head
    return {"flash_attention": sum(isinstance(m, BasicTransformerBlock) for m in mods),
            "flash_attention_backward": 0,
            **_frame_kernels(frame_attention_kernel(t, d), frames, 0),
            "group_norm": sum(isinstance(m, GroupNorm32) for m in mods), "group_stats": 0,
            "layer_norm": sum(isinstance(m, LayerNorm32) for m in mods)}


def unet_reference_phase(config_path: str, b: int = 2, t: int = 4, hw: int = 16,
                         overrides=None, label: str = "") -> dict:
    """The full-width UNet of the config, one call at a small input (`b`
    videos × `t` frames, `hw`² latent; `overrides` replace network
    parameters): bf16 on the card through K1, the frame kernel of `t`
    frames (K2 or #6) and K3, held against the same weights in fp32 on the
    CPU through the plain versions. Returns the card call's launches, which
    must equal `unet_module_launches` of the module; prints each pass's
    seconds.

    Tolerance: bf16 itself is ~1.6e-2 of relative L2 error here (the plain
    versions in bf16 on the CPU measure that in the same run), so the card's
    error may exceed the plain bf16 path's by at most half of it."""
    import copy

    import torch

    t0 = time.perf_counter()
    unet, inputs, t = _full_width_unet(config_path, b, t, hw, overrides)
    expected = unet_module_launches(unet, t)
    cpu = copy.deepcopy(unet).to("cpu", torch.float32)
    unet.to(torch.bfloat16)
    secs = {"build": time.perf_counter() - t0}
    reset_launches()
    with torch.no_grad():
        t1 = time.perf_counter()
        out = _run_unet(unet, inputs, t, "cuda").float().cpu()
        launches = read_launches(expected)
        secs["card"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        ref = _run_unet(cpu, inputs, t, "cpu").float()
        secs["cpu fp32"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        plain = _run_unet(cpu.to(torch.bfloat16), inputs, t, "cpu").float()  # cast in place
        secs["cpu bf16"] = time.perf_counter() - t1
    _check_launches(launches, expected)
    if not torch.isfinite(out).all():
        raise AssertionError("UNet output on the card is not finite")
    rel, plain_rel = (((a - ref).norm() / ref.norm()).item() for a in (out, plain))
    print(f"[smoke] full-width UNet of {os.path.basename(config_path)}{label}, {b}×{t} frames at "
          f"{hw}² latent, vs CPU fp32: card bf16 relative L2 error {rel:.3e}, plain bf16 "
          f"{plain_rel:.3e} (tol {1.5 * plain_rel:.3e}); launches {launches}; seconds "
          f"{ {k: round(v, 1) for k, v in secs.items()} } ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    if not rel <= 1.5 * plain_rel:
        raise AssertionError(f"UNet on the card: error {rel} > 1.5 × plain bf16 {plain_rel}")
    del unet, cpu
    torch.cuda.empty_cache()
    return launches


def unet_gradient_phase(config_path: str, b: int = 2, t: int = 4, outputs: bool = False) -> dict:
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
    UNet's plan for one forward and backward. With `outputs`, the forward
    outputs of the same passes are held as `unet_reference_phase` holds
    its: the card's within 1.5× the plain bf16 path's error. Prints each
    pass's seconds. Returns the launches."""
    import copy

    import torch

    t0 = time.perf_counter()
    unet, inputs, t = _full_width_unet(config_path, b, t)
    cpu = copy.deepcopy(unet).to("cpu")
    cpu.use_checkpoint = False
    gen = torch.Generator().manual_seed(5)
    out_shape = (inputs["x"].shape[0], 4, *inputs["x"].shape[2:])
    cot = torch.randn(out_shape, generator=gen)
    secs = {"build": time.perf_counter() - t0}

    def grads(net, dev, dtype, label):
        t1 = time.perf_counter()
        net.dtype = dtype
        net.zero_grad(set_to_none=True)
        out = _run_unet(net, inputs, t, dev).float()
        loss = (out * cot.to(dev)).mean()
        loss.backward()
        gs = [torch.zeros(p.numel()) if p.grad is None else p.grad.detach().float().flatten().cpu()
              for p in net.parameters()]
        secs[label] = time.perf_counter() - t1
        return gs, loss.item(), out.detach().cpu()

    expected = expected_launches(config_path, 1, "unet_grad", clip_size=t)
    reset_launches()
    card, card_loss, card_out = grads(unet, "cuda", torch.bfloat16, "card")
    launches = read_launches(expected)
    _check_launches(launches, expected)
    ref, ref_loss, ref_out = grads(cpu, "cpu", torch.float32, "cpu fp32")
    plain, _, plain_out = grads(cpu, "cpu", torch.bfloat16, "cpu bf16")
    names = [n for n, _ in unet.named_parameters()]
    # per-tensor norms find the candidates (a non-finite entry makes the norm
    # non-finite; a norm of 0 means zeros, or entries whose squares
    # underflow); each candidate is checked entry by entry
    card_n, ref_n = (torch.stack(torch._foreach_norm(gs)) for gs in (card, ref))
    for i in torch.nonzero(~torch.isfinite(card_n)).flatten().tolist():
        if not torch.isfinite(card[i]).all():
            raise AssertionError(f"gradient of {names[i]} on the card is not finite")
    for i in torch.nonzero(card_n == 0).flatten().tolist():
        if ref[i].any() and not card[i].any():
            raise AssertionError(f"gradient of {names[i]} is 0 on the card, nonzero in the "
                                 "reference")
    zero_ref = sum(not ref[i].any() for i in torch.nonzero(ref_n == 0).flatten().tolist())
    # relative L2 over all the gradients from per-tensor norms, summed in
    # float64 (no concatenated copies of the 1.5 G values)
    ref_sq = ref_n.double().square().sum().item()
    rel, plain_rel = ((torch.stack(torch._foreach_norm(torch._foreach_sub(gs, ref))).double()
                       .square().sum().item() / ref_sq) ** 0.5 for gs in (card, plain))
    numel = sum(r.numel() for r in ref)
    out_line = ""
    if outputs:
        out_rel, out_plain = (((a - ref_out).norm() / ref_out.norm()).item()
                              for a in (card_out, plain_out))
        out_line = (f"; its forward output: card relative L2 error {out_rel:.3e}, plain bf16 "
                    f"{out_plain:.3e} (tol {1.5 * out_plain:.3e})")
        if not torch.isfinite(card_out).all() or not out_rel <= 1.5 * out_plain:
            raise AssertionError(f"UNet output on the card: error {out_rel} > 1.5 × plain bf16 "
                                 f"{out_plain}")
    print(f"[smoke] full-width UNet gradient, {b}×{t} frames ({len(names)} tensors, "
          f"{numel} values), loss card {card_loss:.6f} ref {ref_loss:.6f}: card relative L2 "
          f"error {rel:.3e}, plain bf16 {plain_rel:.3e} (tol {1.5 * plain_rel:.3e}); every "
          f"gradient finite, nonzero where the reference's is ({zero_ref} structurally zero in "
          f"both){out_line}; seconds { {k: round(v, 1) for k, v in secs.items()} } "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not rel <= 1.5 * plain_rel:
        raise AssertionError(f"UNet gradient on the card: error {rel} > 1.5 × plain bf16 {plain_rel}")
    del unet, cpu
    torch.cuda.empty_cache()
    return launches


def reference_phases() -> dict:
    """Phase 4: the full-width UNets of both stages on the card against the
    CPU, output and gradient, and the stage-1 UNet's gradient and output at
    a LONG_UNET_CLIP clip (every frame-axis site on #6 forward and #7
    backward). Returns the gradient phases' launches by name."""
    t0 = time.perf_counter()
    inference = os.path.join(ROOT, "configs", "inference-v01.yaml")
    stage2 = os.path.join(ROOT, "configs", "inference-v02.yaml")
    unet_reference_phase(inference)
    unet_gradient_phase(inference)
    unet_reference_phase(stage2)
    by_path = {"unet_grad_stage2": unet_gradient_phase(stage2)}
    # the long clip's output is held inside its gradient phase (the same
    # fp32 reference, the same bound), one full-width build and two CPU
    # forward passes fewer than a reference phase of its own
    by_path[f"unet_grad_t{LONG_UNET_CLIP}"] = unet_gradient_phase(inference, b=1,
                                                                  t=LONG_UNET_CLIP, outputs=True)
    print(f"[smoke] reference phases: {time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


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


class UNetProbe:
    """While active, records every forward of the UNet: its kind ("whole",
    or "decoder" when it decodes from an encoder cache), its batch of frames
    and its CUDA-event time."""

    def __enter__(self):
        import torch

        from hi3d_tpu_torch.models.unet import VideoUNet

        forward = self._forward = VideoUNet.forward
        self.calls = []

        def probed(net, x, *args, encoder_cache=None, **kw):
            events = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            events[0].record()
            out = forward(net, x, *args, encoder_cache=encoder_cache, **kw)
            events[1].record()
            self.calls.append((f"{'decoder' if encoder_cache is not None else 'whole'} "
                               f"B{x.shape[0]}", events))
            return out

        VideoUNet.forward = probed
        return self

    def __exit__(self, *exc):
        from hi3d_tpu_torch.models.unet import VideoUNet

        VideoUNet.forward = self._forward

    def counts(self) -> dict:
        """{"whole B32": calls, ...}"""
        out = {}
        for key, _ in self.calls:
            out[key] = out.get(key, 0) + 1
        return out

    def median_ms(self) -> dict:
        """Median CUDA-event ms of one forward, by kind and batch."""
        import torch

        torch.cuda.synchronize()
        times = {}
        for key, (a, b) in self.calls:
            times.setdefault(key, []).append(a.elapsed_time(b))
        return {key: round(float(np.median(v)), 3) for key, v in times.items()}


def _check_calls(label: str, calls: dict, want: dict) -> None:
    if calls != want:
        raise AssertionError(f"main path {label}: UNet calls {calls}, want {want}")


@contextlib.contextmanager
def _tee_stdout():
    """Within: standard output is echoed and kept; yields the list of the
    written pieces."""
    import io

    class Tee(io.TextIOBase):
        def __init__(self, out):
            self.out, self.text = out, []

        def write(self, text):
            self.out.write(text)
            self.text.append(text)
            return len(text)

        def flush(self):
            self.out.flush()

    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        yield tee.text


def _run_printing_phases(tag: str, fn, argv) -> dict:
    """fn(argv) with its standard output echoed; returns the phase seconds it
    printed on its `[tag] phases {...}` line."""
    with _tee_stdout() as text:
        fn(argv)
    head = f"[{tag}] phases "
    lines = [ln for ln in "".join(text).splitlines() if ln.startswith(head)]
    return json.loads(lines[-1][len(head):])


def main_path(steps: int, flags=(), label: str = "1", want_calls=None,
              image: str = os.path.join(ROOT, "demo", "3.png")):
    """Stage-1 CLI at full width on `image` (with `flags`, path 7's
    --cfg_interval; path 7 reads a JPEG); checks the frames, the UNet's
    calls (`want_calls`: by kind and batch; 25 CFG-doubled calls of 32
    frames by default) and the launches; returns the launch count of each
    kernel, the output directory (its frames feed main paths 3 and 8) and
    the phase seconds."""
    import torch

    from hi3d_tpu_torch.pipelines import i2v

    config = os.path.join(ROOT, "configs", "inference-v01.yaml")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "outputs"))
    expected = expected_launches(config, steps, "i2v")
    reset_launches()
    t0 = time.perf_counter()
    with UNetProbe() as probe:
        phases = _run_printing_phases("i2v", i2v.main, [
            "--denoise_config", config, "--image_path", image,
            "--output_dir", out_dir, "--skip_rembg", "--device", "cuda", "--seed", "0",
            "--num_steps", str(steps), *flags])
    launches = read_launches(expected)
    calls = probe.counts()
    print(f"[smoke] main path {label} {time.perf_counter() - t0:.1f} s, sampler "
          f"{phases['sampler']} s, UNet calls {calls}, median ms a UNet call "
          f"{probe.median_ms()}, launches {launches}", flush=True)
    torch.cuda.empty_cache()
    _check_frames(os.path.join(out_dir, "first_step", "frames"), (16, 512, 512, 3))
    _check_calls(label, calls, want_calls or {"whole B32": steps})
    _check_launches(launches, expected)
    return launches, out_dir, phases


def stage2_path(steps: int, stage1_dir: str, flags=(), label: str = "3", encoder_reuse: int = 0,
                want_calls=None):
    """Stage-2 CLI at full width on main path 1's frames (16×512² → 16×1024²,
    random weights, the DPT's included; with `flags`, path 8's
    --encoder_reuse, written to a directory of its own); checks the refined
    frames, the UNet's calls (by kind and batch; 25 CFG-doubled whole calls
    by default) and the launches; returns the launch count of each kernel,
    the phase seconds and the peak allocated GB."""
    import torch

    from hi3d_tpu_torch.pipelines import v2v

    config = os.path.join(ROOT, "configs", "inference-v02.yaml")
    out_dir = stage1_dir if not flags else tempfile.mkdtemp(
        prefix="chip_smoke_v2v_", dir=os.path.join(ROOT, "outputs"))
    expected = expected_launches(config, steps, "v2v", encoder_reuse=encoder_reuse)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with UNetProbe() as probe:
        phases = _run_printing_phases("v2v", v2v.main, [
            "--denoise_config", config, "--image_path", os.path.join(ROOT, "demo", "3.png"),
            "--video_path", os.path.join(stage1_dir, "first_step", "frames"),
            "--output_dir", out_dir, "--device", "cuda", "--seed", "0",
            "--num_steps", str(steps), *flags])
    launches = read_launches(expected)
    calls = probe.counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[smoke] main path {label} {time.perf_counter() - t0:.1f} s, sampler "
          f"{phases['sampler']} s, peak allocated {peak:.2f} GB, UNet calls {calls}, median ms "
          f"a UNet call {probe.median_ms()}, launches {launches}", flush=True)
    torch.cuda.empty_cache()
    _check_frames(os.path.join(out_dir, "second_step_video", "frames"), (16, 1024, 1024, 3))
    _check_calls(label, calls, want_calls or {"whole B32": steps})
    _check_launches(launches, expected)
    return launches, phases, peak


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


@contextlib.contextmanager
def metrics_every_step():
    """Within: the Trainer that `train.main` builds logs metrics every step
    (the CLI logs every 10th, as JAX's), so each step's sec_per_step is
    read."""
    from hi3d_tpu_torch.training import trainer as mod

    cls = mod.Trainer

    class EveryStep(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, log_every=1, **kwargs)

    mod.Trainer = EveryStep
    try:
        yield
    finally:
        mod.Trainer = cls


class DumpProbe:
    """While active, records each media dump of an `ImageLogger` (a step it
    logs at): its directory, step, seconds (the card synchronised before and
    after) and, per media key, the shape, whether every value is finite, and
    the range. `export` records the seconds of `--outckpt`'s state dict and
    write."""

    def __enter__(self):
        import torch

        from hi3d_tpu_torch import convert
        from hi3d_tpu_torch.training.trainer import ImageLogger

        self.cls, self.orig = ImageLogger, ImageLogger.maybe_log
        self.convert, self.saved = convert, (convert.export_engine_state_dict,
                                             convert.save_safetensors)
        self.dumps, self.export = [], 0.0
        probe = self

        def maybe_log(logger, engine, batch, step):
            if step % logger.every:
                return probe.orig(logger, engine, batch, step)
            stats, log_images = {}, engine.log_images

            def recorded(*args, **kwargs):
                media = log_images(*args, **kwargs)
                stats.update({k: (v.shape, bool(np.isfinite(v).all()), float(v.min()),
                                  float(v.max())) for k, v in media.items()})
                return media

            engine.log_images = recorded
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                probe.orig(logger, engine, batch, step)
            finally:
                del engine.log_images
            torch.cuda.synchronize()
            probe.dumps.append({"dir": logger.dir, "step": step, "media": stats,
                                "seconds": time.perf_counter() - t0})

        def timed(fn):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                probe.export += time.perf_counter() - t0
                return out
            return run

        ImageLogger.maybe_log = maybe_log
        convert.export_engine_state_dict = timed(self.saved[0])
        convert.save_safetensors = timed(self.saved[1])
        return self

    def __exit__(self, *exc):
        self.cls.maybe_log = self.orig
        self.convert.export_engine_state_dict, self.convert.save_safetensors = self.saved


IN_RANGE = ("inputs", "conditioning", "depth-video")  # media that lie in [-1, 1] by make


def _check_dump(probe: DumpProbe, trainer, steps: int, keys, frames: int, out: str) -> str:
    """The dump at the last training step and the post-train test pass,
    against what the JAX CLI does: `keys` media of the first video, finite,
    those of `IN_RANGE` in [-1, 1] (the VAE's outputs are printed with their
    largest overshoot past it), each written under image_log/ (a video as
    `frames` PNG frames in its own directory, the caption as one PNG); the
    test pass ran the logger on the eval set's first item, which
    `log_images` refused with KeyError('video'), printed as JAX prints it,
    and wrote nothing."""
    from hi3d_tpu_torch.utils.png import read_png

    train_dumps = [d for d in probe.dumps if d["dir"] == os.path.join(trainer.logdir, "image_log")]
    test_dumps = [d for d in probe.dumps if d["dir"] == os.path.join(trainer.logdir, "test",
                                                                     "image_log")]
    if [d["step"] for d in train_dumps] != [steps] or len(test_dumps) != 1:
        raise AssertionError(f"dumps {[(d['dir'], d['step']) for d in probe.dumps]}: want one at "
                             f"step {steps} and the test pass")
    dump = train_dumps[0]
    if set(dump["media"]) != set(keys):
        raise AssertionError(f"media keys {sorted(dump['media'])}, want {sorted(keys)}")
    overshoot = {}
    for key, (shape, finite, lo, hi) in dump["media"].items():
        if not finite:
            raise AssertionError(f"media {key!r} {shape} is not finite")
        past = max(-1.0 - lo, hi - 1.0, 0.0)
        if key in IN_RANGE and past > 0:
            raise AssertionError(f"media {key!r} in [{lo}, {hi}], outside [-1, 1]")
        if past > 0:
            overshoot[key] = round(past, 4)
        name = f"step{steps:08d}_{key}_0"
        if len(shape) == 4:  # an image: (1, H, W, 3)
            img = read_png(os.path.join(dump["dir"], f"{name}.png"))
            if img.shape != tuple(shape[1:]) or img.dtype != np.uint8:
                raise AssertionError(f"{name}.png: {img.shape} {img.dtype}, want {shape[1:]}")
            continue
        frame_dir = os.path.join(dump["dir"], name, "frames")
        names = sorted(os.listdir(frame_dir))
        img = read_png(os.path.join(frame_dir, names[-1]))
        if len(names) != frames or img.shape != tuple(shape[2:]):
            raise AssertionError(f"{frame_dir}: {len(names)} frames of {img.shape}, want "
                                 f"{frames} of {shape[2:]}")
    if "[image_log] skipped at step 0: 'video'" not in out:
        raise AssertionError("the test pass did not end as JAX's: no \"[image_log] skipped at "
                             "step 0: 'video'\" line")
    if os.path.exists(os.path.join(trainer.logdir, "test")):
        raise AssertionError("the test pass wrote media, which JAX's does not")
    return (f"dump at step {steps}: {dump['seconds']:.2f} s, media "
            f"{ {k: list(v[0]) for k, v in sorted(dump['media'].items())} }, all finite, "
            f"overshoot past [-1, 1] {overshoot}; test pass "
            f"{test_dumps[0]['seconds']:.3f} s, skipped at step 0: 'video' as JAX's")


def _safetensors_header(path: str):
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n)), 8 + n


def _check_export(path: str, engine, seconds: float) -> str:
    """`--outckpt`'s file: its names are exactly those a strict
    `load_reference_state_dict` of the UNet and of the VAE takes, fp32, and
    the tensors of every 50th UNet name (and every 50th VAE name) equal the
    trained engine's."""
    import torch

    from hi3d_tpu_torch.convert import SAFETENSORS_DTYPES

    header, base = _safetensors_header(path)
    header.pop("__metadata__", None)
    parts = (("model.diffusion_model.", engine.model.diffusion_model),
             ("first_stage_model.", engine.first_stage_model))
    want = {prefix + k: v for prefix, m in parts for k, v in m.state_dict().items()}
    if set(header) != set(want):
        raise AssertionError(f"export names: {len(set(header) - set(want))} extra, "
                             f"{len(set(want) - set(header))} missing")
    if {info["dtype"] for info in header.values()} != {"F32"}:
        raise AssertionError("the export is not all fp32")
    sampled = [n for prefix, m in parts for n in sorted(prefix + k for k in m.state_dict())[::50]]
    with open(path, "rb") as f:
        for name in sampled:
            start, end = header[name]["data_offsets"]
            f.seek(base + start)
            t = torch.frombuffer(bytearray(f.read(end - start)), dtype=SAFETENSORS_DTYPES["F32"])
            if not torch.equal(t.reshape(header[name]["shape"]), want[name].float().cpu()):
                raise AssertionError(f"export tensor {name} differs from the trained engine's")
    return (f"export {os.path.getsize(path) / 2**30:.2f} GiB in {seconds:.1f} s, {len(header)} "
            f"tensors, the names a strict load of the UNet and the VAE takes, "
            f"{len(sampled)} sampled tensors equal to the trained engine's")


def write_eval_folder(root: str) -> str:
    """An eval folder holding a copy of demo/3.png."""
    import shutil

    os.makedirs(root, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "demo", "3.png"), os.path.join(root, "3.png"))
    return root


def _cli_defaults(config: str, steps: int, out_dir: str) -> list:
    """The JAX CLI's defaults for a smoke run: no --no_test, the image
    logger at the last step, an eval folder and --outckpt."""
    return [f"lightning.callbacks.image_logger.params.batch_frequency={steps}",
            f"data.params.eval_folder={write_eval_folder(os.path.join(out_dir, 'eval'))}",
            "--outckpt", os.path.join(out_dir, "export.safetensors")]


STAGE1_MEDIA = ("inputs", "conditioning", "reconstructions", "samples")
STAGE2_MEDIA = STAGE1_MEDIA + ("depth-video", "cond-video")


def training_path(steps: int):
    """`hi3d_tpu_torch.train.main` on configs/train-v01.yaml at full width
    (16×512², the config's batch, random weights) for `steps` steps with the
    JAX CLI's defaults (`_cli_defaults`): finite losses, parameters moved, a
    checkpoint that reloads to the trained state, the dump and the test pass
    (`_check_dump`), the export (`_check_export`), launch counts equal to
    the UNet plan with checkpointing plus one `log_images`. Returns the
    launch count of each kernel, and the median s/step and the training
    peak in GiB."""
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

    sampler_steps = cfg["model"]["params"]["sampler_config"]["params"]["num_steps"]
    expected = _sum_launches(expected_launches(config, steps, "train"),
                             expected_launches(config, sampler_steps, "log_images"))
    reset_launches()
    t0 = time.perf_counter()
    with metrics_every_step(), DumpProbe() as dumps, _tee_stdout() as text:
        trainer = train.main(["--base", config, "--max_steps", str(steps), "--device", "cuda",
                              "--seed", str(seed), "--logdir", out_dir,
                              *_cli_defaults(config, steps, out_dir),
                              f"data.params.base_folder={renders}", "data.params.num_workers=4"])
    launches = read_launches(expected)
    wall = time.perf_counter() - t0
    run_peak = torch.cuda.max_memory_allocated() / 2**30
    rows = [json.loads(line) for line in open(os.path.join(trainer.logdir, "metrics.jsonl"))]
    batch = cfg["data"]["params"]["batch_size"]
    s_per_step = statistics.median(r["sec_per_step"] for r in rows[1:])
    peak = max(r["peak_mem_gb"] for r in rows)
    print(f"[train] {steps} steps in {wall:.1f} s (build, data, checkpoint, dump, test pass and "
          f"export included); batch {batch} videos × 16 frames × 512²; s/step (median of steps "
          f"2-{steps}) {s_per_step:.3f}; peak allocated {peak:.2f} GiB in training, "
          f"{run_peak:.2f} GiB over the run; losses {[round(r['loss'], 5) for r in rows]}; "
          f"launches {launches}", flush=True)
    dump = _check_dump(dumps, trainer, steps, STAGE1_MEDIA, 16, "".join(text))
    export = _check_export(os.path.join(out_dir, "export.safetensors"), trainer.engine,
                           dumps.export)
    print(f"[train] {dump}; {export}", flush=True)
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
    return launches, {"s_per_step": s_per_step, "peak": peak}


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
    with metrics_every_step():
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


STAGE2_TRAIN_STEPS = 3  # optimizer steps of configs/train-v02.yaml (main path 10)


def write_renders_1024(root: str, frames: int = 96) -> str:
    """One folder of `frames` RGBA 1024² PNGs: demo/3.png (`_demo_rgba`)
    doubled in each axis and rolled as `write_renders` rolls it."""
    from hi3d_tpu_torch.utils.png import write_png

    rgba = np.repeat(np.repeat(_demo_rgba(), 2, axis=0), 2, axis=1)
    d = os.path.join(root, "obj00")
    os.makedirs(d, exist_ok=True)
    for i in range(frames):
        band, az = divmod(i, 16)
        write_png(os.path.join(d, f"{i:03d}.png"),
                  np.roll(rgba, (16 * band - 40, 64 * az), axis=(0, 1)))
    return root


# what the card's degradation ops may differ from the CPU's by on the same
# input: filter2d sums 441 fp32 products in another order (≤ 441 · 2⁻²⁴ ·
# Σ|k| · max|x| ≈ 5e-5 for Σ|k| ≤ 1.4 and |x| ≤ 1.45), resize rounds float64
# sums once to float32 (one float32 ulp below 4), the noise is elementwise;
# JPEG is integer arithmetic, so its decoded levels (× 255) must be equal
# (their division by 255 may round differently in the last bit)
DEGRADATION_OP_TOL = {"filter2d": 5e-5, "resize": 2.4e-7, "noise": 1e-6, "jpeg": 0.0}


@contextlib.contextmanager
def _wrapped_degradation_ops(deg, wrap):
    """Within: data/degradation.py's filter2d, resize and jpeg, and `deg`'s
    noise round, each replaced by wrap(name, original)."""
    from hi3d_tpu_torch.data import degradation as mod

    saved = {n: getattr(mod, n) for n in ("filter2d", "resize", "jpeg")}
    try:
        for n, fn in saved.items():
            setattr(mod, n, wrap(n, fn))
        deg._noise_round = wrap("noise", deg._noise_round)
        yield
    finally:
        for n, fn in saved.items():
            setattr(mod, n, fn)
        del deg._noise_round


class DegradationProbe:
    """While active, records every call of `DegradedImages` (the training
    branch of `VideoLDMStage2.add_custom_cond`): its host seconds, the card
    synchronised before and after, and for the first call what its replay
    on the CPU needs (`_replay_degradation`), copied to the host: the clean
    video, masks, kernels, the plan's RandomState as it entered, the noise
    fields drawn on the card, each operation's output in call order (so the
    first call's seconds include those copies) and the degraded video."""

    def __enter__(self):
        import torch

        from hi3d_tpu_torch.data.degradation import DegradedImages

        self.cls, self.orig = DegradedImages, DegradedImages.__call__
        self.seconds, self.first = [], None
        probe = self

        def call(deg, video, masks=None, **kw):
            if probe.first is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = probe.orig(deg, video, masks, **kw)
                torch.cuda.synchronize()
                probe.seconds.append(time.perf_counter() - t0)
                return out
            state, draws, ops = kw["rng"].get_state(), [], []
            deg._noise = lambda *a: draws.append(DegradedImages._noise(*a)) or draws[-1]

            def record(name, fn):
                def op(*args):
                    out = fn(*args)
                    ops.append((name, out.cpu()))
                    return out
                return op

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _wrapped_degradation_ops(deg, record):
                out = probe.orig(deg, video, masks, **kw)
            torch.cuda.synchronize()
            probe.seconds.append(time.perf_counter() - t0)
            del deg._noise
            probe.first = {
                "video": video.detach().cpu(), "masks": masks.cpu(), "out": out.cpu(),
                "kernels": [kw[k].cpu() for k in ("kernel1s", "kernel2s", "sinc_kernels")],
                "state": state, "draws": [d.cpu() for d in draws], "ops": ops}
            return out

        DegradedImages.__call__ = call
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self.orig


def _check_degraded(video, masks, degraded) -> str:
    """The degraded conditioning video of a training step: finite and in
    [-1, 1], frame 0 the clean frame, the background (mask 0) white on the
    other frames, and those frames changed. The range holds for path 10's
    plan, not for every plan: where the last resize is INTER_CUBIC its
    overshoot can leave [-1, 1], in the JAX package as in the port."""
    import torch

    if degraded.shape != video.shape or not torch.isfinite(degraded).all():
        raise AssertionError(f"degraded video {tuple(degraded.shape)} not finite or misshapen")
    if degraded.min() < -1 or degraded.max() > 1:
        raise AssertionError(f"degraded video outside [-1, 1]: "
                             f"[{degraded.min().item()}, {degraded.max().item()}]")
    if not torch.equal(degraded[:, 0], video[:, 0].float()):
        raise AssertionError("frame 0 of the degraded video is not the clean frame")
    background = (masks[:, 1:] == 0)[:, :, None].expand(-1, -1, 3, -1, -1)
    if not background.any() or not torch.all(degraded[:, 1:][background] == 1.0):
        raise AssertionError("the background of the degraded frames is not white")
    change = (degraded[:, 1:] - video[:, 1:]).abs().mean().item()
    if not change > 1e-3:
        raise AssertionError(f"the degraded frames equal the clean ones (mean |Δ| {change})")
    return (f"finite, in [{degraded.min().item():.3f}, {degraded.max().item():.3f}], frame 0 "
            f"clean, background white on {background.float().mean().item():.3f} of the other "
            f"frames' values, mean |degraded − clean| {change:.4f}")


def _replay_degradation(first: dict) -> str:
    """A training step's degradation on the card (`DegradationProbe.first`)
    replayed on the CPU with the plan's RandomState restored and the card's
    noise fields handed back, twice.

    Held: each operation at the sizes the plan gives it (up to 1536²), fed
    the card's input of that operation (the CPU run takes on the card's
    output after each), against the card's output within
    `DEGRADATION_OP_TOL` (JPEG's in grey levels); the operations come in
    the card's order and the CPU run ends on the card's video exactly.

    Printed only: the CPU run left to itself. There the ops' last-bit
    differences now and then flip a uint8 truncation before a JPEG, and so
    a quantised coefficient of an 8×8 block, which the later rounds carry
    on: a few blocks of the clip off by up to 10 grey levels (path 10's plan
    in a chip run), so no bound on that run's values can be tight."""
    import torch

    from hi3d_tpu_torch.data.degradation import DegradedImages

    def run(wrap):
        draws = list(first["draws"])
        cpu = DegradedImages()
        cpu._noise = lambda *a: draws.pop(0)
        rng = np.random.RandomState()
        rng.set_state(first["state"])
        with (contextlib.nullcontext() if wrap is None
              else _wrapped_degradation_ops(cpu, wrap)):
            out = cpu(first["video"], first["masks"], *first["kernels"], rng=rng)
        if draws:
            raise AssertionError(f"the CPU replay left {len(draws)} of the card's noise fields")
        return out

    ops, worst = list(first["ops"]), {}

    def check(name, fn):
        def op(*args):
            if not ops or ops[0][0] != name:
                raise AssertionError(f"the CPU replay calls {name} where the card called "
                                     f"{ops[0][0] if ops else 'nothing'}")
            want = ops.pop(0)[1]
            got = fn(*args)
            if got.shape != want.shape:
                raise AssertionError(f"{name}: {tuple(got.shape)} on the CPU, "
                                     f"{tuple(want.shape)} on the card")
            a, b = ((got, want) if name != "jpeg"
                    else (torch.round(got * 255), torch.round(want * 255)))
            err = (a.double() - b.double()).abs().max().item()
            worst[name] = max(worst.get(name, 0.0), err)
            return want
        return op

    t0 = time.perf_counter()
    n_ops = len(ops)
    forced = run(check)
    if ops:
        raise AssertionError(f"the CPU replay left {len(ops)} of the card's {n_ops} operations")
    if not torch.equal(forced, first["out"]):
        raise AssertionError("the CPU replay fed the card's operations does not end on its video")
    free = run(None)
    seconds = time.perf_counter() - t0
    d = (first["out"] - free).abs() * 127.5
    line = (f"replayed on the CPU ({seconds:.1f} s): {n_ops} operations fed the card's inputs, "
            f"max |Δ| {', '.join(f'{n} {e:.3g}' for n, e in sorted(worst.items()))}; left to "
            f"itself max {d.max().item():.4f} grey levels, mean {d.mean().item():.3g}, "
            f"{(d > 0.5).float().mean().item():.3g} of the values beyond half a level, "
            f"{(d > 1.0).float().mean().item():.3g} beyond one")
    bad = {n: e for n, e in worst.items() if e > DEGRADATION_OP_TOL[n]}
    if bad:
        raise AssertionError(f"the card's degradation ops disagree with the CPU's {bad} "
                             f"(tolerances {DEGRADATION_OP_TOL}): {line}")
    return line


def _degradation_twice(first: dict) -> str:
    """A training step's degradation (`DegradationProbe.first`: its video,
    masks, kernels and plan) run twice more on the card, each from the
    plan's RandomState and a generator seeded 0: the two videos must be
    equal bit for bit. Where they are not, each operation's outputs are
    compared in turn and the first that differs is named."""
    import torch

    from hi3d_tpu_torch.data.degradation import DegradedImages

    def run():
        ops = []

        def record(name, fn):
            def op(*args):
                out = fn(*args)
                ops.append((name, out.clone()))
                return out
            return op

        deg = DegradedImages()
        rng = np.random.RandomState()
        rng.set_state(first["state"])
        with _wrapped_degradation_ops(deg, record):
            out = deg(first["video"].cuda(), first["masks"].cuda(),
                      *(k.cuda() for k in first["kernels"]), rng=rng,
                      generator=torch.Generator("cuda").manual_seed(0))
        return out, ops

    (a, ops_a), (b, ops_b) = run(), run()
    diff = (a.double() - b.double()).abs().max().item() * 127.5
    line = f"two runs on the card: max |Δ| {diff:.6g} grey levels over {len(ops_a)} operations"
    if not torch.equal(a, b):
        bad = next(f"{na} (operation {i})" for i, ((na, x), (_, y)) in enumerate(zip(ops_a, ops_b))
                   if not torch.equal(x, y))
        raise AssertionError(f"the card's degradation is not deterministic: {line}; the first "
                             f"operation that differs: {bad}")
    return line


def replay_degradations(plans: int = 8) -> None:
    """The card's degradation against its CPU replay (`_replay_degradation`),
    and against itself run twice more (`_degradation_twice`), for `plans`
    plans at main path 10's size: samples 0.. of the stage-2
    dataset over path 10's 1024² renders, the plan's RandomState seeded
    100 + i, the fields drawn on the card from a generator seeded i, with
    the precision `train.main` sets. Prints each plan's range and errors;
    fails if a plan breaks the replay's bounds.

        python3 chip_smoke.py --replay-degradation [PLANS]"""
    import shutil

    import torch

    from hi3d_tpu_torch.data.degradation import DegradedImages
    from hi3d_tpu_torch.data.video_dataset import VideoTrainDatasetStage2
    from hi3d_tpu_torch.pipelines.common import configure_precision

    configure_precision()
    out_dir = tempfile.mkdtemp(prefix="chip_replay_", dir=os.path.join(ROOT, "outputs"))
    data = VideoTrainDatasetStage2(write_renders_1024(out_dir), 1024, 1024, 16)
    failed = []
    for i in range(plans):
        sample = data.sample(np.random.RandomState(i))
        batch = {k: torch.from_numpy(np.asarray(sample[k]))[None].cuda()
                 for k in ("video", "masks", "kernel1s", "kernel2s", "sinc_kernels")}
        with DegradationProbe() as probe:
            DegradedImages()(batch.pop("video"), batch.pop("masks"), **batch,
                             rng=np.random.RandomState(100 + i),
                             generator=torch.Generator("cuda").manual_seed(i))
        out = probe.first["out"]
        try:
            line = f"{_replay_degradation(probe.first)}; {_degradation_twice(probe.first)}"
        except AssertionError as e:
            failed.append(i)
            line = str(e)
        print(f"[replay] plan {i}: card {probe.seconds[0]:.4f} s, range "
              f"[{out.min().item():.4f}, {out.max().item():.4f}]; {line}", flush=True)
    shutil.rmtree(out_dir)
    if failed:
        raise AssertionError(f"plans {failed} of {plans} break the replay's bounds")


def stage2_training_path(steps: int = STAGE2_TRAIN_STEPS) -> dict:
    """Main path 10: `hi3d_tpu_torch.train.main` on configs/train-v02.yaml at
    full width (1 video × 16 frames × 1024² a step, the 17-channel UNet with
    every parameter trained, random weights, seed 0) for `steps` steps, on
    one folder of 96 RGBA 1024² renders, with the JAX CLI's defaults
    (`_cli_defaults`). Checks finite losses and gradient norms, that out.2
    moved, the degraded conditioning video of step 1 (`_check_degraded`,
    against its CPU replay: `_replay_degradation`, and against two more runs
    on the card: `_degradation_twice`), a checkpoint that reloads to the
    trained state, the dump and the test pass (`_check_dump`), the export
    (`_check_export`) and launch counts equal to the stage-2 training plan
    plus one `log_images`; prints s/step (the train step alone, median of
    steps 2 on), the seconds of the batch's move and `add_custom_cond` a
    step, the peak allocated memory, the degradation's seconds a step and
    the launches. Returns the launch count of each kernel."""
    import shutil
    import statistics

    import torch

    from hi3d_tpu_torch import train
    from hi3d_tpu_torch.config import instantiate_from_config, load_config

    config = os.path.join(ROOT, "configs", "train-v02.yaml")
    cfg = load_config(config)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train2_", dir=os.path.join(ROOT, "outputs"))
    t0 = time.perf_counter()
    renders = write_renders_1024(os.path.join(out_dir, "renders"))
    print(f"[train2] wrote 96 RGBA 1024² renders in {time.perf_counter() - t0:.1f} s", flush=True)

    # the seeded initial UNet, as train.main builds it (the UNet is the
    # engine's first random draw), kept on the host
    seed = 0
    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(seed)
        unet0 = instantiate_from_config(cfg["model"]["params"]["network_config"])
    init = {n: p.detach().cpu() for n, p in unet0.named_parameters()}
    del unet0
    torch.cuda.empty_cache()

    sampler_steps = cfg["model"]["params"]["sampler_config"]["params"]["num_steps"]
    expected = _sum_launches(expected_launches(config, steps, "train"),
                             expected_launches(config, sampler_steps, "log_images"))
    reset_launches()
    t0 = time.perf_counter()
    with (metrics_every_step(), DegradationProbe() as probe, DumpProbe() as dumps,
          _tee_stdout() as text):
        trainer = train.main(["--base", config, "--max_steps", str(steps), "--device", "cuda",
                              "--seed", str(seed), "--logdir", out_dir,
                              *_cli_defaults(config, steps, out_dir),
                              f"data.params.base_folder={renders}", "data.params.num_workers=4"])
    launches = read_launches(expected)
    wall = time.perf_counter() - t0
    run_peak = torch.cuda.max_memory_allocated() / 2**30
    rows = [json.loads(line) for line in open(os.path.join(trainer.logdir, "metrics.jsonl"))]
    s_per_step = statistics.median(r["sec_per_step"] for r in rows[1:])
    peak = max(r["peak_mem_gb"] for r in rows)
    print(f"[train2] {steps} steps in {wall:.1f} s (build, data, checkpoint, dump, test pass and "
          f"export included); batch 1 video × 16 frames × 1024²; s/step (median of steps "
          f"2-{steps}) {s_per_step:.3f}; batch move and add_custom_cond s a step "
          f"{[round(r['cond_s'], 4) for r in rows]}; peak allocated {peak:.2f} GiB in "
          f"training, {run_peak:.2f} GiB over the run; degradation s a step "
          f"{[round(x, 4) for x in probe.seconds]}; losses {[round(r['loss'], 5) for r in rows]}; "
          f"grad norms {[round(r['grad_norm'], 5) for r in rows]}; launches {launches}",
          flush=True)
    dump = _check_dump(dumps, trainer, steps, STAGE2_MEDIA, 16, "".join(text))
    export = _check_export(os.path.join(out_dir, "export.safetensors"), trainer.engine,
                           dumps.export)
    print(f"[train2] {dump}; {export}", flush=True)
    if [r["step"] for r in rows] != list(range(1, steps + 1)):
        raise AssertionError(f"metrics rows {[r['step'] for r in rows]}")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows):
        raise AssertionError("a training loss or gradient norm is not finite")
    if len(probe.seconds) != steps:
        raise AssertionError(f"{len(probe.seconds)} degradations in {steps} steps")
    first = probe.first
    print(f"[train2] step 1's degraded conditioning video: "
          f"{_check_degraded(first['video'], first['masks'], first['out'])}; "
          f"{_replay_degradation(first)}; {_degradation_twice(first)}", flush=True)

    unet = trainer.engine.model.diffusion_model
    trained = set(trainer.param_names)
    if len(trained) != len(init):
        raise AssertionError(f"{len(trained)} trainable tensors, the UNet has {len(init)}")
    moved = {n for n, p in unet.named_parameters() if not torch.equal(p.detach().cpu(), init[n])}
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
    print(f"[train2] {len(moved)} of {len(trained)} trainable tensors moved, out.2 among them; "
          f"checkpoint {os.path.realpath(trainer.checkpointer.last)} reloads to the trained state "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    _check_launches(launches, expected)
    del state, trainer, unet
    shutil.rmtree(out_dir)  # weights + AdamW moments: tens of GB
    torch.cuda.empty_cache()
    return launches


DIST_TRAIN_STEPS = 2  # optimizer steps of main path 11


@contextlib.contextmanager
def torchrun_env(world_size: int = 1):
    """Within: this process is rank 0 of a `world_size`-process group as
    torchrun names one (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, a free
    MASTER_PORT); the variables are put back after."""
    import socket

    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE=str(world_size), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _timed:
    """Within: the seconds spent in `cls.name` (summed over calls) are
    counted; the `with` target reads as that float after the block."""

    def __init__(self, cls, name: str):
        self.cls, self.name, self.seconds = cls, name, 0.0

    def __enter__(self):
        orig = self.orig = getattr(self.cls, self.name)
        timer = self

        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                timer.seconds += time.perf_counter() - t0

        setattr(self.cls, self.name, run)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)

    def __format__(self, spec: str) -> str:
        return format(self.seconds, spec)


class CollectiveProbe:
    """While active, the CUDA-event ms of every reduce-scatter and
    all-gather into a tensor (the ZeRO step's two collectives), with their
    bytes."""

    NAMES = ("reduce_scatter_tensor", "all_gather_into_tensor")

    def __enter__(self):
        import torch
        import torch.distributed as dist

        self.dist, self.orig, self.calls = dist, {n: getattr(dist, n) for n in self.NAMES}, []
        probe = self

        def timed(name):
            fn = self.orig[name]

            def run(output, input, *args, **kwargs):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(output, input, *args, **kwargs)
                b.record()
                big = max(t.numel() * t.element_size() for t in (output, input))
                probe.calls.append((name, a, b, big))
                return out
            return run

        for n in self.NAMES:
            setattr(dist, n, timed(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.dist, n, fn)

    def ms(self) -> dict:
        """{name: [ms of each call]} (the card synchronised first)."""
        import torch

        torch.cuda.synchronize()
        out = {n: [] for n in self.NAMES}
        for name, a, b, _ in self.calls:
            out[name].append(a.elapsed_time(b))
        return out


def _dist_step_check(engine, batch, host_params, host_opt, lr, want) -> str:
    """The distributed ZeRO step of one batch from the plain step's starting
    state (`host_params`, `host_opt`: weights and AdamW moments on the host),
    under a world-1 NCCL group, against the plain step's loss and updated
    parameters (`want`): the loss and every parameter bit-equal, the
    gradient norm within a stated bound; then the same step with the
    parameters sharded (`param_sharding="fsdp"`), held to the same, its
    parameters gathered for the comparison. Reports each step's seconds and
    the bytes of trained state it keeps between steps (`TrainStep.
    resident_bytes`: at world 1 "fsdp" keeps the parameter slice and the
    moments, without the full flat parameters and gradients)."""
    import torch

    from hi3d_tpu_torch.parallel import dist as pdist
    from hi3d_tpu_torch.parallel.zero import ZeroAdamW
    from hi3d_tpu_torch.training.state import build_optimizer, freeze_frozen
    from hi3d_tpu_torch.training.step import TrainStep

    params = [p for _, p in freeze_frozen(engine, engine.trained_param_keys)]
    report = {}
    with torchrun_env():
        _, own = pdist.init("cuda")
        if not own:
            raise AssertionError("main path 11's step check found a process group already open")
        try:
            for sharding in ("replicated", "fsdp"):
                with torch.no_grad():
                    for p, h in zip(params, host_params):
                        p.grad = None
                        p.copy_(h)
                opt = build_optimizer(params, lr)
                if not isinstance(opt, ZeroAdamW):
                    raise AssertionError(f"the optimizer in a process group is "
                                         f"{type(opt).__name__}")
                opt.load_state_dict(host_opt)
                step = TrainStep(engine.make_loss_fn(), params, opt, param_sharding=sharding)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with CollectiveProbe() as coll:
                    got = step(batch, torch.Generator(device=batch["video"].device).manual_seed(7))
                    loss, norm = float(got["loss"]), float(got["grad_norm"])
                secs = time.perf_counter() - t0
                resident = step.resident_bytes()
                if loss != want["loss"]:
                    raise AssertionError(f"{sharding} step loss {loss!r} != plain {want['loss']!r}")
                with step.gathered():
                    differ = [i for i, (p, w) in enumerate(zip(params, want["params"]))
                              if not torch.equal(p.detach().cpu(), w)]
                    if differ:
                        worst = max((params[i].detach().cpu() - want["params"][i]).abs().max()
                                    .item() for i in differ)
                        raise AssertionError(f"{sharding}: {len(differ)} of {len(params)} "
                                             f"parameters differ from the plain step's (max "
                                             f"|Δ| {worst:.3e})")
                norm_err = abs(norm - want["grad_norm"]) / want["grad_norm"]
                if norm_err > 1e-6:  # sqrt(x²) against x, the norms of the same per-parameter norms
                    raise AssertionError(f"{sharding} grad_norm {norm!r} against the plain "
                                         f"step's {want['grad_norm']!r}")
                report[sharding] = dict(secs=secs, resident=resident, norm_err=norm_err,
                                        ms=coll.ms())
                del opt, step, got
                torch.cuda.empty_cache()
        finally:
            torch.distributed.destroy_process_group()
    rep, fsdp = report["replicated"], report["fsdp"]
    return (f"step check: loss {want['loss']!r} bit-equal, {len(params)} of {len(params)} "
            f"parameters bit-equal after the update, grad_norm relative difference "
            f"{rep['norm_err']:.2e} (bound 1e-6); its collectives reduce-scatter "
            f"{rep['ms']['reduce_scatter_tensor']} ms, all-gather "
            f"{rep['ms']['all_gather_into_tensor']} ms; the fsdp step: loss and every parameter "
            f"bit-equal too, grad_norm {fsdp['norm_err']:.2e}; seconds a step replicated "
            f"{rep['secs']:.3f}, fsdp {fsdp['secs']:.3f}; trained state kept between steps "
            f"replicated {rep['resident']} B ({rep['resident'] / 2**30:.2f} GiB), fsdp "
            f"{fsdp['resident']} B ({fsdp['resident'] / 2**30:.2f} GiB)")


def distributed_training_path(path2: dict, steps: int = DIST_TRAIN_STEPS) -> dict:
    """Main path 11: `hi3d_tpu_torch.train.main` on configs/train-v01.yaml at
    full width (2 × 16 × 512², all parameters) under a world-1 NCCL process
    group, as `torchrun --nproc_per_node 1` starts it, for `steps` steps
    with `--no_test True` and no dump: finite losses, launches equal to the
    training plan, the consolidated checkpoint with path 2's keys and shapes
    and AdamW's state over every trained parameter, resumed by a plain
    (no-group) Trainer; from that state one plain step and one distributed
    ZeRO step of one batch with one generator seed (`_dist_step_check`).
    Prints s/step, peak memory and the collectives' ms beside path 2's
    (`path2`: its s/step and peak). Returns the launch count of each
    kernel."""
    import shutil
    import statistics

    import torch

    from hi3d_tpu_torch import train
    from hi3d_tpu_torch.config import instantiate_from_config, load_config
    from hi3d_tpu_torch.train import resolve_data_batch
    from hi3d_tpu_torch.training.trainer import Checkpointer, Trainer

    config = os.path.join(ROOT, "configs", "train-v01.yaml")
    cfg = load_config(config)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_", dir=os.path.join(ROOT, "outputs"))
    renders = write_renders(os.path.join(out_dir, "renders"))
    eval_dir = write_eval_folder(os.path.join(out_dir, "eval"))  # the data module's setup reads it
    expected = expected_launches(config, steps, "train")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with torchrun_env(), metrics_every_step(), CollectiveProbe() as coll, \
            _timed(Trainer, "state_dict") as consolidate, _timed(Checkpointer, "save") as save:
        trainer = train.main(["--base", config, "--max_steps", str(steps), "--device", "cuda",
                              "--seed", "0", "--logdir", out_dir, "--no_test", "True",
                              f"data.params.base_folder={renders}", "data.params.num_workers=4",
                              f"data.params.eval_folder={eval_dir}"])
    launches = read_launches(expected)
    wall = time.perf_counter() - t0
    run_peak = torch.cuda.max_memory_allocated() / 2**30
    if torch.distributed.is_initialized():
        raise AssertionError("train.main left its process group open")
    rows = [json.loads(line) for line in open(os.path.join(trainer.logdir, "metrics.jsonl"))]
    if [r["step"] for r in rows] != list(range(1, steps + 1)):
        raise AssertionError(f"metrics rows {[r['step'] for r in rows]}")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows):
        raise AssertionError("a training loss or gradient norm is not finite")
    ms = coll.ms()
    s_per_step = statistics.median(r["sec_per_step"] for r in rows[1:])
    peak = max(r["peak_mem_gb"] for r in rows)
    step_coll = [a + b for a, b in zip(ms["reduce_scatter_tensor"], ms["all_gather_into_tensor"])]
    print(f"[dist] main path 11: {steps} steps under a world-1 NCCL group in {wall:.1f} s (build, "
          f"data and the consolidated checkpoint included); s/step {s_per_step:.3f} (path 2 "
          f"{path2['s_per_step']:.3f}); peak allocated {peak:.2f} GiB in training (path 2 "
          f"{path2['peak']:.2f}), {run_peak:.2f} GiB over the run; reduce-scatter ms "
          f"{[round(x, 3) for x in ms['reduce_scatter_tensor']]}, all-gather ms "
          f"{[round(x, 3) for x in ms['all_gather_into_tensor']]} "
          f"({coll.calls[0][3] / 2**30:.2f} GiB each); collectives "
          f"{100 * step_coll[-1] / 1e3 / rows[-1]['sec_per_step']:.3f}% of the last step; the "
          f"final checkpoint: state dict (the moments gathered) {consolidate:.1f} s, written in "
          f"{save:.1f} s; losses {[round(r['loss'], 5) for r in rows]}; launches {launches}",
          flush=True)
    _check_launches(launches, expected)

    # the consolidated checkpoint: path 2's layout, resumed by a plain Trainer
    engine, logdir, lr = trainer.engine, trainer.logdir, trainer.learning_rate
    del trainer
    trainable = [p for p in engine.model.diffusion_model.parameters() if p.requires_grad]
    for p in trainable:
        p.grad = None
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with _tee_stdout():
        plain = Trainer(engine, logdir=logdir, batch_size=2, seed=0, logger_backend="jsonl")
        # a strict load of the UNet: the checkpoint has path 2's keys and shapes
        if plain.resume_if_possible() != steps:
            raise AssertionError("the plain Trainer did not resume at the checkpoint's step")
    opt_state = plain.optimizer.state_dict()["state"]
    if sorted(opt_state) != list(range(len(plain.param_names))) or any(
            opt_state[i][k].shape != p.shape for i, p in enumerate(plain.train_step.params)
            for k in ("exp_avg", "exp_avg_sq")):
        raise AssertionError("the consolidated optimizer state does not cover the trained "
                             "parameters at their shapes")
    resumed_s = time.perf_counter() - t0

    # one batch, one generator seed: the plain step, then the distributed one
    data_cfg, _ = resolve_data_batch(cfg["data"], 1)
    data_cfg["params"] = {**data_cfg["params"], "base_folder": renders, "num_workers": 1,
                          "eval_folder": None}
    loader = instantiate_from_config(data_cfg).setup().train_dataloader()
    host_batch = next(loader)
    loader.close()
    batch = engine.add_custom_cond(plain._device_batch(host_batch), infer=False,
                                   generator=torch.Generator(device="cuda").manual_seed(5))
    params = plain.train_step.params
    host_params = [p.detach().cpu() for p in params]
    host_opt = plain.optimizer.state_dict()
    host_opt = {"param_groups": host_opt["param_groups"],
                "state": {i: {k: v.cpu() for k, v in s.items()}
                          for i, s in host_opt["state"].items()}}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # one convolution algorithm a shape, bit for bit
    try:
        got = plain.train_step(batch, torch.Generator(device="cuda").manual_seed(7))
        want = {"loss": float(got["loss"]), "grad_norm": float(got["grad_norm"]),
                "params": [p.detach().cpu() for p in params]}
        del plain, got
        torch.cuda.empty_cache()
        check = _dist_step_check(engine, batch, host_params, host_opt, lr, want)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"[dist] checkpoint {os.path.realpath(os.path.join(logdir, 'checkpoints', 'last.pt'))}: "
          f"the UNet's keys and shapes, AdamW's per-parameter state over all "
          f"{len(host_params)} trained tensors; a plain Trainer resumed it at step {steps} "
          f"({resumed_s:.1f} s); {check}", flush=True)
    del engine, batch, host_params, host_opt, want
    shutil.rmtree(out_dir)  # tens of GB of checkpoint
    torch.cuda.empty_cache()
    return launches


AE_TRAIN_STEPS = 4  # main path 12: generator, discriminator, generator, discriminator
AE_BATCH = 2  # frames a batch of main path 12
AE_CHECK_SIZE = 128  # the side of the frame in main path 12's card-against-CPU pass
SVD_FRAMES = 16  # main path 13 decodes main path 1's 16 frames as one video


def ae_ddconfig() -> dict:
    """configs/inference-v01.yaml's VAE ddconfig (ch 128, mult (1, 2, 4, 4), 2
    res blocks, z 4, double_z)."""
    from hi3d_tpu_torch.config import load_config

    config = os.path.join(ROOT, "configs", "inference-v01.yaml")
    return dict(load_config(config)["model"]["params"]["first_stage_config"]["params"]["ddconfig"])


def ae_norm_sites(dd: dict) -> dict:
    """#9 launches per call of the encoder, the 2-D decoder and the video
    decoders ("conv-only", "all") on ddconfig `dd` (their FoldedGroupNorms,
    the time stacks' included), and #10 launches per call of the "all"
    decoder (the LayerNorm32s of its time_mix_block) and its VideoAttnBlocks;
    counted on the meta device, each module running once a call."""
    import torch

    from hi3d_tpu_torch.models.attention import LayerNorm32
    from hi3d_tpu_torch.models.layers import FoldedGroupNorm
    from hi3d_tpu_torch.models.temporal_ae import VideoAttnBlock, VideoDecoder
    from hi3d_tpu_torch.models.vae import Decoder, Encoder

    def count(build, cls) -> int:
        with torch.device("meta"):
            return sum(isinstance(m, cls) for m in build().modules())

    return {"encoder": count(lambda: Encoder(**dd), FoldedGroupNorm),
            "decoder": count(lambda: Decoder(**dd), FoldedGroupNorm),
            "video_conv": count(lambda: VideoDecoder(time_mode="conv-only", **dd), FoldedGroupNorm),
            "video_all": count(lambda: VideoDecoder(time_mode="all", **dd), FoldedGroupNorm),
            "video_all_ln": count(lambda: VideoDecoder(time_mode="all", **dd), LayerNorm32),
            "video_all_attn": count(lambda: VideoDecoder(time_mode="all", **dd), VideoAttnBlock)}


def ae_launches(dd: dict, path: str, steps: int = AE_TRAIN_STEPS) -> dict:
    """Launches of every kernel on main path 12 ("ae_train": `steps`
    trainer steps, each one encoder and one decoder call, forward only: the
    FoldedGroupNorm backward is K3's plain version) or 13 ("svd_vae": one
    encode, one conv-only decode, one "all" decode). Every norm is #9, the
    "all" decoder's LayerNorms #10; its VideoAttnBlocks attend twice over
    the frames (attn1, attn2) at head dim ch·mult[-1] in fp32, on the route
    `frame_attention_kernel` picks (plain at SVD's 512); the VAE's spatial
    attention is plain, so no other kernel runs."""
    from hi3d_tpu_torch.ops.attention import frame_attention_kernel

    sites = ae_norm_sites(dd)
    counts = {name: 0 for name, *_ in KERNELS}
    if path == "ae_train":
        counts["group_stats"] = steps * (sites["encoder"] + sites["decoder"])
        return counts
    counts["group_stats"] = sites["encoder"] + sites["video_conv"] + sites["video_all"]
    counts["layer_norm"] = sites["video_all_ln"]
    route = frame_attention_kernel(SVD_FRAMES, dd["ch"] * dd["ch_mult"][-1])
    counts.update(_frame_kernels(route, 2 * sites["video_all_attn"], 0))
    return counts


def _ae_frames(root: str, n: int):
    """(n, 3, 512, 512) fp32 frames in [-1, 1]: the smoke's render
    stand-ins (`write_renders`), read back and composited on white."""
    import torch

    from hi3d_tpu_torch.utils.image import composite_white
    from hi3d_tpu_torch.utils.png import read_png

    folder = os.path.join(write_renders(root, folders=1, frames=n), "obj00")
    rgb = np.stack([composite_white(read_png(os.path.join(folder, f"{i:03d}.png")))
                    for i in range(n)])
    return torch.from_numpy(rgb).permute(0, 3, 1, 2).float() / 127.5 - 1.0


def ae_trainer(device: str = "cuda"):
    """Main path 12's AutoencoderTrainer from seed 0: an AutoencodingEngine
    with `ae_ddconfig()` for the Encoder and the 2-D Decoder and a sampling
    DiagonalGaussianRegularizer; GeneralLPIPSWithDiscriminator with
    disc_start 0, perceptual weight 1 (a full VGG16 LPIPS, its heads made
    non-negative as trained ones are), a 3-layer discriminator whose logit
    conv is scaled ×1000 and the hinge loss; Adam at lr 4.5e-6. At
    `weights_init`'s scale the seed-0 logits are so small that the adaptive
    weight sits on its 1e4 clip; scaled, it is inside it, as a trained
    discriminator's is (the GAN term it weighs, d_weight · g, does not
    change with that scale)."""
    import torch

    from hi3d_tpu_torch.models.autoencoding import AutoencodingEngine
    from hi3d_tpu_torch.models.discriminator import GeneralLPIPSWithDiscriminator
    from hi3d_tpu_torch.training.ae_step import AutoencoderTrainer

    dd = ae_ddconfig()
    torch.manual_seed(0)
    engine = AutoencodingEngine(
        encoder_config={"target": "sgm.modules.diffusionmodules.model.Encoder", "params": dd},
        decoder_config={"target": "sgm.modules.diffusionmodules.model.Decoder", "params": dd},
        regularizer_config={
            "target": "sgm.modules.autoencoding.regularizers.DiagonalGaussianRegularizer",
            "params": {"sample": True}})
    loss = GeneralLPIPSWithDiscriminator(disc_start=0, perceptual_weight=1.0, disc_num_layers=3,
                                         disc_loss="hinge")
    with torch.no_grad():
        for i in range(5):
            getattr(loss.perceptual_loss, f"lin{i}").model[1].weight.abs_()
        for p in loss.discriminator.main[-1].parameters():
            p.mul_(1000.0)
    return AutoencoderTrainer(engine, loss, device=device)


# main path 12's card-against-CPU generator pass, relative errors (L2 for
# tensors). The reconstruction ("rec": the card's forward, #9 at every norm,
# cuDNN's convolutions) differs in summation order only: δ_rec ≤ 1e-4. The
# loss, d_weight (a ratio of two gradient norms), the conv_out weight
# gradients of the NLL, of the GAN term on the discriminator's running
# statistics and of the loss ("total", whose GAN term runs the discriminator
# on the batch's statistics) are built on it and amplify δ_rec by their
# conditioning: each is held at AE_PASS_AMPLIFICATION × δ_rec, at least
# 1e-4. That holds with the CPU side on the card's LeakyReLU slopes
# (`leaky_signs`): an input within rounding of 0 may take the other slope
# on the other side, and one such flip in the last layer moves "total" by
# ~6e-4 (one image's batch statistics) where δ_rec moves it ~1×
# (`ae_pass_conditioning`, PERF.md §6). The share of flipped
# inputs ("slopes") is held at the same bound.
AE_PASS_DERIVED = ("loss", "d_weight", "nll", "g_eval", "total", "slopes")
AE_PASS_AMPLIFICATION = 100.0


def ae_pass_errors(got: dict, want: dict):
    """(relative errors, their bounds) of two `ae_generator_pass` results,
    `want` run on `got`'s LeakyReLU slopes (`ae_pass_on_both`)."""
    errs = {k: (abs(got[k] - want[k]) / abs(want[k]) if k in ("loss", "d_weight")
                else ((got[k] - want[k]).norm() / want[k].norm()).item())
            for k in ("rec", "loss", "d_weight", "nll", "g_eval", "total")}
    errs["slopes"] = (sum(int((a.cpu() != b.cpu()).sum()) for a, b in zip(got["signs"], want["signs"]))
                      / sum(a.numel() for a in got["signs"]))
    derived = max(1e-4, AE_PASS_AMPLIFICATION * errs["rec"])
    return errs, {"rec": 1e-4, **{k: derived for k in AE_PASS_DERIVED}}


@contextlib.contextmanager
def leaky_signs(module, replay=None):
    """For the block, every LeakyReLU of `module` appends its input's signs
    (> 0) to the list it yields, call by call; with `replay`, such a list
    from another run, each call's output takes the replayed signs' slopes
    instead of its own."""
    import torch

    signs = []

    def hook(mod, args, out):
        x = args[0]
        signs.append(x > 0)
        if replay is not None:
            return torch.where(replay[len(signs) - 1].to(x.device), x, x * mod.negative_slope)
        return None

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, torch.nn.LeakyReLU)]
    try:
        yield signs
    finally:
        for h in handles:
            h.remove()


def ae_generator_pass(trainer, x, replay=None) -> dict:
    """One generator pass of `trainer` on x (the posterior's mean), no step:
    the reconstruction, the loss, d_weight, ∂/∂ conv_out.weight (on the
    CPU) of the NLL ("nll"), of the GAN term on the discriminator's running
    statistics ("g_eval") and of the loss ("total"), and the signs of every
    LeakyReLU input of the discriminator ("signs"; `leaky_signs`, with
    `replay`)."""
    import torch

    x = x.to(trainer.device)
    loss_fn = trainer.loss
    with leaky_signs(loss_fn.discriminator, replay) as signs:
        rec, reg_log = trainer._reconstruct(x, None)
        nll, _ = loss_fn.get_nll_loss(loss_fn._rec_loss(x, rec))
        g_eval = -loss_fn.discriminator(rec, "eval").mean()
        total, log = loss_fn.generator_loss(x, rec, regularization_log=reg_log,
                                            global_step=trainer.global_step, train=True,
                                            last_layer=trainer.last_layer())
    w = trainer.engine.decoder.conv_out.weight
    out = {name: torch.autograd.grad(v, [w], retain_graph=True)[0].cpu()
           for name, v in (("nll", nll), ("g_eval", g_eval), ("total", total))}
    out.update(rec=rec.detach().cpu(), loss=total.item(),
               d_weight=log["train/scalars/d_weight"].item(), signs=signs)
    return out


def ae_pass_on_both(trainer, x):
    """`ae_generator_pass` of `trainer` and of a copy on the other device
    (the card or the CPU) on x, both fp32 with TF32 off: (the card's, the
    CPU's); the CPU's discriminator runs on the card's LeakyReLU slopes and
    reports its own signs."""
    import copy

    from hi3d_tpu_torch.training.ae_step import AutoencoderTrainer

    other = "cpu" if trainer.device.type == "cuda" else "cuda"
    twin = AutoencoderTrainer(copy.deepcopy(trainer.engine), copy.deepcopy(trainer.loss),
                              device=other)
    twin.global_step = trainer.global_step
    card, cpu = (trainer, twin) if other == "cpu" else (twin, trainer)
    got = ae_generator_pass(card, x)
    want = ae_generator_pass(cpu, x, replay=got["signs"])
    return got, want


def ae_pass_conditioning(batches=(1, 2)) -> None:
    """On the CPU: how far fp32 itself pins main path 12's generator pass.
    `ae_trainer("cpu")` (seed 0, no step) runs `ae_generator_pass` in fp32
    and a float64 copy runs it twice, on its own LeakyReLU slopes and on the
    fp32 run's, on the 128² centres of the first `batches` render frames;
    prints `ae_pass_errors` of fp32 against each float64 run and the flipped
    slopes of each LeakyReLU call. Run from the repository root:

        python3 -c "import chip_smoke; chip_smoke.ae_pass_conditioning()"
    """
    import copy
    import shutil

    from hi3d_tpu_torch.training.ae_step import AutoencoderTrainer

    out_dir = tempfile.mkdtemp(prefix="ae_conditioning_")
    frames = _ae_frames(out_dir, max(batches))
    shutil.rmtree(out_dir)
    lo = (frames.shape[-1] - AE_CHECK_SIZE) // 2
    trainer = ae_trainer("cpu")
    wide = AutoencoderTrainer(copy.deepcopy(trainer.engine).double(),
                              copy.deepcopy(trainer.loss).double(), device="cpu")
    for b in batches:
        x = frames[:b, :, lo:lo + AE_CHECK_SIZE, lo:lo + AE_CHECK_SIZE].contiguous()
        f32 = ae_generator_pass(trainer, x)
        for slopes, replay in (("own", None), ("fp32's", f32["signs"])):
            f64 = ae_generator_pass(wide, x.double(), replay=replay)
            errs, _ = ae_pass_errors(f32, f64)
            flips = [int((a != c).sum()) for a, c in zip(f32["signs"], f64["signs"])]
            print(f"[ae conditioning] {b} × {AE_CHECK_SIZE}², fp32 against float64 on {slopes} "
                  f"slopes: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                  + f"; flipped slopes by LeakyReLU call {flips} of "
                  f"{[a.numel() for a in f32['signs']]}", flush=True)


def _ae_pass_check(trainer, frame) -> str:
    """One generator pass on the card against the plain versions on the CPU
    (a copy of the same weights) on the 1 × 128² centre of `frame`, within
    `ae_pass_errors`' bounds, d_weight inside its clip."""
    lo = (frame.shape[-1] - AE_CHECK_SIZE) // 2  # the centre, where the object is
    x = frame[None, :, lo:lo + AE_CHECK_SIZE, lo:lo + AE_CHECK_SIZE].contiguous()
    got, want = ae_pass_on_both(trainer, x)
    errs, bounds = ae_pass_errors(got, want)
    text = (f"1 × {AE_CHECK_SIZE}² generator pass, card against CPU: loss {got['loss']!r} / "
            f"{want['loss']!r}, d_weight {got['d_weight']!r} / {want['d_weight']!r}; relative "
            "errors (conv_out weight gradients in L2; slopes: the share of the discriminator's "
            "LeakyReLU inputs of other sign) " + ", ".join(
                f"{k} {errs[k]:.2e} (bound {b:.2e})" for k, b in bounds.items()))
    if not (all(errs[k] <= b for k, b in bounds.items()) and 0 <= want["d_weight"] < 1e4):
        raise AssertionError(text)
    return text


def ae_training_path(steps: int = AE_TRAIN_STEPS) -> dict:
    """Main path 12: `ae_trainer()` on the card with TF32 off takes `steps`
    alternating steps on batches of 2 × 512² frames from the render
    stand-ins: finite losses, d_weight in [0, 1e4) (finite, inside its
    clip) on generator steps, the
    encoder and decoder moving on generator steps and the discriminator on
    discriminator steps (each bit-still on the other's), launches equal to
    `ae_launches`; then one generator pass against the CPU
    (`_ae_pass_check`). Prints s/step of each pass and the peak. Returns
    the launch count of each kernel."""
    import shutil

    import torch

    from hi3d_tpu_torch.pipelines.common import configure_precision

    configure_precision()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_ae_", dir=os.path.join(ROOT, "outputs"))
    frames = _ae_frames(out_dir, steps * AE_BATCH)
    t0 = time.perf_counter()
    trainer = ae_trainer()
    build_s = time.perf_counter() - t0
    groups = {"encoder": list(trainer.engine.encoder.parameters()),
              "decoder": list(trainer.engine.decoder.parameters()),
              "discriminator": trainer.disc_params}
    expected = ae_launches(ae_ddconfig(), "ae_train", steps)
    gen = torch.Generator(device="cuda").manual_seed(0)
    seconds = {"generator": [], "discriminator": []}
    losses = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for i in range(steps):
        before = {k: [p.detach().clone() for p in ps] for k, ps in groups.items()}
        kind = "generator" if i % 2 == 0 else "discriminator"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, log = trainer.train_step(frames[AE_BATCH * i:AE_BATCH * (i + 1)], i, gen)
        torch.cuda.synchronize()
        seconds[kind].append(time.perf_counter() - t0)
        losses.append(loss.item())
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"step {i} ({kind}): loss {losses[-1]}")
        if kind == "generator":
            d_weight = log["train/scalars/d_weight"].item()
            if not 0 <= d_weight < 1e4:  # finite, inside the clip
                raise AssertionError(f"step {i}: d_weight {d_weight}")
        moved = {k: any(not torch.equal(a, p) for a, p in zip(before[k], ps))
                 for k, ps in groups.items()}
        want = {"encoder": kind == "generator", "decoder": kind == "generator",
                "discriminator": kind == "discriminator"}
        if moved != want:
            raise AssertionError(f"step {i} ({kind}): moved {moved}, want {want}")
        del before
    launches = read_launches(expected)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[ae] main path 12: {steps} AutoencoderTrainer steps, {AE_BATCH} × 512², built in "
          f"{build_s:.1f} s; s/step generator {[round(s, 3) for s in seconds['generator']]}, "
          f"discriminator {[round(s, 3) for s in seconds['discriminator']]}; peak allocated "
          f"{peak:.2f} GiB; losses {[round(v, 5) for v in losses]}; last d_weight "
          f"{d_weight!r}; launches {launches}", flush=True)
    _check_launches(launches, expected)
    t0 = time.perf_counter()
    check = _ae_pass_check(trainer, frames[0])
    print(f"[ae] {check} ({time.perf_counter() - t0:.1f} s)", flush=True)
    shutil.rmtree(out_dir)
    del trainer, groups
    torch.cuda.empty_cache()
    return launches


def _unzero_time_stacks(decoder) -> None:
    """Give the time stacks' zero-initialised out convs torch's default
    init, so that random weights exercise the temporal branch (a trained
    checkpoint's are not zero)."""
    from hi3d_tpu_torch.models.temporal_ae import TimeStack3D

    for m in decoder.modules():
        if isinstance(m, TimeStack3D):
            m.out_layers[3].reset_parameters()


def svd_vae_path(stage1_dir: str) -> dict:
    """Main path 13: SVD's first stage (`models.autoencoding.
    SVD_FIRST_STAGE_CONFIG`: Encoder, conv-only VideoDecoder with video
    kernel (3, 1, 1)) from seed 0 on the card with TF32 off encodes main
    path 1's 16 × 512² frames and decodes them as one 16-frame video; a
    time_mode "all" decoder (seed 1; 4096 mid tokens, one head of 512)
    decodes the same latents. Checks finite (16, 3, 512, 512) outputs,
    launches equal to `ae_launches` (#9 at every norm, #10 at the "all"
    decoder's LayerNorms, no K2 or #6), and that `skip_video=True` agrees
    with the 2-D Decoder holding the same spatial weights (1e-5 of the
    output's largest magnitude: the same fp32 ops, cuDNN free to pick
    another algorithm). Prints seconds and the peak. Returns the launch
    count of each kernel."""
    import torch

    from hi3d_tpu_torch.config import instantiate_from_config, load_config
    from hi3d_tpu_torch.models.autoencoding import SVD_FIRST_STAGE_CONFIG
    from hi3d_tpu_torch.models.temporal_ae import VideoDecoder
    from hi3d_tpu_torch.models.vae import Decoder
    from hi3d_tpu_torch.pipelines.common import configure_precision
    from hi3d_tpu_torch.utils.video import import_video, range_from_uint8

    configure_precision()
    cfg = load_config(SVD_FIRST_STAGE_CONFIG)
    dd = cfg["params"]["decoder_config"]["params"]
    torch.manual_seed(0)
    engine = instantiate_from_config(cfg)
    _unzero_time_stacks(engine.decoder)
    torch.manual_seed(1)
    video_all = VideoDecoder(**{**dd, "time_mode": "all"})
    _unzero_time_stacks(video_all)
    engine.to("cuda").eval()
    video_all.to("cuda").eval()
    frames = import_video(os.path.join(stage1_dir, "first_step", "frames"), SVD_FRAMES)
    x = range_from_uint8(torch.as_tensor(frames).to("cuda")).permute(0, 3, 1, 2).contiguous()
    expected = ae_launches(dd, "svd_vae")
    secs = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t0, 3)
        return out

    with torch.no_grad():
        z = timed("encode", lambda: engine.encode(x))
        rec = timed("decode conv-only", lambda: engine.decode(z, timesteps=SVD_FRAMES))
        rec_all = timed("decode all", lambda: video_all(z, timesteps=SVD_FRAMES))
    launches = read_launches(expected)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, out in (("conv-only", rec), ("all", rec_all)):
        if out.shape != (SVD_FRAMES, 3, 512, 512) or not torch.isfinite(out).all():
            raise AssertionError(f"{name} decode: {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
    plain = Decoder(**dd).to("cuda").eval()
    spatial = plain.state_dict()
    plain.load_state_dict({k: v for k, v in engine.decoder.state_dict().items() if k in spatial},
                          strict=True)
    with torch.no_grad():
        skip = engine.decoder(z, timesteps=SVD_FRAMES, skip_video=True)
        want = plain(z)
    skip_err = ((skip - want).abs().max() / want.abs().max()).item()
    print(f"[svd] main path 13: SVD's first stage on {SVD_FRAMES} × 512² (main path 1's frames), "
          f"seconds {secs}, peak allocated {peak:.2f} GiB; latents {tuple(z.shape)}, outputs "
          f"finite in [{rec.min().item():.3f}, {rec.max().item():.3f}] (conv-only), "
          f"[{rec_all.min().item():.3f}, {rec_all.max().item():.3f}] (all); |temporal − "
          f"skip_video| max {(rec - skip).abs().max().item():.3e}; skip_video against the 2-D "
          f"Decoder: max |Δ| / max |y| {skip_err:.2e} (bound 1e-5); launches {launches}",
          flush=True)
    _check_launches(launches, expected)
    if not skip_err <= 1e-5:
        raise AssertionError(f"skip_video against the 2-D decoder: {skip_err}")
    del engine, video_all, plain, x, z, rec, rec_all, skip, want
    torch.cuda.empty_cache()
    return launches


SD21_CONFIG = os.path.join(ROOT, "hi3d_tpu_torch", "configs", "sd_2_1.yaml")
T2I_PROMPTS = 2  # main path 14: two prompts a batch, CFG-doubled to B4 a UNet call
T2I_LATENT = 64  # 512² images
T2I_CFG_SCALE = 7.5
CLIP_SOT, CLIP_EOT = 49406, 49407  # the CLIP BPE vocabulary's start and end tokens
CONTEXT_LENGTH = 77
# google/t5-v1_1-xl's published encoder widths (its config.json)
T5_XL = dict(vocab_size=32128, d_model=2048, d_kv=64, d_ff=5120, num_layers=24, num_heads=32,
             relative_attention_num_buckets=32, relative_attention_max_distance=128,
             layer_norm_epsilon=1e-6, feed_forward_proj="gated-gelu")
# google/byt5-base's published encoder widths
BYT5_BASE = dict(vocab_size=384, d_model=1536, d_kv=64, d_ff=3968, num_layers=18, num_heads=12,
                 relative_attention_num_buckets=32, relative_attention_max_distance=128,
                 layer_norm_epsilon=1e-6, feed_forward_proj="gated-gelu")
TOWER_T5_BOUND = 5e-2  # relative L2 of T5-XL's bf16 output on the card against fp32 on the CPU
INCEPTION_BOUND = 1e-4  # relative L2 of InceptionV3 in fp32 on the card against the CPU


@functools.lru_cache(maxsize=4)
def t2i_sites(config_path: str = SD21_CONFIG) -> dict:
    """#10 and #9 sites of the image model's parts, counted on the meta
    device: the UNetModel's LayerNorm32s, the text tower's (plus one for the
    `penultimate` layer, which applies ln_final again), the first stage's
    encoder and decoder FoldedGroupNorms, CLIP ViT-L/14's text tower's."""
    import torch

    from hi3d_tpu_torch.config import instantiate_from_config, load_config
    from hi3d_tpu_torch.models.attention import LayerNorm32
    from hi3d_tpu_torch.models.clip import text_vit_l_14
    from hi3d_tpu_torch.models.layers import FoldedGroupNorm

    p = load_config(config_path)["model"]["params"]
    (emb,) = p["conditioner_config"]["params"]["emb_models"]

    def count(build, cls) -> int:
        with torch.device("meta"):
            return sum(isinstance(m, cls) for m in build().modules())

    vae = lambda: instantiate_from_config(p["first_stage_config"])  # noqa: E731
    text = count(lambda: instantiate_from_config(emb), LayerNorm32)
    return {"unet": count(lambda: instantiate_from_config(p["network_config"]), LayerNorm32),
            "text": text + (emb.get("params", {}).get("layer") == "penultimate"),
            "encoder": count(lambda: vae().encoder, FoldedGroupNorm),
            "decoder": count(lambda: vae().decoder, FoldedGroupNorm),
            "clip_l_text": count(text_vit_l_14, LayerNorm32)}


def unet2d_launches(config_path: str = SD21_CONFIG, calls: int = 1, grad: bool = False) -> dict:
    """Launches of `calls` UNetModel calls of the config (`grad`: one forward
    and backward): K1 once per transformer block (self-attention; the
    cross-attention against 77 tokens is plain), K3 twice per ResBlock, once
    per SpatialTransformer `norm` and once for `out.0`, #10 once per
    LayerNorm32, no frame-axis kernel. With `grad` and `use_checkpoint`,
    the blocks' forwards run twice (`out.0` once) and #3 once per
    transformer block."""
    from hi3d_tpu_torch.config import load_config
    from hi3d_tpu_torch.models.unet import _build_plan

    p = load_config(config_path)["model"]["params"]["network_config"]["params"]
    depth = p.get("transformer_depth", 1)
    depth = [depth] * len(p["channel_mult"]) if isinstance(depth, int) else depth
    inp, mid, out = _build_plan(p["model_channels"], p["channel_mult"], p["num_res_blocks"],
                                p["attention_resolutions"], depth)
    specs = [s for block in inp + [mid] + out for s in block]
    blocks = sum(s[2] for s in specs if s[0] == "attn")
    n_attn = sum(1 for s in specs if s[0] == "attn")
    n_res = sum(1 for s in specs if s[0] == "res")
    fwd = 2 if grad and p.get("use_checkpoint") else 1
    return {"flash_attention": calls * fwd * blocks,
            "flash_attention_backward": calls * blocks if grad else 0,
            **_frame_kernels("plain", 0, 0),
            "group_norm": calls * (fwd * (2 * n_res + n_attn) + 1), "group_stats": 0,
            "layer_norm": calls * fwd * t2i_sites(config_path)["unet"]}


def t2i_launches(config_path: str = SD21_CONFIG, steps: int = NUM_STEPS) -> dict:
    """Main path 14's plan: one CFG-batched UNetModel call a step, the text
    tower on the prompts and on the empty prompt (two conditioner passes,
    as `get_unconditional_conditioning` with a `batch_uc` runs them), one
    decode of all the latents."""
    sites = t2i_sites(config_path)
    return _sum_launches(unet2d_launches(config_path, steps),
                         {"layer_norm": 2 * sites["text"], "group_stats": sites["decoder"]})


def towers_launches(config_path: str = SD21_CONFIG) -> dict:
    """Main path 15's plan: CLIP ViT-L/14's text tower twice (inside
    FrozenCLIPT5Encoder and as FrozenCLIPEmbedder), #10 at each of its
    LayerNorm32s; LowScaleEncoder's and GaussianEncoder's encoders once
    each, #9 at each FoldedGroupNorm. T5's RMS norms, the text towers'
    causal attention, InceptionV3 and the resizes launch no kernel."""
    sites = t2i_sites(config_path)
    return {**{name: 0 for name, *_ in KERNELS}, "layer_norm": 2 * sites["clip_l_text"],
            "group_stats": 2 * sites["encoder"]}


def _full_width_unet2d(b: int = 2, hw: int = 16):
    """SD 2.1's UNetModel at full width on the card, fp32 weights from seed
    0, the zero-initialised leaves (out.2, proj_out) made random; inputs of
    `b` images at an `hw`² latent with a (b, 77, 1024) context."""
    import torch

    from hi3d_tpu_torch.config import instantiate_from_config, load_config

    cfg = load_config(SD21_CONFIG)["model"]["params"]["network_config"]
    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(0)
        unet = instantiate_from_config(cfg).eval()
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for p in unet.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=gen)
    inputs = dict(
        x=torch.randn((b, 4, hw, hw), generator=gen, device="cuda"),
        timesteps=torch.randint(0, 1000, (b,), generator=gen, device="cuda").float(),
        context=torch.randn((b, CONTEXT_LENGTH, cfg["params"]["context_dim"]), generator=gen,
                            device="cuda"),
    )
    return unet, inputs


def unet2d_reference_phase(b: int = 2, hw: int = 16) -> float:
    """SD 2.1's full-width UNetModel, one call of `b` images at an `hw`²
    latent: bf16 on the card (K1 self-attention, K3, #10), held against the
    same weights in fp32 on the CPU (plain versions), with launches equal
    to `unet2d_launches`. Tolerance: 1.5 × the relative L2 error of the
    plain versions in bf16 on the CPU, measured in the same run."""
    import copy

    import torch

    t0 = time.perf_counter()
    unet, inputs = _full_width_unet2d(b, hw)
    cpu_fp32 = copy.deepcopy(unet).to("cpu", torch.float32)
    cpu_bf16 = copy.deepcopy(unet).to("cpu", torch.bfloat16)
    unet.to(torch.bfloat16)
    expected = unet2d_launches()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with torch.no_grad():
        out = unet(**inputs).float().cpu()
        launches = read_launches(expected)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ref, plain = (net(**{k: v.cpu() for k, v in inputs.items()}).float()
                      for net in (cpu_fp32, cpu_bf16))
    _check_launches(launches, expected)
    if not torch.isfinite(out).all():
        raise AssertionError("UNetModel output on the card is not finite")
    rel, plain_rel = (((a - ref).norm() / ref.norm()).item() for a in (out, plain))
    print(f"[smoke] full-width SD 2.1 UNetModel, B{b} at a {hw}² latent with a (B, 77, 1024) "
          f"context, vs CPU fp32: card bf16 relative L2 error {rel:.3e}, plain bf16 "
          f"{plain_rel:.3e} (tol {1.5 * plain_rel:.3e}); launches {launches}; card peak "
          f"{peak:.2f} GiB ({time.perf_counter() - t0:.1f} s with the CPU passes)", flush=True)
    if not rel <= 1.5 * plain_rel:
        raise AssertionError(f"UNetModel on the card: error {rel} > 1.5 × plain bf16 {plain_rel}")
    del unet, cpu_fp32, cpu_bf16
    torch.cuda.empty_cache()
    return rel


def unet2d_gradient_phase(b: int = 2, hw: int = 32) -> dict:
    """The gradient of an MSE loss through SD 2.1's full-width UNetModel on
    the card, training's way: fp32 weights, bf16 compute under autocast,
    `use_checkpoint` (torch.utils.checkpoint) as configured; every
    parameter's gradient present and finite, launches equal to
    `unet2d_launches(grad=True)` (#3 once per transformer block). Returns
    the launches."""
    import torch
    import torch.nn.functional as F

    t0 = time.perf_counter()
    unet, inputs = _full_width_unet2d(b, hw)
    unet.dtype = torch.bfloat16
    unet.train()
    target = torch.randn(inputs["x"].shape, generator=torch.Generator(device="cuda").manual_seed(5),
                         device="cuda")
    expected = unet2d_launches(grad=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loss = F.mse_loss(unet(**inputs).float(), target)
    loss.backward()
    torch.cuda.synchronize()
    launches = read_launches(expected)
    secs = time.perf_counter() - t0
    bad = [n for n, p in unet.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[smoke] full-width SD 2.1 UNetModel gradient, B{b} at a {hw}² latent through "
          f"use_checkpoint: loss {loss.item():.6f}, {sum(1 for _ in unet.parameters())} tensors, "
          f"missing or non-finite {len(bad)}; launches {launches}; peak {peak:.2f} GiB "
          f"({secs:.1f} s with the build)", flush=True)
    if bad:
        raise AssertionError(f"gradients missing or not finite: {bad[:5]}")
    _check_launches(launches, expected)
    del unet
    torch.cuda.empty_cache()
    return launches


def t2i_prompt_ids(gen, n: int = T2I_PROMPTS, vocab_top: int = CLIP_SOT):
    """(n, 77) int64 prompt ids on the card: SOT, 8–40 tokens drawn from
    [1, vocab_top), EOT, then 0 padding (open_clip pads with 0); and the
    empty prompt's ids [SOT, EOT, 0, …] n times."""
    import torch

    ids = torch.zeros((n, CONTEXT_LENGTH), dtype=torch.long)
    lengths = torch.randint(8, 41, (n,), generator=gen).tolist()
    for i, k in enumerate(lengths):
        ids[i, 0] = CLIP_SOT
        ids[i, 1:k + 1] = torch.randint(1, vocab_top, (k,), generator=gen)
        ids[i, k + 1] = CLIP_EOT
    empty = torch.zeros((n, CONTEXT_LENGTH), dtype=torch.long)
    empty[:, 0], empty[:, 1] = CLIP_SOT, CLIP_EOT
    return ids.to("cuda"), empty.to("cuda")


def t2i_path(steps: int = NUM_STEPS) -> dict:
    """Main path 14: SD 2.1 text-to-image at full width from
    hi3d_tpu_torch/configs/sd_2_1.yaml with seeded weights: the conditioner
    (OpenCLIP ViT-H/14 text, `penultimate`, bf16) on 2 prompts' ids and the
    empty prompt's (`get_unconditional_conditioning`), EulerEDMSampler with
    LegacyDDPMDiscretization and VanillaCFG 7.5 over 2 × 4 × 64² latents
    (bf16), each step one B4 call of ConcatConditionWrapper(UNetModel) under
    DiscreteDenoiser, then the fp32 AutoencoderKL (TF32 off) decodes 2 ×
    512² images, written as PNGs under outputs/t2i/. Checks finite outputs
    of the expected shapes, 25 UNet calls of batch 4, and launches equal to
    `t2i_launches`; prints seconds by phase and the peak. Returns the
    launches."""
    import torch

    from hi3d_tpu_torch.config import instantiate_from_config, load_config
    from hi3d_tpu_torch.diffusion.samplers import EulerEDMSampler
    from hi3d_tpu_torch.models.wrappers import ConcatConditionWrapper
    from hi3d_tpu_torch.pipelines.common import configure_precision
    from hi3d_tpu_torch.utils.png import write_png
    from hi3d_tpu_torch.utils.video import denorm_to_uint8

    configure_precision()
    p = load_config(SD21_CONFIG)["model"]["params"]
    secs = {}
    t0 = time.perf_counter()
    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(0)
        conditioner = instantiate_from_config(p["conditioner_config"]).eval()
        unet = instantiate_from_config(p["network_config"]).eval()
        vae = instantiate_from_config(p["first_stage_config"]).eval()
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for q in unet.parameters():
            if not q.any():
                q.normal_(0.0, 0.02, generator=gen)
    conditioner.to(torch.bfloat16)
    unet.to(torch.bfloat16)
    denoiser = instantiate_from_config(p["denoiser_config"])
    network = ConcatConditionWrapper(unet)
    sampler = EulerEDMSampler(
        num_steps=steps,
        discretization_config=p["denoiser_config"]["params"]["discretization_config"],
        guider_config={"target": "sgm.modules.diffusionmodules.guiders.VanillaCFG",
                       "params": {"scale": T2I_CFG_SCALE}})
    ids, empty = t2i_prompt_ids(torch.Generator().manual_seed(2))
    secs["build"] = round(time.perf_counter() - t0, 3)
    calls = []

    def denoise(x, sigma, cond):
        calls.append(x.shape[0])
        return denoiser(network, x, sigma, cond)

    def timed(name, fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t1, 3)
        return out

    expected = t2i_launches(SD21_CONFIG, steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with torch.no_grad():
        c, uc = timed("conditioner", lambda: conditioner.get_unconditional_conditioning(
            {"txt": ids}, {"txt": empty}))
        x = torch.randn((T2I_PROMPTS, 4, T2I_LATENT, T2I_LATENT), generator=gen,
                        device="cuda").to(torch.bfloat16)
        z = timed("sampler", lambda: sampler(denoise, x, c, uc=uc))
        img = timed("decode", lambda: vae.decode(z.float() / p["scale_factor"]))
    launches = read_launches(expected)
    peak = torch.cuda.max_memory_allocated() / 2**30
    out_dir = os.path.join(ROOT, "outputs", "t2i")
    os.makedirs(out_dir, exist_ok=True)
    frames = denorm_to_uint8(img.clamp(-1, 1)).permute(0, 2, 3, 1).cpu().numpy()
    for i, frame in enumerate(frames):
        write_png(os.path.join(out_dir, f"{i}.png"), frame)
    print(f"[t2i] main path 14: SD 2.1 on {T2I_PROMPTS} prompts, {steps} steps at "
          f"{T2I_LATENT}² latents: seconds {secs}, {secs['sampler'] / steps:.4f} s/step, peak "
          f"allocated {peak:.2f} GiB; crossattn {tuple(c['crossattn'].shape)}, latents "
          f"{tuple(z.shape)} {z.dtype}, images {tuple(img.shape)} in [{img.min().item():.3f}, "
          f"{img.max().item():.3f}], UNet calls {len(calls)} of batch {sorted(set(calls))}, "
          f"PNGs {sorted(os.listdir(out_dir))}; launches {launches}", flush=True)
    if c["crossattn"].shape != (T2I_PROMPTS, CONTEXT_LENGTH, 1024) or \
            uc["crossattn"].shape != c["crossattn"].shape:
        raise AssertionError(f"conditioning {c['crossattn'].shape}, {uc['crossattn'].shape}")
    if z.shape != (T2I_PROMPTS, 4, T2I_LATENT, T2I_LATENT) or not torch.isfinite(z).all():
        raise AssertionError(f"latents {tuple(z.shape)}, finite {bool(torch.isfinite(z).all())}")
    if img.shape != (T2I_PROMPTS, 3, 8 * T2I_LATENT, 8 * T2I_LATENT) or \
            not torch.isfinite(img).all():
        raise AssertionError(f"images {tuple(img.shape)}, finite {bool(torch.isfinite(img).all())}")
    if calls != [2 * T2I_PROMPTS] * steps:
        raise AssertionError(f"UNet calls {calls}, want {steps} of batch {2 * T2I_PROMPTS}")
    _check_launches(launches, expected)
    del conditioner, unet, vae, network, c, uc, z, img
    torch.cuda.empty_cache()
    return launches


def _card_and_cpu(build, seed: int):
    """A module built by `build()` on the card from `seed` (fast init) and
    its fp32 copy on the CPU; the card's is then cast to bf16."""
    import copy

    import torch

    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(seed)
        card = build().eval()
    cpu = copy.deepcopy(card).to("cpu", torch.float32)
    return card.to(torch.bfloat16), cpu


def _rel_l2(got, want) -> float:
    """Relative L2 error of tensor `got` against `want`, in fp32 on the CPU."""
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).norm() / want.norm()).item()


def _inception_init(model) -> None:
    """He-normal convolutions and unit BatchNorms, so that random features
    keep their scale through the 94 layers (torch's default init shrinks
    them towards 0)."""
    import torch

    for q in model.parameters():
        if q.ndim == 4:
            torch.nn.init.kaiming_normal_(q, nonlinearity="relu")


def towers_path(frames: np.ndarray) -> dict:
    """Main path 15: the other text towers at their published widths and the
    other new embedders, on the card. Seeded weights.

    - FrozenCLIPT5Encoder on 2 prompts' ids (CLIP ViT-L/14 text "last" and
      a T5 encoder at google/t5-v1_1-xl's widths; the same ids go to both,
      as in the JAX package, so they are drawn below T5's vocabulary), and
      FrozenCLIPEmbedder with `layer: hidden, layer_idx: 11`: bf16 on the
      card against fp32 on the CPU — CLIP within 1.5 × the plain bf16
      error on the CPU, T5 within TOWER_T5_BOUND;
    - InceptionV3 (pytorch-fid's variant, normalize_input) on `frames` (main
      path 1's 16 × 512² frames, [0, 1]): fp32 on both sides, TF32 off,
      within INCEPTION_BOUND;
    - IdentityEncoder, ClassEmbedder, ClassEmbedderForMultiCond,
      SpatialRescaler (2 bicubic halvings and a 3×3 remap), FrozenByT5Embedder
      at google/byt5-base's widths on raw strings, LowScaleEncoder (SD 2.1's
      first stage, x4-upscaler settings) and GaussianEncoder (SD 2.1's
      encoder): finite outputs of JAX's shapes.

    Launches equal `towers_launches`. Prints seconds and the peak. Returns
    the launches."""
    import copy

    import torch

    from hi3d_tpu_torch.conditioners import (
        ClassEmbedder, ClassEmbedderForMultiCond, FrozenByT5Embedder, FrozenCLIPEmbedder,
        FrozenCLIPT5Encoder, GaussianEncoder, IdentityEncoder, LowScaleEncoder,
        SpatialRescaler)
    from hi3d_tpu_torch.config import load_config
    from hi3d_tpu_torch.models.inception import InceptionV3
    from hi3d_tpu_torch.models.t5 import T5EncoderModel
    from hi3d_tpu_torch.pipelines.common import configure_precision

    configure_precision()
    p = load_config(SD21_CONFIG)["model"]["params"]
    dd = p["first_stage_config"]["params"]["ddconfig"]
    secs, errs = {}, {}
    expected = towers_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()

    def timed(name, fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t1, 3)
        return out

    # CLIP ViT-L/14 text + T5-XL, and the hidden-layer CLIP embedder
    def clip_t5():
        emb = FrozenCLIPT5Encoder(clip_version=None, t5_version=None)
        emb.t5_encoder.transformer = T5EncoderModel(**T5_XL)
        return emb

    ids, _ = t2i_prompt_ids(torch.Generator().manual_seed(3), vocab_top=T5_XL["vocab_size"])
    ids[ids >= T5_XL["vocab_size"]] = 1  # SOT/EOT: T5's EOS; the CLIP part reads "last"
    card, cpu = _card_and_cpu(clip_t5, 4)
    with torch.no_grad():
        got = timed("clip_t5 card", lambda: card(ids))
        want = timed("clip_t5 cpu", lambda: cpu(ids.cpu()))
        plain = timed("clip bf16 cpu", lambda: cpu.clip_encoder.to(torch.bfloat16)(ids.cpu()))
    errs["clip_t5 clip"], errs["clip plain"] = _rel_l2(got[0], want[0]), _rel_l2(plain, want[0])
    errs["clip_t5 t5"] = _rel_l2(got[1], want[1])
    shapes = {"clip_t5": [tuple(o.shape) for o in got]}
    del card, cpu
    hidden_ids, _ = t2i_prompt_ids(torch.Generator().manual_seed(5))
    card, cpu = _card_and_cpu(lambda: FrozenCLIPEmbedder(version=None, layer="hidden",
                                                         layer_idx=11), 6)
    with torch.no_grad():
        got = timed("clip hidden card", lambda: card(hidden_ids))
        want = cpu(hidden_ids.cpu())
        plain = cpu.to(torch.bfloat16)(hidden_ids.cpu())
    errs["clip hidden"], errs["clip hidden plain"] = _rel_l2(got, want), _rel_l2(plain, want)
    shapes["clip hidden_11"] = tuple(got.shape)
    del card, cpu

    # InceptionV3 in fp32 on both sides
    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(7)
        inception = InceptionV3(normalize_input=True).eval()
        _inception_init(inception)
    inception_cpu = copy.deepcopy(inception).to("cpu")
    x = torch.as_tensor(frames).permute(0, 3, 1, 2).float().div(255.0).contiguous()
    with torch.no_grad():
        feats = timed("inception card", lambda: inception(x.to("cuda")))
        feats_cpu = timed("inception cpu", lambda: inception_cpu(x))
    errs["inception"] = _rel_l2(feats, feats_cpu)
    shapes["inception"] = tuple(feats.shape)
    del inception, inception_cpu

    # the other embedders once
    g = torch.Generator(device="cuda").manual_seed(8)
    img = torch.rand((2, 3, 256, 256), generator=g, device="cuda") * 2 - 1
    outs = {}
    with torch.no_grad(), torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(9)
        outs["identity"] = IdentityEncoder()(img)
        labels = torch.tensor([3, 999], device="cuda")
        outs["class"] = ClassEmbedder(embed_dim=1024, n_classes=1000)(labels)
        outs["class_multi"] = ClassEmbedderForMultiCond(embed_dim=1024, n_classes=1000)([labels])
        outs["rescaler"] = SpatialRescaler(n_stages=2, method="bicubic", multiplier=0.5,
                                           out_channels=4, kernel_size=3)(img)
        byt5 = FrozenByT5Embedder(max_length=CONTEXT_LENGTH)
        byt5.transformer = T5EncoderModel(**BYT5_BASE).to(torch.bfloat16)
        outs["byt5"] = timed("byt5 card", lambda: byt5(["a photograph of an astronaut riding "
                                                        "a horse", "ein Ölgemälde"]))
        low = LowScaleEncoder(model_config=p["first_stage_config"], linear_start=1e-4,
                              linear_end=2e-2, timesteps=1000, max_noise_level=350,
                              output_size=64, scale_factor=p["scale_factor"]).eval()
        outs["low_scale"] = low(img, generator=g)
        outs["gaussian"] = GaussianEncoder(weight=1.0, **dd).eval()(img, generator=g)
        del byt5, low
    launches = read_launches(expected)
    peak = torch.cuda.max_memory_allocated() / 2**30
    flat = lambda o: [t for t in (o if isinstance(o, (list, tuple)) else [o])  # noqa: E731
                      if torch.is_tensor(t)]
    shapes.update({k: [tuple(t.shape) for t in flat(v)] for k, v in outs.items()})
    want_shapes = {
        "clip_t5": [(2, 77, 768), (2, 77, 2048)], "clip hidden_11": (2, 77, 768),
        "inception": (len(frames), 2048), "identity": [(2, 3, 256, 256)],
        "class": [(2, 1024)], "class_multi": [(2, 1024)], "rescaler": [(2, 4, 64, 64)],
        "byt5": [(2, 77, 1536)], "low_scale": [(2, 4, 64, 64), (2, 1)],
        "gaussian": [(2, 32 * 32, 4)]}
    print(f"[towers] main path 15: seconds {secs}, peak allocated {peak:.2f} GiB; relative L2 "
          f"errors {({k: f'{v:.3e}' for k, v in errs.items()})}; shapes {shapes}; gaussian KL "
          f"{outs['gaussian'][0]['kl_loss'].item():.4f}; launches {launches}", flush=True)
    if shapes != want_shapes:
        raise AssertionError(f"shapes {shapes} != {want_shapes}")
    nonfinite = [k for k, v in outs.items() if not all(torch.isfinite(t).all() for t in flat(v))]
    if nonfinite:
        raise AssertionError(f"non-finite outputs: {nonfinite}")
    for name, plain_name in (("clip_t5 clip", "clip plain"), ("clip hidden", "clip hidden plain")):
        if not errs[name] <= 1.5 * errs[plain_name]:
            raise AssertionError(f"{name}: error {errs[name]} > 1.5 × plain bf16 "
                                 f"{errs[plain_name]}")
    if not errs["clip_t5 t5"] <= TOWER_T5_BOUND:
        raise AssertionError(f"T5-XL on the card: error {errs['clip_t5 t5']} > {TOWER_T5_BOUND}")
    if not errs["inception"] <= INCEPTION_BOUND:
        raise AssertionError(f"InceptionV3 on the card: error {errs['inception']} > "
                             f"{INCEPTION_BOUND}")
    _check_launches(launches, expected)
    torch.cuda.empty_cache()
    return launches


def t2i_phases(frames_dir=None) -> dict:
    """Main paths 14 and 15 with the UNetModel's reference and gradient
    phases; `frames_dir` holds main path 1's frames (16 seeded random 512²
    frames stand in without it). Returns the launches by path."""
    from hi3d_tpu_torch.utils.video import import_video

    print(f"[smoke] main path 14: SD 2.1 text-to-image (hi3d_tpu_torch/configs/sd_2_1.yaml), "
          f"{T2I_PROMPTS} prompts, {NUM_STEPS} steps, CFG {T2I_CFG_SCALE}, {8 * T2I_LATENT}², "
          "random weights", flush=True)
    t0 = time.perf_counter()
    unet2d_reference_phase()
    by_path = {"unet2d_grad": unet2d_gradient_phase(), "t2i": t2i_path()}
    t1 = time.perf_counter()
    print("[smoke] main path 15: CLIP ViT-L/14 + T5-XL, CLIP hidden 11, InceptionV3 and the "
          "other embedders, random weights", flush=True)
    frames = (import_video(frames_dir, 16) if frames_dir else
              np.random.RandomState(0).randint(0, 256, (16, 512, 512, 3), dtype=np.uint8))
    by_path["towers"] = towers_path(frames)
    t2 = time.perf_counter()
    print(f"[smoke] paths 14 and 15: {t2 - t0:.1f} s of phases (path 14 with its reference and "
          f"gradient phases {t1 - t0:.1f} s, path 15 {t2 - t1:.1f} s)", flush=True)
    return by_path


# ------------------------------------------------------------ main path 16
def path1_frames(stage1_dir) -> np.ndarray:
    """Main path 1's 16 frames (16 seeded random 512² frames stand in
    without them)."""
    from hi3d_tpu_torch.utils.video import import_video

    if stage1_dir is None:
        return np.random.RandomState(0).randint(0, 256, (16, 512, 512, 3), dtype=np.uint8)
    return import_video(os.path.join(stage1_dir, "first_step", "frames"), 16)


JPEG_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_jpeg")
PATH7_IMAGE = os.path.join(JPEG_FIXTURES, "demo3_q90.jpg")  # path 7 reads a JPEG
SPLAT_MODES = ("sum", "avg", "linear", "soft")
# fp32 on the card against float64 on the CPU, relative to the largest entry
# of each tensor: sums of a few bilinear terms (the card's atomics add them
# in any order: (k − 1)·2⁻²⁴ of their magnitudes) and one division
WARP_TOL = 1e-5
# softsplat's flow gradient differences neighbouring samples: on smooth
# frames fp32 loses 2⁻²⁴ of terms far larger than their difference, so its
# error depends on the data (`flow_grad_readings`, 6 seeds × 4 modes: on
# demo/3.png's frames the card's fp32 is up to 1.15e-4 off float64 and the
# host CPU's fp32 up to 7.4e-5, on noise frames both under 1.4e-6; the
# card's error at most 2.2× the host's where the host's passes 1e-6). Its
# bound is the host fp32's error on the same inputs times this factor, and
# never below WARP_TOL
FLOW_GRAD_FACTOR = 4
# PWC-Net's pyramid for a 512² frame: (channels, side) at levels 6 … 2
PWC_LEVELS = ((196, 8), (128, 16), (96, 32), (64, 64), (32, 128))
# the VideoUNet options of main path 16: no spatial context and no
# time_context (attn2 attends over the frames: two frame kernels a block),
# 1×1-conv projections, an inert dropout
UNET_OPTIONS = {"use_spatial_context": False, "use_linear_in_transformer": False,
                "dropout": 0.1}
OPTIONS_CHECK = dict(b=1, t=4, hw=32)  # the options' card-against-CPU call
COND_SIGMA = {"target": "sgm.modules.diffusionmodules.sigma_sampling.EDMSampling",
              "params": {"p_mean": -3.0, "p_std": 0.5}}


def _warp_err(got, want) -> float:
    return ((got.double().cpu() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _splat_inputs(frames: np.ndarray, seed: int = 16):
    """softsplat's inputs on `frames` (T, H, W, 3) uint8: the frames in
    [0, 1], a seeded smooth flow of up to ±12 px quantised to 1/1024 px (so
    that fp32 and float64 land each pixel on the same integer grid cell), a
    metric in [0.5, 1.5) (a signed metric makes linear splatting's
    normaliser cancel, and the division ill-conditioned in fp32) and a
    cotangent, all float32 on the CPU."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(seed)
    x = torch.from_numpy(frames).permute(0, 3, 1, 2).float() / 255.0
    t, _, h, w = x.shape
    flow = F.interpolate(torch.randn(t, 2, h // 64, w // 64, generator=gen) * 6.0, size=(h, w),
                         mode="bicubic", align_corners=False).clamp(-12, 12)
    flow = torch.round(flow * 1024) / 1024
    metric = 0.5 + torch.rand(t, 1, h, w, generator=gen)  # a positive weight, as linear needs
    cot = torch.randn(t, 3, h, w, generator=gen)
    return x, flow, metric, cot


def _splat_call(mode: str, inputs, dev: str, dtype) -> list:
    """softsplat in `mode` and the gradients of sum(out · cotangent): out,
    ingrad, flowgrad[, metricgrad]."""
    import torch

    from hi3d_tpu_torch.ops.softsplat import softsplat

    x, flow, metric, cot = inputs
    a, f, m = (v.detach().to(dev, dtype).requires_grad_() for v in (x, flow, metric))
    out = softsplat(a, f, m if mode in ("linear", "soft") else None, mode)
    (out * cot.to(dev, dtype)).sum().backward()
    if dev == "cuda":
        torch.cuda.synchronize()
    return [out.detach(), a.grad, f.grad] + ([m.grad] if m.grad is not None else [])


def softsplat_phase(frames: np.ndarray) -> dict:
    """`ops.softsplat` in its four modes, forward and backward (input, flow
    and metric gradients of sum(out · cotangent)), on the 16 frames at 512²
    (`_splat_inputs`), against the same call in float64 on the CPU
    (WARP_TOL; for the flow gradient FLOW_GRAD_FACTOR × the error of the
    host CPU's fp32 flow gradient, at least WARP_TOL)."""
    import torch

    inputs = _splat_inputs(frames)
    t, _, h, _ = inputs[0].shape
    errs, secs, flow_bounds = {}, {}, {}
    for mode in SPLAT_MODES:
        res = {}
        for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            t0 = time.perf_counter()
            res[dev] = _splat_call(mode, inputs, dev, dtype)
            secs[f"{mode} {dev}"] = round(time.perf_counter() - t0, 2)
        errs[mode] = [_warp_err(g, r) for g, r in zip(res["cuda"], res["cpu"])]
        flow_bounds[mode] = WARP_TOL
        if errs[mode][2] > WARP_TOL:  # the host's fp32 pass is needed only past the floor
            host = _warp_err(_splat_call(mode, inputs, "cpu", torch.float32)[2], res["cpu"][2])
            flow_bounds[mode] = max(WARP_TOL, FLOW_GRAD_FACTOR * host)
        bounds = [WARP_TOL, WARP_TOL, flow_bounds[mode], WARP_TOL][:len(errs[mode])]
        if not all(torch.isfinite(v).all() for v in res["cuda"]) or any(
                e > b for e, b in zip(errs[mode], bounds)):
            raise AssertionError(f"softsplat {mode}: errors (out, ingrad, flowgrad[, metricgrad]) "
                                 f"{errs[mode]} against float64 (bounds {bounds})")
    print(f"[path16] softsplat on {t} × {h}² frames, flow within ±12 px: max |Δ| / max |ref| "
          f"against float64 (out, ingrad, flowgrad[, metricgrad]) "
          f"{ {k: [f'{e:.1e}' for e in v] for k, v in errs.items()} } (bound {WARP_TOL}; the "
          f"flow gradient's, {FLOW_GRAD_FACTOR} × the host fp32's error past it: "
          f"{ {k: f'{b:.1e}' for k, b in flow_bounds.items()} }); seconds {secs}", flush=True)
    return errs


def flow_grad_readings(seeds=(0, 1, 2, 3, 4, 5)) -> dict:
    """The readings FLOW_GRAD_FACTOR rests on: softsplat's flow gradient, fp32
    on the card and fp32 on the host CPU, each against float64 on the CPU
    (max |Δ| / max |ref|), in every mode, for each flow seed, on two sets
    of 16 frames at 512²: demo/3.png rolled by 3 px a frame (smooth, as
    rendered frames are) and seeded uniform noise. Run on the card:
    `python3 -c "import chip_smoke; chip_smoke.flow_grad_readings()"`."""
    import torch

    from hi3d_tpu_torch.utils.image import load_image_rgb

    demo = load_image_rgb(os.path.join(ROOT, "demo", "3.png"))
    sets = {"demo3": np.stack([np.roll(demo, 3 * i, axis=1) for i in range(16)]),
            "noise": path1_frames(None)}
    out = {}
    for name, frames in sets.items():
        for seed in seeds:
            inputs = _splat_inputs(frames, seed)
            for mode in SPLAT_MODES:
                ref = _splat_call(mode, inputs, "cpu", torch.float64)[2]
                card = _warp_err(_splat_call(mode, inputs, "cuda", torch.float32)[2], ref)
                host = _warp_err(_splat_call(mode, inputs, "cpu", torch.float32)[2], ref)
                out[f"{name} seed {seed} {mode}"] = (card, host)
                print(f"[flowgrad] {name} seed {seed} {mode}: card fp32 {card:.3e}, "
                      f"host fp32 {host:.3e}", flush=True)
    for name in sets:
        card = max(v[0] for k, v in out.items() if k.startswith(name))
        host = max(v[1] for k, v in out.items() if k.startswith(name))
        print(f"[flowgrad] {name}: largest card fp32 {card:.3e}, host fp32 {host:.3e} "
              f"({len(seeds)} seeds × {len(SPLAT_MODES)} modes)", flush=True)
    return out


def correlation_phase() -> dict:
    """`ops.correlation` forward and backward at PWC-Net's pyramid levels of
    a 512² frame pair, fp32 on the card against float64 on the CPU."""
    import torch

    from hi3d_tpu_torch.ops.correlation import correlation

    gen = torch.Generator().manual_seed(17)
    errs = {}
    t0 = time.perf_counter()
    for c, side in PWC_LEVELS:
        one, two = (torch.randn(1, c, side, side, generator=gen) for _ in range(2))
        cot = torch.randn(1, 81, side, side, generator=gen)
        res = {}
        for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            a, b = (v.detach().to(dev, dtype).requires_grad_() for v in (one, two))
            out = correlation(a, b)
            (out * cot.to(dev, dtype)).sum().backward()
            res[dev] = (out.detach(), a.grad, b.grad)
        errs[f"C{c} {side}²"] = [_warp_err(g, r) for g, r in zip(res["cuda"], res["cpu"])]
        if max(errs[f"C{c} {side}²"]) > WARP_TOL:
            raise AssertionError(f"correlation C{c} {side}²: {errs[f'C{c} {side}²']}")
    print(f"[path16] correlation at PWC-Net's levels, (out, grad one, grad two) against float64: "
          f"{ {k: [f'{e:.1e}' for e in v] for k, v in errs.items()} } (bound {WARP_TOL}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return errs


def transforms_phase() -> float:
    """Every function of `data.transforms` on demo/3.png on this host (no
    cv2, no PIL here): shapes and dtypes, and the identities that must hold
    exactly (an identity warp, gamma 1, a resize to the same size, the
    crops and flips against slicing) or nearly (hue ±0.5, as the JAX
    package's test holds them)."""
    from hi3d_tpu_torch.data import transforms as T
    from hi3d_tpu_torch.utils.png import read_png

    t0 = time.perf_counter()
    img = read_png(os.path.join(ROOT, "demo", "3.png"))[..., :3]
    h, w = img.shape[:2]
    checks = {
        "to_tensor": T.to_tensor(img).dtype == np.float32,
        "normalize": T.normalize(T.to_tensor(img), [0.5] * 3, [0.5] * 3).min() >= -1.0,
        "crop": np.array_equal(T.crop(img, 3, 5, 40, 50), img[3:43, 5:55]),
        "center_crop": T.center_crop(img, 256).shape == (256, 256, 3),
        "pad": T.pad(img, 4, fill=7).shape == (h + 8, w + 8, 3),
        "flips": np.array_equal(T.hflip(T.hflip(img)), img)
        and np.array_equal(T.vflip(img), img[::-1]),
        "five_crop": len(T.five_crop(img, 128)) == 5,
        "ten_crop": len(T.ten_crop(img, 128, vertical_flip=True)) == 10,
        "resize same": np.array_equal(T.resize(img, (h, w)), img),
        "rotate 0": np.array_equal(T.rotate(img, 0), img),
        "affine identity": np.array_equal(T.affine(img, 0, (0, 0), 1.0, 0), img),
        # PIL's HSV round trip truncates: hue ±0.5 land 2/255 apart (the JAX test's check)
        "hue ±0.5": np.mean(np.abs(T.adjust_hue(img, 0.5).astype(int)
                                   - T.adjust_hue(img, -0.5).astype(int))) < 4,
        "gamma 1": np.array_equal(T.adjust_gamma(img, 1.0), img),
        "gray": T.to_grayscale(np.full((2, 2, 3), 255, np.uint8))[0, 0, 0] == 255,
    }
    for interp in ("nearest", "bilinear", "bicubic", "area", "lanczos"):
        checks[f"resize {interp}"] = (T.resize(img, 300, interp).shape == (300, 300, 3)
                                      and T.resize(img, (700, 613), interp).dtype == np.uint8)
    for interp, mode in (("nearest", "constant"), ("bilinear", "replicate"),
                         ("bicubic", "reflect"), ("area", "reflect101")):
        out = T.affine(img, 17.0, (5, -3), 1.2, 4.0, interp, mode, (255, 0, 0))
        checks[f"affine {interp} {mode}"] = out.shape == img.shape and out.dtype == np.uint8
    checks["rotate expand"] = T.rotate(img, 30, expand=True).shape == (699, 699, 3)
    for f in (T.adjust_brightness, T.adjust_contrast, T.adjust_saturation):
        checks[f.__name__] = f(img, 1.3).shape == img.shape
    checks["adjust_hue"] = T.adjust_hue(img, 0.3).shape == img.shape
    g = np.random.default_rng
    pipeline = T.Compose([T.RandomResizedCrop(256, rng=g(1)), T.RandomHorizontalFlip(rng=g(2)),
                          T.ColorJitter(0.2, 0.2, 0.2, 0.05, rng=g(3)),
                          T.RandomAffine(5, (0.05, 0.05), (0.9, 1.1), 3, rng=g(4)),
                          T.RandomRotation(5, rng=g(5)), T.Grayscale(3), T.ToTensor(),
                          T.Normalize([0.5] * 3, [0.5] * 3)])
    out = pipeline(img)
    checks["pipeline"] = out.shape == (256, 256, 3) and np.isfinite(out).all()
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"transforms on demo/3.png: {failed}")
    secs = time.perf_counter() - t0
    print(f"[path16] transforms: {len(checks)} checks on demo/3.png passed on this host "
          f"({secs:.1f} s)", flush=True)
    return secs


def jpeg_phase() -> None:
    """The JPEG fixtures decoded on this host (no cv2 here) against their
    cv2 goldens (shape and SHA-256 of cv2's decode, tests/data/torch_jpeg),
    and through `load_image_rgb`."""
    import hashlib

    from hi3d_tpu_torch.utils.image import load_image_rgb
    from hi3d_tpu_torch.utils.jpeg import read_jpeg

    t0 = time.perf_counter()
    with open(os.path.join(JPEG_FIXTURES, "goldens.json")) as f:
        goldens = json.load(f)
    for name, want in sorted(goldens.items()):
        path = os.path.join(JPEG_FIXTURES, name)
        img = read_jpeg(path)
        got = {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
        if got != want:
            raise AssertionError(f"{name}: decoded {got}, cv2's golden {want}")
        rgb = load_image_rgb(path)
        if rgb.shape != img.shape[:2] + (3,) or not np.array_equal(rgb[..., :img.shape[2]], img):
            raise AssertionError(f"{name}: load_image_rgb disagrees with the decode")
    print(f"[path16] {len(goldens)} JPEG fixtures decoded bit-equal to their cv2 goldens "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)


def logger_phase(out_dir: str) -> None:
    from hi3d_tpu_torch.utils.logger import setup_logger

    log = setup_logger("hi3d_tpu_torch.smoke", out_dir)
    if setup_logger("hi3d_tpu_torch.smoke", out_dir) is not log:
        raise AssertionError("setup_logger is not cached")
    log.info("main path 16")
    for handler in log.handlers:
        handler.flush()
    with open(os.path.join(out_dir, "log.txt")) as f:
        if "hi3d_tpu_torch.smoke INFO] main path 16" not in f.read():
            raise AssertionError("setup_logger wrote no log.txt line")


def cond_sigma_phase(frames: np.ndarray) -> dict:
    """configs/inference-v01.yaml's conditioning-frame embedder (its VAE
    encoder, random weights) with an EDMSampling σ sampler, on two of the
    frames: with a generator, one σ a video times unit normals is added
    before the encode, and the output equals the encode of the frames
    noised by hand with the same draws; without one the frames stay clean.
    #9 launches equal the three encodes' norms. Returns the launches."""
    import torch

    from hi3d_tpu_torch.config import instantiate_from_config, load_config
    from hi3d_tpu_torch.models.layers import FoldedGroupNorm

    t0 = time.perf_counter()
    cfg = load_config(os.path.join(ROOT, "configs", "inference-v01.yaml"))
    (emb_cfg,) = [e for e in cfg["model"]["params"]["conditioner_config"]["params"]["emb_models"]
                  if e["target"].endswith("VideoPredictionEmbedderWithEncoder")]
    emb_cfg = {"target": emb_cfg["target"],
               "params": {**emb_cfg["params"], "sigma_sampler_config": COND_SIGMA}}
    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(0)
        emb = instantiate_from_config(emb_cfg).eval()
    vid = (torch.from_numpy(frames[:2]).permute(0, 3, 1, 2).float() / 127.5 - 1).cuda()
    # three encodes of the 2 frames, #9 at each of the encoder's norms a chunk
    expected = {name: 0 for name, *_ in KERNELS}
    expected["group_stats"] = 3 * _chunks(2, emb.en_chunk) * sum(
        isinstance(m, FoldedGroupNorm) for m in emb.encoder.encoder.modules())
    reset_launches()
    with torch.no_grad():
        noised = emb(vid, generator=torch.Generator(device="cuda").manual_seed(3))
        clean = emb(vid)
        sigmas, noise = emb.draw(vid, torch.Generator(device="cuda").manual_seed(3))
        by_hand = emb(vid + noise * sigmas[:, None, None, None])
    launches = read_launches(expected)
    _check_launches(launches, expected)
    err = ((noised - by_hand).abs().max() / by_hand.abs().max()).item()
    if noised.shape != (2 * emb.n_copies, 4, 64, 64) or not torch.isfinite(noised).all() \
            or err > 1e-5 or torch.equal(noised, clean):
        raise AssertionError(f"σ-noised conditioning frames: shape {tuple(noised.shape)}, error "
                             f"{err} against the frames noised by hand")
    print(f"[path16] conditioning-frame embedder with EDMSampling(p_mean -3, p_std 0.5): σ "
          f"{[round(s, 4) for s in sigmas.tolist()]}, output {tuple(noised.shape)} within "
          f"{err:.1e} of the encode of the frames noised by hand, "
          f"{((noised - clean).abs().max()).item():.3f} from the clean encode; launches "
          f"{launches} ({time.perf_counter() - t0:.1f} s)", flush=True)
    del emb
    torch.cuda.empty_cache()
    return launches


def module_surface_path(frames: np.ndarray) -> dict:
    """Main path 16: softsplat and correlation on the card against float64,
    every transform on demo/3.png, the JPEG fixtures against their cv2
    goldens, `setup_logger`, inference-v01's full-width VideoUNet with
    UNET_OPTIONS at b 1, t 4, 32² on the card (launches equal to the
    module's count, finite) against the CPU in fp32 (within 1.5 × the plain
    bf16 error), and the σ-noised conditioning-frame embedder (#9 launches
    equal to its encodes' norms). Returns the launches of the UNet call and
    the embedder's encodes."""
    import torch

    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_16_", dir=os.path.join(ROOT, "outputs"))
    softsplat_phase(frames)
    correlation_phase()
    torch.cuda.empty_cache()
    transforms_phase()
    jpeg_phase()
    logger_phase(out_dir)
    launches = unet_reference_phase(os.path.join(ROOT, "configs", "inference-v01.yaml"),
                                    overrides=UNET_OPTIONS, label=f" with {UNET_OPTIONS}",
                                    **OPTIONS_CHECK)
    launches = _sum_launches(launches, cond_sigma_phase(frames))
    print(f"[path16] main path 16 in {time.perf_counter() - t0:.1f} s; launches {launches}",
          flush=True)
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


OTHER_SAMPLERS = ("HeunEDMSampler", "EulerAncestralSampler", "DPMPP2SAncestralSampler",
                  "LinearMultistepSampler", "DPMPP2MSampler")
SAMPLER_STEPS = 4


def samplers_path(steps: int = SAMPLER_STEPS) -> dict:
    """Main path 9: one full-width stage-1 engine (configs/inference-v01.yaml,
    random weights), `i2v.generate_orbit` on demo/3.png (16 × 512²) once
    with each other sampler, built from the config's sampler_config with
    only `target` changed (DPM++(2S) at η = 1, LMS at order 4), `steps`
    steps each, then Heun with encoder_reuse=2. Checks finite frames of the
    expected shape, the UNet's calls and the launches against the plan for
    each run; prints each sampler's seconds. Returns the launches summed
    over the runs."""
    import torch

    from hi3d_tpu_torch.config import instantiate_from_config, load_config
    from hi3d_tpu_torch.pipelines import i2v
    from hi3d_tpu_torch.pipelines.common import load_inference_model

    config = os.path.join(ROOT, "configs", "inference-v01.yaml")
    sampler_config = load_config(config)["model"]["params"]["sampler_config"]
    t0 = time.perf_counter()
    model = load_inference_model(config, None, "cuda", tag="samplers", seed=0)
    frames = i2v.prepare_frames(os.path.join(ROOT, "demo", "3.png"), model.num_samples,
                                (512, 512))
    total = {}
    for name, reuse in [(n, 0) for n in OTHER_SAMPLERS] + [("HeunEDMSampler", 2)]:
        model.sampler = instantiate_from_config(
            {**sampler_config, "target": f"sgm.modules.diffusionmodules.sampling.{name}"})
        expected = expected_launches(config, steps, "i2v", sampler=name, encoder_reuse=reuse)
        whole, dec = unet_calls(name, steps, reuse)
        timer = i2v.PhaseTimer(model.device)
        reset_launches()
        with UNetProbe() as probe:
            out = i2v.generate_orbit(model, frames, generator=torch.Generator("cuda").manual_seed(0),
                                     num_steps=steps, encoder_reuse=reuse, output_dtype="uint8",
                                     timer=timer)
        launches = read_launches(expected)
        calls = probe.counts()
        label = f"{name}{f' encoder_reuse={reuse}' if reuse else ''}"
        print(f"[samplers] {label}, {steps} steps: sampler {timer.rows['sampler']:.3f} s, UNet "
              f"calls {calls}, median ms a UNet call {probe.median_ms()}, frames mean "
              f"{out.mean():.2f} std {out.std():.2f}, launches {launches}", flush=True)
        if out.shape != frames.shape or out.dtype != np.uint8:
            raise AssertionError(f"{label}: frames {out.shape} {out.dtype}")
        _check_calls(f"9 ({label})", calls,
                     {k: v for k, v in (("whole B32", whole), ("decoder B32", dec)) if v})
        _check_launches(launches, expected)
        total = _sum_launches(launches, total) if total else launches
    print(f"[samplers] main path 9 {time.perf_counter() - t0:.1f} s (model build included)",
          flush=True)
    del model
    torch.cuda.empty_cache()
    return total


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
    from hi3d_tpu_torch.pipelines.common import configure_precision
    from hi3d_tpu_torch.training.trainer import Trainer

    configure_precision()  # as train.main: fp32 convolutions and matmuls without TF32
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
        trainer = Trainer(engine, logdir=os.path.join(out_dir, f"run{t}"), batch_size=b,
                          logger_backend="jsonl")
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


def profile_train2(steps: int = 2) -> None:
    """Main path 10's step taken apart, at configs/train-v02.yaml as written
    (1 video × 16 frames × 1024², random weights): a random video in [-1, 1]
    made on the card, masks with a quarter of background, the dataset's
    kernels (the loader is not in the window). After one step that is not
    timed, `steps` steps each timed in parts, the card synchronised around
    each — `add_custom_cond` (the degradation and the noise augmentation),
    the engine's VAE encode of the 16 frames, the conditioner (ViT-H on
    frame 0, the DPT and the VAE embedder on the 16 frames), and the whole
    train step, whose rest is the UNet's forward, recompute and backward and
    AdamW — then `steps` steps under torch.profiler, reported as
    `profile_serve`'s are.

        python3 chip_smoke.py --profile-train2"""
    import shutil
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from hi3d_tpu_torch.config import instantiate_from_config, load_config
    from hi3d_tpu_torch.data.kernels import DEFAULT_DEGRADATION_OPT, sample_frame_kernels
    from hi3d_tpu_torch.pipelines.common import configure_precision
    from hi3d_tpu_torch.training.trainer import Trainer

    configure_precision()  # as train.main: fp32 convolutions and matmuls without TF32
    out_dir = tempfile.mkdtemp(prefix="chip_profile_train2_", dir=os.path.join(ROOT, "outputs"))
    cfg = load_config(os.path.join(ROOT, "configs", "train-v02.yaml"))
    params = dict(cfg["model"]["params"])
    params.pop("ckpt_path", None)
    params.setdefault("base_learning_rate", cfg["model"].get("base_learning_rate"))
    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(0)
        engine = instantiate_from_config({"target": cfg["model"]["target"], "params": params})
    t, hw = params["num_samples"], cfg["data"]["params"]["height"]
    trainer = Trainer(engine, logdir=os.path.join(out_dir, "run"), batch_size=1,
                      logger_backend="jsonl")
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1, k2, ks = (torch.from_numpy(k)[None].cuda()
                  for k in sample_frame_kernels(DEFAULT_DEGRADATION_OPT, t, np.random.RandomState(0)))
    batch = {"video": torch.rand((1, t, 3, hw, hw), generator=gen, device="cuda") * 2 - 1,
             "elevation": torch.full((1,), 10.0, device="cuda"),
             "masks": (torch.rand((1, t, hw, hw), generator=gen, device="cuda") > 0.25).float(),
             "kernel1s": k1, "kernel2s": k2, "sinc_kernels": ks}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    parts = {"add_custom_cond": [], "vae_encode": [], "conditioner": [], "train_step": []}
    for i in range(1 + steps):
        cond, dt = timed(lambda: engine.add_custom_cond(batch, infer=False, generator=gen))
        frames = cond["video"].reshape(t, 3, hw, hw).permute(0, 2, 3, 1)
        _, de = timed(lambda: engine.encode_first_stage(frames))
        _, dc = timed(lambda: engine.conditioner(cond, generator=gen))
        _, ds = timed(lambda: trainer.train_step(cond, gen))
        if i:
            for k, v in zip(parts, (dt, de, dc, ds)):
                parts[k].append(v)
    med = {k: statistics.median(v) for k, v in parts.items()}
    rest = med["train_step"] - med["vae_encode"] - med["conditioner"]
    print(f"[profile] train-v02 step parts, median of {steps} (s): add_custom_cond "
          f"{med['add_custom_cond']:.4f} {parts['add_custom_cond']}; train step "
          f"{med['train_step']:.4f} {parts['train_step']}, of which the engine's VAE encode "
          f"{med['vae_encode']:.4f}, the conditioner {med['conditioner']:.4f} and the rest "
          f"(UNet forward, recompute, backward; AdamW) {rest:.4f}; card {card_line()}",
          flush=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(engine.add_custom_cond(batch, infer=False, generator=gen), gen)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    prof.stop()
    _profile_report(prof, f"stage-2 training, 1 × {t} frames at {hw}², peak allocated "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", steps, host_ms)
    shutil.rmtree(out_dir)


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
    if sys.argv[1:2] == ["--replay-degradation"]:
        os.makedirs(os.path.join(ROOT, "outputs"), exist_ok=True)
        replay_degradations(*map(int, sys.argv[2:3]))
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
    if sys.argv[1:] == ["--profile-train2"]:
        profile_train2()
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
    if sys.argv[1:] == ["--t2i"]:
        t2i_phases()
        return
    if sys.argv[1:] == ["--module-surface"]:
        module_surface_path(path1_frames(None))
        return

    measured = kernel_phase()
    print("[smoke] kernel phase ok", flush=True)
    measured.update(backward_kernel_phase())
    print("[smoke] backward kernel phase ok", flush=True)
    by_path = reference_phases()
    print(f"[smoke] main path 1: configs/inference-v01.yaml, 16×512², {NUM_STEPS} steps, "
          "random weights", flush=True)
    by_path["i2v"], stage1_dir, phases1 = main_path(NUM_STEPS)
    print(f"[smoke] main path 2: configs/train-v01.yaml, {TRAIN_STEPS} steps, random weights",
          flush=True)
    by_path["train"], path2 = training_path(TRAIN_STEPS)
    print(f"[smoke] main path 2b: configs/train-v01.yaml at 1 × {LONG_CLIP} frames, "
          f"{LONG_CLIP_STEPS} steps, random weights (#7 on every frame-axis site)", flush=True)
    by_path["train48"] = long_clip_training_path()
    print(f"[smoke] main path 3: configs/inference-v02.yaml, 16×1024², {STAGE2_STEPS} steps, "
          "random weights, on main path 1's frames", flush=True)
    by_path["v2v"], phases3, peak3 = stage2_path(STAGE2_STEPS, stage1_dir)
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
    print(f"[smoke] main path 7: i2v --cfg_interval 0.3 6 on {os.path.relpath(PATH7_IMAGE, ROOT)}, "
          f"configs/inference-v01.yaml, 16×512², "
          f"{NUM_STEPS} steps (CFG on steps 15–19, single passes elsewhere), random weights",
          flush=True)
    by_path["i2v_cfg_interval"], _, phases7 = main_path(
        NUM_STEPS, ["--cfg_interval", "0.3", "6"], "7", {"whole B32": 5, "whole B16": 20},
        image=PATH7_IMAGE)
    print(f"[smoke] sampler seconds, stage 1: path 7 {phases7['sampler']} s, path 1 "
          f"{phases1['sampler']} s", flush=True)
    print(f"[smoke] main path 8: v2v --encoder_reuse 3, configs/inference-v02.yaml, 16×1024², "
          f"{STAGE2_STEPS} steps (9 whole, 16 decoder-only), random weights, on main path 1's "
          "frames", flush=True)
    by_path["v2v_encoder_reuse"], phases8, peak8 = stage2_path(
        STAGE2_STEPS, stage1_dir, ["--encoder_reuse", "3"], "8", 3,
        {"whole B32": 9, "decoder B32": 16})
    print(f"[smoke] stage 2: sampler path 8 {phases8['sampler']} s, path 3 {phases3['sampler']} "
          f"s; peak allocated path 8 {peak8:.2f} GB, path 3 {peak3:.2f} GB", flush=True)
    print(f"[smoke] main path 9: generate_orbit with {', '.join(OTHER_SAMPLERS)}, then Heun with "
          f"encoder_reuse=2; configs/inference-v01.yaml, 16×512², {SAMPLER_STEPS} steps each, "
          "random weights", flush=True)
    by_path["samplers"] = samplers_path()
    print(f"[smoke] main path 10: configs/train-v02.yaml, {STAGE2_TRAIN_STEPS} steps, 1 × 16 × "
          "1024², random weights, the conditioning video degraded on the card", flush=True)
    by_path["train_stage2"] = stage2_training_path()
    print(f"[smoke] main path 11: configs/train-v01.yaml under a world-1 NCCL process group "
          f"(torchrun's environment), {DIST_TRAIN_STEPS} steps, 2 × 16 × 512², random weights, "
          "ZeRO-2 AdamW", flush=True)
    by_path["train_dist"] = distributed_training_path(path2)
    print(f"[smoke] main path 12: AutoencoderTrainer (the VAE of configs/inference-v01.yaml, a "
          f"3-layer PatchGAN, VGG16 LPIPS), {AE_TRAIN_STEPS} steps of {AE_BATCH} × 512², random "
          "weights", flush=True)
    by_path["ae_train"] = ae_training_path()
    print(f"[smoke] main path 13: SVD's first stage (temporal VideoDecoder), {SVD_FRAMES} × 512² "
          "from main path 1, conv-only and all, random weights", flush=True)
    by_path["svd_vae"] = svd_vae_path(stage1_dir)
    by_path.update(t2i_phases(os.path.join(stage1_dir, "first_step", "frames")))
    print("[smoke] main path 16: softsplat, correlation, transforms, JPEG, the logger, the "
          "VideoUNet's options, the σ-noised conditioning frames", flush=True)
    by_path["modules"] = module_surface_path(path1_frames(stage1_dir))
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
