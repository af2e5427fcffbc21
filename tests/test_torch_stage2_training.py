"""Stage-2 training slice: hi3d_tpu_torch against hi3d_tpu on the CPU.

Modules and their tolerances:
- kernels (`sample_frame_kernels` and the generators): bit-equal to JAX's;
- `filter2d` against `hi3d_tpu.data.degradation._filter2d` (cv2.filter2D,
  BORDER_REFLECT, frames narrower than the pad of 10 included): fp32
  rounding, max |Δ| ≤ 2e-6 (cv2 filters 21×21 kernels through a DFT;
  measured 9e-7); the border index map equals cv2.borderInterpolate;
- `resize` against `_resize` (cv2.resize on float32), 3 modes × down/up ×
  non-integer factors: with cv2's IPP path off, fp32 rounding, max |Δ| ≤
  5e-7 (measured 2.4e-7); with cv2's default IPP path, which computes its
  own linear and cubic coefficients, ≤ 1e-4 (measured 6.6e-5);
- `jpeg` against `_jpeg` (cv2 imencode/imdecode) at odd sizes (partial
  MCUs) and qualities 30/60/95: bit-equal (mean |Δ| 0 and no pixel beyond
  0 levels, measured and required);
- `DegradedImages` end to end against JAX's with the noise hook replaying
  JAX's numpy draws, over clips that visit every branch of the plan (cv2's
  default IPP path): at most 1 grey level anywhere, mean |Δ| ≤ 2e-3 levels,
  ≤ 2e-3 of the pixels off by more than half a level (measured: 1 level,
  1.8e-4 levels, 1.7e-4 of the pixels; the resizes' last-bit differences
  flip a uint8 truncation before a JPEG now and then);
- the stage-2 dataset sample against JAX's cv2 path (native loader off,
  IPP off): frames bit-equal at the render size, masks and kernels
  bit-equal, frames resized on load within one grey level (the port's float
  bilinear against cv2's fixed-point uint8 weights);
- `add_custom_cond(infer=False)`: frame 0 bit-equal, the degraded video
  within the end-to-end bounds above, cond_aug and the noise the port's own
  generator draws;
- the tiny stage-2 engine's loss (σ, ε, ucg masks and cond_frames pinned as
  tests/test_torch_training.py pins them) at 1e-5 relative, every UNet
  gradient by that file's rule (max |Δ| ≤ 1e-4 · max |jax| of the tensor +
  1e-6 · the largest gradient of the network);
- surgery and the safetensors reader/writer: bit-equal to
  tools/make_init_svd_to_vid2vid.surgery and to the `safetensors` package.
"""

import copy
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
import yaml

from test_torch_slice import RES, T, _randomize_zeros
from test_torch_stage2 import DPT_KW, _to_jax_dpt, tiny_stage2_config
from test_torch_training import LOSS_CFG, _write_renders, metrics_every_step

B = 2
UCG_EMBEDDERS = (0, 3)  # the image embedder (crossattn), the cond-video VAE (concat)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


class _NoIPP:
    """cv2 without its IPP path, for the duration of a block."""

    def __enter__(self):
        self.prev = cv2.ipp.useIPP()
        cv2.ipp.setUseIPP(False)

    def __exit__(self, *exc):
        cv2.ipp.setUseIPP(self.prev)


def replay_noise(kind, arg, device, rng, generator):
    """The port's noise hook drawing what the JAX package draws: the same
    arrays from the plan's RandomState, in NHWC order (Poisson frame by
    frame)."""
    if kind == "normal":
        return torch.from_numpy(rng.randn(*arg).astype(np.float32))
    return torch.from_numpy(np.stack([rng.poisson(lam) for lam in arg.numpy()]).astype(np.float64))


# ----------------------------------------------------------------- kernels

def test_sample_frame_kernels_bit_equal_to_jax():
    from hi3d_tpu.data import kernels as jk
    from hi3d_tpu_torch.data import kernels as tk

    assert tk.DEFAULT_DEGRADATION_OPT == jk.DEFAULT_DEGRADATION_OPT
    for seed in range(4):
        got = tk.sample_frame_kernels(tk.DEFAULT_DEGRADATION_OPT, 16, np.random.RandomState(seed))
        want = jk.sample_frame_kernels(jk.DEFAULT_DEGRADATION_OPT, 16, np.random.RandomState(seed))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32 and g.shape == (16, 21, 21)
            np.testing.assert_array_equal(g, w)
    for kind in tk.KERNEL_TYPES:  # each generator on its own, same stream after
        r1, r2 = np.random.RandomState(7), np.random.RandomState(7)
        got = tk.random_mixed_kernels([kind], [1.0], 15, (0.2, 3), (0.2, 3), rng=r1)
        want = jk.random_mixed_kernels([kind], [1.0], 15, (0.2, 3), (0.2, 3), rng=r2)
        np.testing.assert_array_equal(got, want)
        assert r1.uniform() == r2.uniform()
    np.testing.assert_array_equal(tk.circular_lowpass_kernel(1.3, 9, pad_to=21),
                                  jk.circular_lowpass_kernel(1.3, 9, pad_to=21))


# --------------------------------------------------------------- filter2d

def test_reflect_index_is_cv2_border_interpolate():
    from hi3d_tpu_torch.data.degradation import reflect_index

    for n in (1, 2, 3, 7, 10, 25):
        want = [cv2.borderInterpolate(p, n, cv2.BORDER_REFLECT) for p in range(-10, n + 10)]
        np.testing.assert_array_equal(reflect_index(n, 10), want)


@pytest.mark.parametrize("hw", [(40, 37), (9, 9), (5, 13), (1, 7)])
def test_filter2d_matches_jax(hw):
    from hi3d_tpu.data.degradation import _filter2d
    from hi3d_tpu_torch.data.degradation import filter2d
    from hi3d_tpu_torch.data.kernels import DEFAULT_DEGRADATION_OPT, sample_frame_kernels

    rnd = np.random.RandomState(sum(hw))
    video = rnd.rand(3, *hw, 3).astype(np.float32)
    k1, _, sinc = sample_frame_kernels(DEFAULT_DEGRADATION_OPT, 3, rnd)
    for k in (k1, sinc):
        got = _nhwc(filter2d(_nchw(video), torch.from_numpy(k)))
        want = _filter2d(video, k)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 2e-6


# ----------------------------------------------------------------- resize

RESIZE_CASES = [((40, 40), (61, 61)), ((40, 40), (13, 13)), ((37, 45), (16, 12)),
                ((20, 21), (33, 10)), ((30, 30), (45, 45)), ((256, 256), (77, 77)),
                ((154, 154), (307, 307))]


@pytest.mark.parametrize("mode", ["area", "bilinear", "bicubic"])
def test_resize_matches_jax(mode):
    from hi3d_tpu.data.degradation import _resize
    from hi3d_tpu_torch.data.degradation import resize

    rnd = np.random.RandomState(3)
    for (h, w), size in RESIZE_CASES:
        video = (rnd.rand(2, h, w, 3) * 1.2 - 0.1).astype(np.float32)  # past [0, 1], as after a sinc
        got = _nhwc(resize(_nchw(video), size, mode))
        with _NoIPP():
            exact = _resize(video, size, mode)
        ipp = _resize(video, size, mode)
        assert got.shape == exact.shape == (2, *size, 3)
        assert np.abs(got - exact).max() <= 5e-7, ((h, w), size)
        assert np.abs(got - ipp).max() <= 1e-4, ((h, w), size)
    same = _nchw(rnd.rand(1, 9, 9, 3).astype(np.float32))
    assert resize(same, (9, 9), mode) is same  # cv2 copies at the same size


# ------------------------------------------------------------------- JPEG

@pytest.mark.parametrize("hw", [(37, 45), (13, 29), (17, 16), (8, 8), (100, 77)])
def test_jpeg_bit_equal_to_jax(hw):
    from hi3d_tpu.data.degradation import _jpeg
    from hi3d_tpu_torch.data.degradation import jpeg, quant_tables

    rnd = np.random.RandomState(hw[0])
    smooth = cv2.GaussianBlur(rnd.rand(*hw, 3).astype(np.float32), (5, 5), 1.0)
    video = np.stack([rnd.rand(*hw, 3), smooth, 1.1 * smooth - 0.05]).astype(np.float32)
    qualities = [30, 60, 95]
    # `_jpeg` draws each frame's quality from its RandomState; hand it a
    # stand-in that returns the chosen ones
    fixed = type("Fixed", (), {"uniform": lambda self, lo, hi: float(qualities.pop(0))})()
    want = _jpeg(video, fixed, (30, 95))
    got = _nhwc(jpeg(_nchw(video), [30, 60, 95]))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    luma, chroma = quant_tables(30)  # scale 5000 // 30 = 166
    assert luma[0, 0] == (16 * 166 + 50) // 100 and chroma[7, 7] == (99 * 166 + 50) // 100
    assert quant_tables(5)[1].max() == 255 and quant_tables(100)[0].max() == 1


# ------------------------------------------------------ degradation plan

def test_distinct_levels_and_rate_scale_match_numpy():
    from hi3d_tpu_torch.data.degradation import distinct_levels, poisson_rate_scale

    rnd = np.random.RandomState(0)
    base = np.stack([rnd.rand(1, 30, 30) * 1.4 - 0.2, np.full((1, 30, 30), 0.5),
                     np.round(rnd.rand(1, 30, 30) * 9) / 255.0]).astype(np.float32)
    counts, bins = distinct_levels(torch.from_numpy(base))
    want = [len(np.unique(np.round(b * 255.0))) for b in base]
    assert counts.tolist() == want and bins >= max(want)
    vals = poisson_rate_scale(torch.tensor([1, 2, 10, 11, 100, 101, 1000, 1001]), 1001)
    ref = [10 ** np.ceil(np.log10(max(n, 2))) for n in (1, 2, 10, 11, 100, 101, 1000, 1001)]
    assert vals.tolist() == ref


class _RecordingState(np.random.RandomState):
    """A RandomState that records its `choice` draws (the up/down/keep
    decisions of the plan); its stream is the plain one."""

    def __init__(self, seed):
        super().__init__(seed)
        self.choices = []

    def choice(self, *args, **kwargs):
        out = super().choice(*args, **kwargs)
        self.choices.append(str(out))
        return out


def _clips(n, t, hw, seed):
    from hi3d_tpu_torch.data.kernels import DEFAULT_DEGRADATION_OPT, sample_frame_kernels

    rnd = np.random.RandomState(seed)
    video = (rnd.rand(n, t, *hw, 3) * 2 - 1).astype(np.float32)
    masks = (rnd.rand(n, t, *hw) > 0.3).astype(np.float32)
    kernels = [sample_frame_kernels(DEFAULT_DEGRADATION_OPT, t, rnd) for _ in range(n)]
    return video, masks, [np.stack([k[i] for k in kernels]) for i in range(3)]


def _level_errors(got, want):
    """|Δ| in grey levels of [0, 255] for videos in [-1, 1]."""
    return np.abs(got - want) * 127.5


def _check_end_to_end(d):
    assert d.max() <= 1.0 + 1e-4, d.max()
    assert d.mean() <= 2e-3, d.mean()
    assert (d > 0.5).mean() <= 2e-3, (d > 0.5).mean()


def test_degraded_images_match_jax(monkeypatch):
    """The whole plan, with JAX's numpy noise replayed, on 2 × 18 clips of
    3 frames at 48² that visit every branch: up/down/keep in both rounds,
    each resize mode at each of the four resizes, Gaussian and Poisson noise
    in colour and gray in both rounds, the second blur or not, and both
    orders of the final sinc and JPEG."""
    from hi3d_tpu.data.degradation import DegradedImages as JaxDegradedImages
    from hi3d_tpu_torch.data import degradation as td

    events = []
    real_resize = td.resize

    def recording_resize(frames, size, mode):
        events.append(("resize", mode))
        return real_resize(frames, size, mode)

    def recording_noise(kind, arg, device, rng, generator):
        events.append(("noise", kind, (arg if kind == "normal" else arg.shape)[-1] == 1))
        return replay_noise(kind, arg, device, rng, generator)

    real_filter = td.filter2d
    monkeypatch.setattr(td, "resize", recording_resize)
    monkeypatch.setattr(td, "filter2d", lambda *a: events.append(("filter",)) or real_filter(*a))
    port = td.DegradedImages()
    monkeypatch.setattr(port, "_noise", recording_noise)
    real_jpeg = port._jpeg
    monkeypatch.setattr(port, "_jpeg", lambda *a: events.append(("jpeg",)) or real_jpeg(*a))

    seen, errors = set(), []
    for seed in (11, 12):
        video, masks, (k1, k2, ks) = _clips(18, 3, (48, 48), seed)
        want = JaxDegradedImages()(video, masks, k1, k2, ks, rng=np.random.RandomState(seed))
        rng = _RecordingState(seed)
        events.clear()
        got = port(_nchw(video), torch.from_numpy(masks), k1, k2, ks, rng=rng)
        errors.append(_level_errors(_nhwc(got), want))
        np.testing.assert_array_equal(_nhwc(got[:, 0]), video[:, 0])
        clips, cur = [], []
        for e in events:  # a clip's events end with its fourth resize
            cur.append(e)
            if sum(x[0] == "resize" for x in cur) == 4:
                clips.append(cur)
                cur = []
        assert len(clips) == 18 and not cur
        for c, ev in enumerate(clips):
            at = [i for i, e in enumerate(ev) if e[0] == "resize"]
            last_jpeg = max(i for i, e in enumerate(ev) if e[0] == "jpeg")
            seen |= {f"updown1:{rng.choices[2 * c]}", f"updown2:{rng.choices[2 * c + 1]}",
                     f"blur2:{sum(e[0] == 'filter' for e in ev) == 3}",
                     "sinc_first" if last_jpeg > at[2] else "jpeg_first"}
            seen |= {f"mode{i}:{ev[j][1]}" for i, j in enumerate(at)}
            seen |= {f"noise{i}:{e[1]}:{'gray' if e[2] else 'colour'}"
                     for i, e in enumerate(x for x in ev if x[0] == "noise")}
    every = ({f"updown{r}:{d}" for r in (1, 2) for d in ("up", "down", "keep")}
             | {f"mode{i}:{m}" for i in range(4) for m in td.RESIZE_MODES}
             | {f"noise{i}:{k}:{g}" for i in range(2) for k in ("normal", "poisson")
                for g in ("gray", "colour")}
             | {"blur2:True", "blur2:False", "jpeg_first", "sinc_first"})
    assert every <= seen, sorted(every - seen)
    _check_end_to_end(np.concatenate([e.ravel() for e in errors]))


def test_degradation_on_its_own_stream_is_seeded():
    """Without the replay hook the noise comes from the torch generator: one
    seed gives one video; the output lies in [-1, 1], frame 0 is the clean
    frame, the background is white and the other frames are degraded."""
    from hi3d_tpu_torch.data.degradation import DegradedImages

    video, masks, (k1, k2, ks) = _clips(2, 3, (40, 40), 5)
    deg = DegradedImages()

    def run(seed):
        return deg(_nchw(video), torch.from_numpy(masks), k1, k2, ks,
                   rng=np.random.RandomState(seed), generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= -1.0 and a.max() <= 1.0
    assert torch.equal(a[:, 0], _nchw(video[:, 0]))
    bg = torch.from_numpy(masks[:, 1:] == 0)[:, :, None].expand(-1, -1, 3, -1, -1)
    assert torch.all(a[:, 1:][bg] == 1.0)
    assert (a[:, 1:] - _nchw(video[:, 1:])).abs().mean() > 0.05


# ---------------------------------------------------------------- dataset

@pytest.mark.parametrize("size,target", [(32, 32), (40, 32)])
def test_stage2_dataset_sample_matches_jax(tmp_path, monkeypatch, size, target):
    import hi3d_tpu.data.native_loader as native_loader
    from hi3d_tpu.data.video_dataset import VideoTrainDatasetStage2 as JaxDataset
    from hi3d_tpu_torch.data.video_dataset import VideoTrainDatasetStage2

    monkeypatch.setattr(native_loader, "available", lambda: False)  # JAX side on cv2
    root = _write_renders(tmp_path / "renders", 2, size, seed=size)
    ours = VideoTrainDatasetStage2(root, width=target, height=target, sample_frames=16,
                                   depth_folder="unused")
    ref = JaxDataset(root, width=target, height=target, sample_frames=16)
    for seed in range(2):
        got = ours.sample(np.random.RandomState(seed))
        with _NoIPP():
            want = ref.sample(np.random.RandomState(seed))
        assert set(got) == set(want)
        assert got["video"].shape == (16, 3, target, target)
        assert got["masks"].shape == (16, target, target) and got["masks"].dtype == np.float32
        assert got["caption"] == want["caption"] and got["elevation"] == want["elevation"]
        diff = np.abs(got["video"].transpose(0, 2, 3, 1) - want["video"]).max()
        assert diff <= (0.0 if size == target else 1.0 / 127.5 + 1e-6), diff
        np.testing.assert_array_equal(got["masks"], want["masks"])
        assert 0 < got["masks"].mean() < 1
        for k in ("kernel1s", "kernel2s", "sinc_kernels"):
            np.testing.assert_array_equal(got[k], want[k])


def test_stage2_data_module_resolves_and_batches(tmp_path):
    from hi3d_tpu_torch.config import instantiate_from_config
    from hi3d_tpu_torch.data.video_dataset import VideoDatasetStage2

    root = _write_renders(tmp_path / "renders", 1, 24, seed=3)
    data = instantiate_from_config({
        "target": "sgm.data.video_dataset_stage2_degradeImages.VideoDataset",
        "params": {"base_folder": root, "width": 24, "height": 24, "sample_frames": 4,
                   "batch_size": 2, "num_workers": 1,
                   "degradation_opt": {"final_sinc_prob": 0.0}}})
    assert isinstance(data, VideoDatasetStage2)
    loader = data.train_dataloader()
    batch = next(loader)
    loader.close()
    assert batch["video"].shape == (2, 4, 3, 24, 24) and batch["masks"].shape == (2, 4, 24, 24)
    assert batch["kernel1s"].shape == batch["sinc_kernels"].shape == (2, 4, 21, 21)
    # final_sinc_prob 0: every sinc kernel is the pulse
    assert (batch["sinc_kernels"][..., 10, 10] == 1).all()


# ------------------------------------------------------------- the engine

def train_config(embedder_target):
    cfg = tiny_stage2_config(embedder_target)
    p = cfg["params"]
    p["loss_fn_config"] = copy.deepcopy(LOSS_CFG)
    for i in UCG_EMBEDDERS:
        p["conditioner_config"]["params"]["emb_models"][i]["ucg_rate"] = 0.5
    return cfg


@pytest.fixture(scope="module")
def engines():
    from hi3d_tpu.config import instantiate_from_config as jax_instantiate
    from hi3d_tpu.convert.jax_to_torch import export_engine_state_dict
    from hi3d_tpu.convert.torch_to_jax import convert_state_dict, convert_vae_key, load_engine_params
    from hi3d_tpu_torch.config import instantiate_from_config

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HI3D_ZERO_INIT", "1")
        jm = jax_instantiate(train_config("test_torch_slice.TinyImageEmbedderJax"))
    jm.init(latent_hw=(RES // 8, RES // 8), num_frames=2)
    sd = _randomize_zeros(export_engine_state_dict(jm), 0)
    load_engine_params(jm, sd)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tm = instantiate_from_config(train_config("test_torch_slice.TinyImageEmbedderTorch"))
    tm.init_from_ckpt(sd)
    jemb, temb = jm.conditioner.embedders, tm.conditioner.embedders
    jemb[2].params = _to_jax_dpt(temb[2].model)
    jemb[3].encoder.params = convert_state_dict(
        {k: v.numpy() for k, v in temb[3].encoder.state_dict().items()}, convert_vae_key)
    return jm, tm


def test_add_custom_cond_train_matches_jax(engines, monkeypatch):
    """Training's conditioning: JAX's add_custom_cond degrades with a
    RandomState seeded from its key; the port's, handed the same
    RandomState and the replayed noise, gives the same degraded video, to
    which it adds its own cond_aug and noise draws."""
    from hi3d_tpu.data.degradation import DegradedImages as JaxDegradedImages
    from hi3d_tpu_torch.data.degradation import DegradedImages

    jm, tm = engines
    video, masks, (k1, k2, ks) = _clips(B, T, (RES, RES), 8)
    key = jax.random.PRNGKey(4)
    jb = jm.add_custom_cond({"video": jnp.asarray(video), "elevation": jnp.zeros(B),
                             "masks": masks, "kernel1s": k1, "kernel2s": k2,
                             "sinc_kernels": ks}, infer=False, rng=key)
    r_deg = jax.random.split(key, 3)[0]
    seed = int(np.asarray(r_deg).reshape(-1)[-1]) & 0x7FFFFFFF
    jdeg = JaxDegradedImages()(video, masks, k1, k2, ks, rng=np.random.RandomState(seed))

    port = DegradedImages()
    port._noise = replay_noise
    calls = []

    def pinned(video, masks, **kw):
        calls.append(kw.pop("rng"))
        return port(video, masks, rng=np.random.RandomState(seed), **kw)

    monkeypatch.setattr(tm, "degradation", pinned)
    gen = torch.Generator().manual_seed(9)
    tb = tm.add_custom_cond({"video": _nchw(video), "elevation": torch.zeros(B),
                             "masks": torch.from_numpy(masks), "kernel1s": torch.from_numpy(k1),
                             "kernel2s": torch.from_numpy(k2),
                             "sinc_kernels": torch.from_numpy(ks)}, infer=False, generator=gen)
    assert len(calls) == 1 and isinstance(calls[0], np.random.RandomState)
    # the port's own draws, replayed: the degradation's seed, cond_aug, noise
    twin = torch.Generator().manual_seed(9)
    torch.randint(2**31 - 1, (1,), generator=twin)
    aug = torch.exp(-3.0 + 0.5 * torch.randn((B,), generator=twin))
    noise = torch.randn((B * T, 3, RES, RES), generator=twin)
    assert torch.equal(tb["cond_aug"], aug)
    assert np.all((np.asarray(jb["cond_aug"]) > 0) & (np.asarray(jb["cond_aug"]) < 1))
    np.testing.assert_array_equal(_nhwc(tb["cond_frames_without_noise"]), video[:, 0])
    np.testing.assert_array_equal(np.asarray(jb["cond_frames_without_noise"]), video[:, 0])
    degraded = tb["cond_frames"] - aug.repeat_interleave(T)[:, None, None, None] * noise
    assert tuple(tb["cond_frames"].shape) == (B * T, 3, RES, RES)
    _check_end_to_end(_level_errors(_nhwc(degraded).reshape(jdeg.shape), jdeg))
    assert tuple(tb["image_only_indicator"].shape) == (B, T) and tb["num_video_frames"] == T


def _jax_ucg_masks(jm, rng):
    """Replay the JAX loss_fn's key splits (engine.make_loss_fn →
    GeneralConditioner.__call__) to get the keep masks it draws."""
    r_cond, _ = jax.random.split(rng)
    sizes = {0: B, 3: B * T}
    masks = []
    for i, emb in enumerate(jm.conditioner.embedders):
        r_cond, _, ucg_rng = jax.random.split(r_cond, 3)
        masks.append(np.asarray(jax.random.bernoulli(ucg_rng, 1.0 - emb.ucg_rate, (sizes[i],)),
                                np.float32) if emb.ucg_rate > 0 else None)
    return masks


def test_stage2_loss_and_gradients_match_jax(engines):
    from hi3d_tpu.convert.jax_to_torch import _export_tree, unet_path_to_torch

    jm, tm = engines
    rnd = np.random.RandomState(2)
    video = (rnd.rand(B, T, RES, RES, 3) * 2 - 1).astype(np.float32)
    inp = {
        "video": video,
        "elevation": np.array([10.0, -10.0], np.float32),
        "cond_frames_without_noise": video[:, 0],
        "cond_frames": (video.reshape(B * T, RES, RES, 3)
                        + 0.05 * rnd.randn(B * T, RES, RES, 3)).astype(np.float32),
        "cond_aug": np.array([0.05, 0.02], np.float32),
        "image_only_indicator": np.zeros((B, T), np.float32),
    }
    sigmas = np.array([0.7, 3.0], np.float32)
    noise = rnd.randn(B * T, RES // 8, RES // 8, 4).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    masks = _jax_ucg_masks(jm, rng)
    assert all(0 < m.sum() < m.size for m in masks if m is not None), "no dropout exercised"

    jm.loss_fn.parity_sigmas, jm.loss_fn.parity_noise = sigmas, noise
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.make_loss_fn()))(
        jm.params, {k: jnp.asarray(v) for k, v in inp.items()}, rng)
    jg = _export_tree(jax.device_get(jgrads), unet_path_to_torch, "")

    tm.loss_fn.parity_sigmas = torch.from_numpy(sigmas)
    tm.loss_fn.parity_noise = _nchw(noise)
    tm.conditioner.parity_ucg_keep = [None if m is None else torch.from_numpy(m) for m in masks]
    unet = tm.model.diffusion_model
    unet.zero_grad(set_to_none=True)
    try:
        batch = {k: _nchw(v) if k.startswith("cond_frames") else torch.from_numpy(v)
                 for k, v in inp.items()}
        batch["video"] = torch.from_numpy(video).permute(0, 1, 4, 2, 3)
        batch["num_video_frames"] = T
        loss = tm.make_loss_fn()(batch)
        loss.backward()
    finally:
        tm.conditioner.parity_ucg_keep = None
        tm.loss_fn.parity_sigmas = tm.loss_fn.parity_noise = None
        jm.loss_fn.parity_sigmas = jm.loss_fn.parity_noise = None
    assert np.isfinite(loss.item()) and loss.item() > 0
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    tg = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in unet.named_parameters()}
    assert set(tg) == set(jg)
    gmax = max(np.abs(v).max() for v in jg.values())
    for name, g in tg.items():
        ref = jg[name]
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + 1e-6 * gmax, f"{name}: err {err:.3e}"
    assert sum(bool(g.any()) for g in tg.values()) > 3 * len(tg) // 4
    assert tg["input_blocks.0.0.weight"][:, 4:13].abs().max() > 0  # the depth channels learn


# ------------------------------------------------- surgery and safetensors

def _svd_like_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "model.diffusion_model.label_emb.0.0.weight": torch.randn(6, 768, generator=g),
        "model.diffusion_model.input_blocks.0.0.weight": torch.randn(5, 8, 3, 3, generator=g),
        "model.diffusion_model.out.2.bias": torch.randn(4, generator=g),
        "first_stage_model.encoder.conv_in.weight": torch.randn(3, 3, 1, 1, generator=g),
    }


def test_surgery_bit_equal_to_tool(tmp_path):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tools.make_init_svd_to_vid2vid import surgery as jax_surgery
    from hi3d_tpu_torch.convert import load_checkpoint_file, save_safetensors
    from hi3d_tpu_torch.tools.make_init_svd_to_vid2vid import main, surgery

    sd = _svd_like_state()
    got = surgery(sd)
    want = jax_surgery({k: v.numpy() for k, v in sd.items()})
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    w = got["model.diffusion_model.input_blocks.0.0.weight"]
    assert w.shape == (5, 17, 3, 3) and not w[:, 4:13].any()
    assert got["model.diffusion_model.label_emb.0.0.weight"].shape == (6, 512)

    src, dst = tmp_path / "svd.safetensors", tmp_path / "vid2vid.safetensors"
    save_safetensors(sd, str(src))
    with pytest.raises(FileNotFoundError):
        main([str(tmp_path / "missing.safetensors"), str(dst)])
    main([str(src), str(dst)])
    out = load_checkpoint_file(str(dst))
    assert all(torch.equal(out[k], got[k]) for k in got)
    with pytest.raises(FileExistsError):
        main([str(src), str(dst)])
    with pytest.raises(ValueError, match="768"):
        surgery({"label_emb.0.0.weight": torch.zeros(2, 512)})


def test_safetensors_io_matches_package(tmp_path, monkeypatch):
    from safetensors.torch import load_file, save_file

    from hi3d_tpu_torch.convert import load_checkpoint_file, read_safetensors, save_safetensors

    g = torch.Generator().manual_seed(1)
    sd = {"f32": torch.randn(3, 5, generator=g), "bf16": torch.randn(7, generator=g).bfloat16(),
          "i64": torch.arange(-4, 9), "f16": torch.randn(2, 2, generator=g).half(),
          "i32": torch.arange(3, dtype=torch.int32), "u8": torch.arange(5, dtype=torch.uint8),
          "bool": torch.tensor([True, False, True]), "scalar": torch.tensor(2.5),
          "empty": torch.zeros(0, 4)}
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.safetensors"
    save_safetensors(sd, str(ours))
    save_file(sd, str(theirs), metadata={"format": "pt"})  # the reader skips __metadata__
    for got in (load_file(str(ours)), read_safetensors(str(theirs))):
        assert set(got) == set(sd)
        for k, v in sd.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    got = load_checkpoint_file(str(theirs))
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    header = b'{"x":{"dtype":"F32","shape":[4],"data_offsets":[0,8]}}'
    (tmp_path / "bad.safetensors").write_bytes(len(header).to_bytes(8, "little") + header
                                               + b"\x00" * 8)
    with pytest.raises(ValueError, match="need 16"):
        read_safetensors(str(tmp_path / "bad.safetensors"))


# -------------------------------------------------------------- the CLI

def _tiny_train_v02(tmp_path, renders):
    """configs/train-v02.yaml's shape at the tiny stage-2 size: the stage-2
    task, its data module and the degradation, trained on all parameters."""
    model = train_config("test_torch_slice.TinyImageEmbedderTorch")
    model["params"]["ckpt_path"] = str(tmp_path / "missing.safetensors")
    model["params"]["trained_param_keys"] = ["all"]
    model["params"]["scheduler_config"] = {
        "target": "hi3d_tpu.training.schedules.LambdaLinearScheduler",
        "params": {"warm_up_steps": [2], "f_min": [1.0], "f_max": [1.0], "f_start": [0.5],
                   "cycle_lengths": [1000]},
    }
    model["base_learning_rate"] = 1e-4
    cfg = {
        "model": model,
        "data": {"target": "sgm.data.video_dataset_stage2_degradeImages.VideoDataset",
                 "params": {"base_folder": renders, "width": RES, "height": RES,
                            "sample_frames": T, "batch_size": 1, "num_workers": 1}},
        "lightning": {"modelcheckpoint": {"params": {"every_n_train_steps": 1}},
                      "logger": "jsonl"},
    }
    path = tmp_path / "tiny-train-v02.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_train_cli_stage2_two_steps_then_resume(tmp_path, capsys, monkeypatch):
    """The train CLI on the tiny train-v02-shaped config: 2 steps (each
    degrading its batch's conditioning video), metrics (logged every step
    here) and checkpoints, then a resume that runs step 3 from the saved
    state."""
    from hi3d_tpu_torch.data import degradation
    from hi3d_tpu_torch.train import main

    metrics_every_step(monkeypatch)
    renders = _write_renders(tmp_path / "renders", 1, RES, seed=4)
    path = _tiny_train_v02(tmp_path, renders)
    seen = []
    real = degradation.DegradedImages.__call__

    def recording(self, video, masks=None, **kw):
        out = real(self, video, masks, **kw)
        seen.append((video, masks, out))
        return out

    monkeypatch.setattr(degradation.DegradedImages, "__call__", recording)
    common = ["--base", str(path), "--no_test", "True", "--device", "cpu", "--seed", "1"]
    trainer = main([*common, "--logdir", str(tmp_path / "logs"), "--max_steps", "2"])
    out = capsys.readouterr().out
    assert "random weights (smoke mode)" in out and "lr = 0.0001 (base 0.0001 × world 1" in out
    rows = [json.loads(line) for line in open(os.path.join(trainer.logdir, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in rows)
    assert len(seen) == 2
    video, masks, degraded = seen[0]
    assert masks is not None and tuple(masks.shape) == (1, T, RES, RES)
    assert torch.equal(degraded[:, 0], video[:, 0]) and not torch.equal(degraded, video)
    assert degraded.min() >= -1 and degraded.max() <= 1
    assert torch.all(degraded[:, 1:].permute(0, 1, 3, 4, 2)[masks[:, 1:] == 0] == 1.0)
    state = torch.load(os.path.join(trainer.logdir, "checkpoints", "last.pt"), weights_only=True)
    unet = trainer.engine.model.diffusion_model
    assert state["step"] == 2 and all(torch.equal(state["model"][n], p)
                                      for n, p in unet.state_dict().items())

    resumed = main([*common, "--resume", trainer.logdir, "--max_steps", "3"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.train_step.step == 3
    rows = [json.loads(line) for line in open(os.path.join(trainer.logdir, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 3]


def test_stage2_modules_run_without_jax_cv2_or_safetensors(tmp_path):
    """In a process where jax, hi3d_tpu, tools, cv2, PIL and safetensors do
    not import: the safetensors IO, the surgery tool, the kernels, the
    degradation, the stage-2 dataset and VideoLDMStage2.add_custom_cond
    (infer=False) run on the CPU at a tiny size, and every target of
    configs/train-v02.yaml resolves to a port class; so do the autoencoder
    modules (a VideoDecoder, two AutoencoderTrainer steps, a quantizer)."""
    renders = _write_renders(tmp_path / "renders", 1, 24, seed=6)
    code = f"""
import sys
for name in ('jax', 'hi3d_tpu', 'tools', 'cv2', 'PIL', 'safetensors'):
    sys.modules[name] = None
import numpy as np, torch
from hi3d_tpu_torch.convert import load_checkpoint_file, save_safetensors
from hi3d_tpu_torch.tools.make_init_svd_to_vid2vid import main
from hi3d_tpu_torch.data.video_dataset import VideoTrainDatasetStage2
from hi3d_tpu_torch.engine import VideoLDMStage2
save_safetensors({{'model.diffusion_model.input_blocks.0.0.weight': torch.ones(2, 8, 3, 3)}},
                 {str(tmp_path / 'a.safetensors')!r})
main([{str(tmp_path / 'a.safetensors')!r}, {str(tmp_path / 'b.safetensors')!r}])
w = load_checkpoint_file({str(tmp_path / 'b.safetensors')!r})['model.diffusion_model.input_blocks.0.0.weight']
assert w.shape == (2, 17, 3, 3)
s = VideoTrainDatasetStage2({renders!r}, width=24, height=24, sample_frames=4).sample(
    np.random.RandomState(0))
batch = {{k: torch.from_numpy(np.asarray(v))[None] for k, v in s.items() if k != 'caption'}}
from types import SimpleNamespace
from hi3d_tpu_torch.data.degradation import DegradedImages
engine = SimpleNamespace(degradation=DegradedImages(), num_samples=4)
out = VideoLDMStage2.add_custom_cond(engine, batch, infer=False,
                                     generator=torch.Generator().manual_seed(0))
assert out['cond_frames'].shape == (4, 3, 24, 24) and torch.isfinite(out['cond_frames']).all()
from hi3d_tpu_torch.config import get_obj_from_str, load_config
def targets(node):
    if isinstance(node, dict):
        yield from ([node['target']] if 'target' in node else [])
        for v in node.values(): yield from targets(v)
    elif isinstance(node, list):
        for v in node: yield from targets(v)
found = list(targets(load_config('configs/train-v02.yaml')))
assert len(found) > 15 and all(get_obj_from_str(t).__module__.startswith('hi3d_tpu_torch.')
                               for t in found)
from hi3d_tpu_torch.models import lpips, quantizers
from hi3d_tpu_torch.models.autoencoding import AutoencodingEngine
from hi3d_tpu_torch.models.discriminator import GeneralLPIPSWithDiscriminator
from hi3d_tpu_torch.models.temporal_ae import VideoDecoder
from hi3d_tpu_torch.training.ae_step import AutoencoderTrainer
dd = dict(ch=8, ch_mult=[1, 2], num_res_blocks=1, z_channels=4, resolution=16)
vd = VideoDecoder(time_mode='all', **dd)
assert vd(torch.randn(4, 4, 8, 8), timesteps=2).shape == (4, 3, 16, 16)
enc = {{'target': 'sgm.modules.diffusionmodules.model.Encoder', 'params': dd}}
dec = {{'target': 'sgm.modules.diffusionmodules.model.Decoder', 'params': dd}}
trainer = AutoencoderTrainer(AutoencodingEngine(enc, dec, {{
    'target': 'sgm.modules.autoencoding.regularizers.DiagonalGaussianRegularizer'}}),
    GeneralLPIPSWithDiscriminator(disc_start=0, perceptual_weight=0.0, disc_num_layers=2),
    device='cpu')
for i in range(2):
    loss, log = trainer.train_step(torch.rand(2, 3, 16, 16) * 2 - 1, i, torch.Generator().manual_seed(i))
    assert torch.isfinite(loss)
q = quantizers.VectorQuantizer(8, 4)
assert q(torch.randn(1, 4, 2, 2))[0].shape == (1, 4, 2, 2)
assert not any(sys.modules.get(k) for k in ('jax', 'hi3d_tpu', 'tools', 'cv2', 'PIL', 'safetensors'))
print('ok')
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
