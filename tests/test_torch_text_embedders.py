"""The port's text towers and the rest of sgm's embedder set against the
JAX package's, on the CPU in fp32, and GeneralConditioner's input_keys,
list/tuple outputs and generator passing, each built from one config in
both packages.

Towers are tiny (the JAX package's own tests' sizes); their JAX params are
carried into the port by `convert.clip_text_flax_state_dict`. The T5
encoders are a tiny `T5Config` written as a Hugging Face model directory
(config.json with model.safetensors or pytorch_model.bin) that the port
reads, with the same arrays in transformers' FlaxT5EncoderModel for JAX.
The draws of LowScaleEncoder (timestep, noise, the first stage's posterior
sample) and GaussianEncoder (its posterior sample) are pinned to JAX's.

Tolerances: relative L2 error ≤ 1e-5 (fp32 on both sides, summation order
only); the resizes (SpatialRescaler) ≤ 1e-6 absolute on [0, 1] inputs.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

os.environ.setdefault("USE_TF", "0")  # transformers: no TensorFlow import

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_unet2d import randomize

REL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


# --- the CLIP / OpenCLIP text towers ------------------------------------------

TOWER = dict(vocab_size=64, width=16, layers=3, heads=2, proj_dim=8, context_length=8)
IDS = np.array([[1, 5, 3, 63, 0, 0, 0, 0], [1, 9, 7, 2, 63, 0, 0, 0]], np.int32)  # EOT 63


def jax_text_embedder(kind: str, **kw):
    """JAX's FrozenOpenCLIPEmbedder ("openclip") or FrozenCLIPEmbedder
    ("clip", QuickGELU) with a tiny tower and randomised params."""
    from hi3d_tpu.conditioners import FrozenCLIPEmbedder, FrozenOpenCLIPEmbedder
    from hi3d_tpu.models.clip import CLIPTextTransformer

    emb = (FrozenOpenCLIPEmbedder(max_length=8, **kw) if kind == "openclip"
           else FrozenCLIPEmbedder(version=None, max_length=8, **kw))
    emb.module = CLIPTextTransformer(**TOWER, quick_gelu=kind == "clip", output_hidden=True)
    emb.init_params(jax.random.PRNGKey(0))
    emb.params = jax.tree_util.tree_map(np.asarray, randomize(emb.params, 11))
    return emb


def port_text_embedder(kind: str, jemb, **kw):
    """The port's embedder of the same kind holding JAX's tiny tower (the
    full-size tower is built on the meta device and replaced)."""
    from hi3d_tpu_torch.conditioners import FrozenCLIPEmbedder, FrozenOpenCLIPEmbedder
    from hi3d_tpu_torch.convert import clip_text_flax_state_dict
    from hi3d_tpu_torch.models.clip import CLIPTextTransformer

    with torch.device("meta"):
        emb = (FrozenOpenCLIPEmbedder(**kw) if kind == "openclip"
               else FrozenCLIPEmbedder(version=None, **kw))
    tower = CLIPTextTransformer(**TOWER, quick_gelu=kind == "clip")
    tower.load_state_dict(clip_text_flax_state_dict(jemb.params), strict=True)
    setattr(emb, "model" if kind == "openclip" else "transformer", tower)
    return emb


TOWER_CASES = {
    "openclip-last": ("openclip", dict(layer="last")),
    "openclip-penultimate": ("openclip", dict(layer="penultimate")),
    "openclip-pooled": ("openclip", dict(layer="pooled")),
    "openclip-penultimate-always_pooled": ("openclip", dict(layer="penultimate",
                                                            always_return_pooled=True)),
    "clip-last": ("clip", dict(layer="last")),
    "clip-pooled": ("clip", dict(layer="pooled")),
    "clip-hidden_2": ("clip", dict(layer="hidden", layer_idx=2)),
    "clip-hidden_-1-always_pooled": ("clip", dict(layer="hidden", layer_idx=-1,
                                                  always_return_pooled=True)),
}


@pytest.mark.parametrize("case", sorted(TOWER_CASES))
def test_text_tower_layers_and_pooling_match_jax(case):
    kind, kw = TOWER_CASES[case]
    jemb = jax_text_embedder(kind, **kw)
    ref = jemb(jnp.asarray(IDS))
    with torch.no_grad():
        out = port_text_embedder(kind, jemb, **kw)(torch.from_numpy(IDS))
    ref, out = (x if isinstance(x, tuple) else (x,) for x in (ref, out))
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        assert tuple(o.shape) == tuple(r.shape)
        assert _rel(_np(o), r) <= REL


def test_text_towers_refuse_raw_strings_and_bad_layers():
    from hi3d_tpu_torch.conditioners import FrozenCLIPEmbedder, FrozenOpenCLIPEmbedder

    jemb = jax_text_embedder("openclip")
    emb = port_text_embedder("openclip", jemb)
    with pytest.raises(NotImplementedError, match="pass token ids"):
        emb(["a photo of a cat"])
    with pytest.raises(ValueError, match="layer_idx"):
        FrozenCLIPEmbedder(version=None, layer="hidden")
    with pytest.raises(ValueError):
        FrozenOpenCLIPEmbedder(layer="hidden")


# --- T5, ByT5 and CLIP + T5 ---------------------------------------------------

T5_SIZES = dict(d_model=16, d_kv=4, d_ff=24, num_layers=2, num_heads=2,
                relative_attention_num_buckets=8, relative_attention_max_distance=16)


def write_hf_t5(root: pathlib.Path, seed: int, **config):
    """A tiny T5 as transformers' FlaxT5EncoderModel (for JAX) and the same
    arrays as a Hugging Face directory (for the port): config.json plus
    model.safetensors under `root/safetensors` and pytorch_model.bin under
    `root/bin`, with the tied `encoder.embed_tokens.weight` as the released
    files have it."""
    from flax.traverse_util import flatten_dict
    from safetensors.torch import save_file
    from transformers import FlaxT5EncoderModel, T5Config

    cfg = T5Config(**config)
    model = FlaxT5EncoderModel(cfg, seed=seed)
    model.params = jax.tree_util.tree_map(np.asarray, model.params)
    sd = {}
    for path, v in flatten_dict(model.params).items():
        name = ".".join(path[:-1])
        if path[-1] == "kernel":
            sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(v.T))
        elif path[-1] == "embedding":
            sd[f"{name}.weight"] = torch.from_numpy(np.array(v))
        else:
            sd[".".join(path)] = torch.from_numpy(np.array(v))
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"].clone()
    for fmt in ("safetensors", "bin"):
        d = root / fmt
        d.mkdir(parents=True)
        cfg.to_json_file(str(d / "config.json"))
        if fmt == "safetensors":
            save_file(sd, str(d / "model.safetensors"))
        else:
            torch.save(sd, d / "pytorch_model.bin")
    return model


@pytest.fixture(scope="module")
def t5_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("t5")
    t5 = write_hf_t5(root / "t5", 0, vocab_size=64, feed_forward_proj="gated-gelu", **T5_SIZES)
    byt5 = write_hf_t5(root / "byt5", 1, vocab_size=260, feed_forward_proj="relu", **T5_SIZES)
    return {"t5": (root / "t5", t5), "byt5": (root / "byt5", byt5)}


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_t5_embedder_reads_hf_files_as_jax(t5_dirs, fmt):
    """FrozenT5Embedder on ids: the port reading the Hugging Face directory
    against JAX's embedder holding the same arrays (its tokenizer is never
    reached with ids); and `convert.load_flax_t5` of the flax params."""
    from hi3d_tpu.conditioners import FrozenT5Embedder as JaxT5
    from hi3d_tpu_torch.conditioners import FrozenT5Embedder
    from hi3d_tpu_torch.convert import load_flax_t5
    from hi3d_tpu_torch.models.t5 import T5EncoderModel

    root, flax_model = t5_dirs["t5"]
    ids = np.random.RandomState(2).randint(0, 64, (2, 12)).astype(np.int32)
    jemb = JaxT5(str(root / fmt), max_length=12)
    jemb._model = flax_model
    ref = np.asarray(jemb(ids))
    with torch.no_grad():
        out = FrozenT5Embedder(str(root / fmt), max_length=12)(torch.from_numpy(ids))
        direct = T5EncoderModel(**json.loads((root / fmt / "config.json").read_text()))
        load_flax_t5(direct, flax_model.params)
        out2 = direct(torch.from_numpy(ids))
    assert out.shape == ref.shape == (2, 12, 16)
    assert _rel(_np(out), ref) <= REL and _rel(_np(out2), ref) <= REL


def test_byt5_embedder_on_raw_strings_matches_jax(t5_dirs):
    """ByT5 (a relu feed-forward here) on raw strings through the inline
    byte tokenizer of both packages."""
    from hi3d_tpu.conditioners import FrozenByT5Embedder as JaxByT5
    from hi3d_tpu_torch.conditioners import FrozenByT5Embedder

    root, flax_model = t5_dirs["byt5"]
    texts = ["Ab", "é clef à molette"]
    jemb = JaxByT5(str(root / "safetensors"), max_length=10)
    jemb._model = flax_model
    ref = np.asarray(jemb(texts))
    emb = FrozenByT5Embedder(str(root / "safetensors"), max_length=10)
    np.testing.assert_array_equal(emb.tokenize(texts), jemb.tokenize(texts))
    with torch.no_grad():
        out = emb(texts)
    assert _rel(_np(out), ref) <= REL


def test_byte_tokenizer():
    from hi3d_tpu_torch.conditioners import FrozenByT5Embedder

    ids = FrozenByT5Embedder(max_length=12).tokenize(["Ab", "é", "x" * 20])
    assert ids.shape == (3, 12)
    assert ids.tolist()[0][:4] == [ord("A") + 3, ord("b") + 3, 1, 0]
    assert ids.tolist()[1][:4] == [0xC3 + 3, 0xA9 + 3, 1, 0]
    assert ids.tolist()[2] == [ord("x") + 3] * 11 + [1]


def test_clip_t5_encoder_matches_jax(t5_dirs):
    """FrozenCLIPT5Encoder: [CLIP "last", T5] as a list, both matching JAX."""
    from hi3d_tpu.conditioners import FrozenCLIPT5Encoder as JaxCLIPT5
    from hi3d_tpu_torch.conditioners import FrozenCLIPT5Encoder

    root, flax_model = t5_dirs["t5"]
    jemb = JaxCLIPT5(clip_version=None, t5_version=str(root / "bin"), clip_max_length=8,
                     t5_max_length=8)
    jemb.clip_encoder = jax_text_embedder("clip")
    jemb.t5_encoder._model = flax_model
    ref = jemb(jnp.asarray(IDS))
    with torch.device("meta"):
        emb = FrozenCLIPT5Encoder(clip_version=None, t5_version=str(root / "bin"))
    emb.clip_encoder = port_text_embedder("clip", jemb.clip_encoder)
    with torch.no_grad():
        out = emb(torch.from_numpy(IDS))
    assert isinstance(out, list) and len(out) == 2
    for r, o in zip(ref, out):
        assert _rel(_np(o), r) <= REL


def test_t5_raw_strings_need_transformers_and_versions_need_a_directory(monkeypatch, tmp_path):
    from hi3d_tpu_torch.conditioners import FrozenT5Embedder

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(NotImplementedError, match="pass token ids"):
        FrozenT5Embedder(str(tmp_path))(["a cat"])
    with pytest.raises(FileNotFoundError, match="not a local directory"):
        FrozenT5Embedder("google/t5-v1_1-xl")(torch.zeros(1, 4, dtype=torch.long))


# --- labels, rescaling, the low-scale and Gaussian encoders ---------------------


def test_class_embedders_match_jax():
    from hi3d_tpu.conditioners import ClassEmbedder as JaxClass
    from hi3d_tpu.conditioners import ClassEmbedderForMultiCond as JaxMulti
    from hi3d_tpu_torch.conditioners import ClassEmbedder, ClassEmbedderForMultiCond

    c = np.array([1, 4, 0])
    for jcls, tcls, kw in ((JaxClass, ClassEmbedder, dict(add_sequence_dim=True)),
                           (JaxMulti, ClassEmbedderForMultiCond, {})):
        jemb = jcls(embed_dim=6, n_classes=5, **kw)
        jemb.input_key = "cls"
        jemb.init_params(jax.random.PRNGKey(3))
        emb = tcls(embed_dim=6, n_classes=5, **kw)
        emb.input_key = "cls"
        emb.embedding.weight.data = torch.from_numpy(np.array(jemb.params))
        with torch.no_grad():
            np.testing.assert_array_equal(_np(emb(torch.from_numpy(c))), np.asarray(jemb(c)))
            if tcls is ClassEmbedderForMultiCond:
                wrapped = emb([torch.from_numpy(c)])
                assert isinstance(wrapped, list) and len(wrapped) == 1
                np.testing.assert_array_equal(_np(wrapped[0]), np.asarray(jemb([c])[0]))
        assert emb.get_unconditional_conditioning(3)["cls"].tolist() == \
            np.asarray(jemb.get_unconditional_conditioning(3)["cls"]).tolist() == [4, 4, 4]


RESCALER_CASES = {
    "nearest-down2": dict(method="nearest", n_stages=2, multiplier=0.5),
    "linear-down": dict(method="linear", multiplier=0.5),
    "bilinear-up": dict(method="bilinear", multiplier=2.0),
    "bilinear-odd-remap_k3": dict(method="bilinear", multiplier=0.6, out_channels=5,
                                  kernel_size=3, bias=True),
    "bicubic-down": dict(method="bicubic", n_stages=1, multiplier=0.5),
    "bicubic-up-video": dict(method="bicubic", multiplier=1.5, wrap_video=True),
    "nearest-up-video": dict(method="nearest", multiplier=1.75, wrap_video=True),
}


@pytest.mark.parametrize("case", sorted(RESCALER_CASES))
def test_spatial_rescaler_matches_jax(case):
    from hi3d_tpu.conditioners import SpatialRescaler as JaxRescaler
    from hi3d_tpu_torch.conditioners import SpatialRescaler
    from hi3d_tpu_torch.convert import load_flax_tree

    kw = RESCALER_CASES[case]
    video = kw.get("wrap_video", False)
    rnd = np.random.RandomState(4)
    x = rnd.rand(*((2, 3, 12, 16, 3) if video else (2, 12, 16, 3))).astype(np.float32)
    jemb = JaxRescaler(in_channels=3, **kw)
    jemb.init_params(jax.random.PRNGKey(5))
    ref = np.asarray(jemb(jnp.asarray(x)))
    emb = SpatialRescaler(in_channels=3, **kw)
    if emb.channel_mapper is not None:
        load_flax_tree(emb.channel_mapper, jax.tree_util.tree_map(np.asarray, jemb.params))
    with torch.no_grad():
        out = _np(emb(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))))
    out = np.moveaxis(out, -3, -1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


DD = dict(ch=8, ch_mult=[1, 2], num_res_blocks=1, z_channels=4, attn_resolutions=[],
          resolution=16, double_z=True, in_channels=3, out_ch=3)
HW = 16  # image side; latents are HW/2


def _jax_draws(rng, mean_shape, b, max_noise_level):
    """JAX's LowScaleEncoder draws from `rng`: posterior ε (NHWC), t, noise."""
    r_enc, r_t, r_n = jax.random.split(rng, 3)
    eps = np.asarray(jax.random.normal(r_enc, mean_shape, jnp.float32))
    t = np.asarray(jax.random.randint(r_t, (b,), 0, max_noise_level))
    noise = np.asarray(jax.random.normal(r_n, mean_shape, jnp.float32))
    return eps, t, noise


def pin_low_scale(monkeypatch, eps, t, noise):
    """The port's posterior sample and LowScaleEncoder.draw made JAX's."""
    from hi3d_tpu_torch.conditioners import LowScaleEncoder
    from hi3d_tpu_torch.models.vae import DiagonalGaussianDistribution

    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))  # noqa: E731
    monkeypatch.setattr(DiagonalGaussianDistribution, "sample",
                        lambda self, generator=None: self.mean + self.std * nchw(eps))
    monkeypatch.setattr(LowScaleEncoder, "draw",
                        lambda self, z, generator: (torch.from_numpy(t).long(), nchw(noise)))


@pytest.fixture(scope="module")
def low_scale_pair():
    """JAX's LowScaleEncoder (a tiny AutoencoderKL, randomised) and the
    port's holding the same weights, with their config."""
    from hi3d_tpu.convert.jax_to_torch import _export_tree, vae_path_to_torch
    from hi3d_tpu.conditioners import LowScaleEncoder as JaxLowScale
    from hi3d_tpu_torch.conditioners import LowScaleEncoder
    from hi3d_tpu_torch.convert import load_reference_state_dict

    kw = dict(model_config={"target": "sgm.models.autoencoder.AutoencoderKL",
                            "params": {"ddconfig": DD}},
              linear_start=1e-4, linear_end=2e-2, timesteps=100, max_noise_level=25,
              output_size=6, scale_factor=0.5)
    jemb = JaxLowScale(**kw)
    jemb.init_params(jax.random.PRNGKey(0))
    jemb.model.params = randomize(jemb.model.params, 12)
    emb = LowScaleEncoder(**kw)
    load_reference_state_dict(emb.model, _export_tree(jemb.model.params, vae_path_to_torch,
                                                      "first_stage_model."), "first_stage_model.")
    return jemb, emb, kw


def test_low_scale_encoder_matches_jax_with_pinned_draws(monkeypatch, low_scale_pair):
    jemb, emb, kw = low_scale_pair
    x = np.tanh(np.random.RandomState(6).randn(2, HW, HW, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    z_ref, t_ref = jemb(jnp.asarray(x), rng=rng)
    pin_low_scale(monkeypatch, *_jax_draws(rng, (2, HW // 2, HW // 2, 4), 2,
                                           kw["max_noise_level"]))
    with torch.no_grad():
        z, t = emb(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))),
                   generator=torch.Generator().manual_seed(0))
        dec = emb.decode(z)
    assert z.shape == (2, 4, 6, 6) and t.shape == (2, 1) and t.dtype == torch.float32
    np.testing.assert_array_equal(_np(t), np.asarray(t_ref))
    assert _rel(np.moveaxis(_np(z), 1, -1), z_ref) <= REL
    assert torch.equal(dec, emb.model.decode(z / kw["scale_factor"]))


def test_gaussian_encoder_matches_jax_with_a_pinned_sample(monkeypatch):
    from hi3d_tpu.conditioners import GaussianEncoder as JaxGaussian
    from hi3d_tpu_torch.conditioners import GaussianEncoder
    from hi3d_tpu_torch.convert import load_flax_tree

    jemb = JaxGaussian(weight=2.0, **DD)
    jemb.init_params(jax.random.PRNGKey(0))
    jemb.params = jax.tree_util.tree_map(np.asarray, randomize(jemb.params, 13))
    emb = GaussianEncoder(weight=2.0, **DD)
    load_flax_tree(emb, jemb.params)
    x = np.tanh(np.random.RandomState(8).randn(2, HW, HW, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    jlog, jz = jemb(jnp.asarray(x), rng=rng)
    eps = np.asarray(jax.random.normal(rng, (2, HW // 2, HW // 2, 4), jnp.float32))
    pin_low_scale(monkeypatch, eps, np.zeros(2, np.int64), eps)
    with torch.no_grad():
        log, z = emb(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))),
                     generator=torch.Generator().manual_seed(0))
    assert z.shape == jz.shape == (2, (HW // 2) ** 2, 4)
    assert _rel(_np(z), jz) <= REL
    assert log["weight"] == jlog["weight"] == 2.0
    assert abs(log["loss"].item() - float(jlog["loss"])) <= REL * abs(float(jlog["loss"]))


# --- GeneralConditioner: input_keys, list/tuple outputs, generators -------------


class JaxPairSum:
    """Toy two-input embedder of the JAX package: 2a + b → vector."""

    def __new__(cls, **kw):
        from hi3d_tpu.conditioners import AbstractEmbedder

        class _PairSum(AbstractEmbedder):
            def __call__(self, a, b, rng=None):
                return 2.0 * jnp.asarray(a) + jnp.asarray(b)

        return _PairSum()


class JaxTokensAndVector:
    """Toy JAX embedder returning a tuple (crossattn (B, 3, 4), vector (B, 2))."""

    def __new__(cls, **kw):
        from hi3d_tpu.conditioners import AbstractEmbedder

        class _Pair(AbstractEmbedder):
            def __call__(self, x, rng=None):
                x = jnp.asarray(x)
                return jnp.tile(x[:, None, :4], (1, 3, 1)), x[:, 4:6]

        return _Pair()


class PortPairSum:
    def __new__(cls, **kw):
        from hi3d_tpu_torch.conditioners import AbstractEmbedder

        class _PairSum(AbstractEmbedder):
            def forward(self, a, b):
                return 2.0 * a + b

        return _PairSum()


class PortTokensAndVector:
    def __new__(cls, **kw):
        from hi3d_tpu_torch.conditioners import AbstractEmbedder

        class _Pair(AbstractEmbedder):
            def forward(self, x):
                return x[:, None, :4].repeat(1, 3, 1), x[:, 4:6]

        return _Pair()


class PortDraws:
    """Toy drawing embedder: a normal draw from the generator it is given."""

    def __new__(cls, **kw):
        from hi3d_tpu_torch.conditioners import AbstractEmbedder

        class _Draws(AbstractEmbedder):
            draws = True

            def forward(self, x, generator=None):
                return torch.randn(x.shape, generator=generator)

        return _Draws()


MOD = __name__


def conditioners(*embedders):
    """JAX's and the port's GeneralConditioner from one config: the port's
    toy targets replace JAX's (`Jax…` → `Port…`), sgm targets stay."""
    from hi3d_tpu.conditioners import GeneralConditioner as JaxConditioner
    from hi3d_tpu_torch.conditioners import GeneralConditioner

    cfg = list(embedders)
    port = [{**e, "target": e["target"].replace(f"{MOD}.Jax", f"{MOD}.Port")} for e in cfg]
    return JaxConditioner(cfg, rng=jax.random.PRNGKey(0)), GeneralConditioner(port)


def _same(c, jc):
    assert set(c) == set(jc)
    for k in c:
        assert tuple(c[k].shape) == tuple(jc[k].shape), k
        if np.any(np.asarray(jc[k])):
            assert _rel(_np(c[k]), jc[k]) <= REL, k
        else:
            assert not _np(c[k]).any(), k


def test_conditioner_takes_input_keys():
    """`input_keys` calls the embedder with those batch values, in order."""
    jcond, cond = conditioners({"target": f"{MOD}.JaxPairSum", "input_keys": ["a", "b"]})
    rnd = np.random.RandomState(10)
    batch = {"a": rnd.randn(2, 5).astype(np.float32), "b": rnd.randn(2, 5).astype(np.float32)}
    out = cond({k: torch.from_numpy(v) for k, v in batch.items()})
    _same(out, jcond(batch))
    assert torch.equal(out["vector"], 2 * torch.from_numpy(batch["a"]) + torch.from_numpy(batch["b"]))


def test_conditioner_routes_list_and_tuple_outputs():
    """A list (ClassEmbedderForMultiCond on a list-wrapped value) and a
    tuple (crossattn, vector) route element by element and concatenate,
    in forward and in get_unconditional_conditioning."""
    emb_cfgs = ({"target": "sgm.modules.encoders.modules.ClassEmbedderForMultiCond",
                 "input_key": "cls", "params": {"embed_dim": 3, "n_classes": 4}},
                {"target": f"{MOD}.JaxTokensAndVector", "input_key": "x"})
    jcond, cond = conditioners(*emb_cfgs)
    cond.embedders[0].embedding.weight.data = torch.from_numpy(np.array(jcond.embedders[0].params))
    x = np.random.RandomState(11).randn(2, 8).astype(np.float32)
    jb = {"cls": [np.array([0, 3])], "x": x}
    tb = {"cls": [torch.tensor([0, 3])], "x": torch.from_numpy(x)}
    out = cond(tb)
    assert out["vector"].shape == (2, 5) and out["crossattn"].shape == (2, 3, 4)
    _same(out, jcond(jb))
    c, uc = cond.get_unconditional_conditioning(tb, force_uc_zero_embeddings=["x"])
    jc, juc = jcond.get_unconditional_conditioning(jb, force_uc_zero_embeddings=["x"])
    _same(c, jc)
    _same(uc, juc)
    assert not uc["crossattn"].any()


def test_conditioner_passes_its_generator_to_drawing_embedders(monkeypatch, low_scale_pair):
    """Embedders with `draws` get the conditioner's generator (a toy draw
    equals the same seed's draw); LowScaleEncoder through the conditioner,
    its draws pinned to those JAX makes from its split of the rng, equals
    JAX's [concat, vector]; without a generator it draws from seed 0 (JAX:
    PRNGKey(0)). GaussianEncoder's (log, z) passes neither conditioner."""
    from hi3d_tpu.conditioners import GeneralConditioner as JaxConditioner
    from hi3d_tpu_torch.conditioners import GeneralConditioner

    toy = GeneralConditioner([{"target": f"{MOD}.PortDraws", "input_key": "x"}])
    out = toy({"x": torch.zeros(2, 6)}, generator=torch.Generator().manual_seed(3))
    assert torch.equal(out["vector"], torch.randn((2, 6), generator=torch.Generator().manual_seed(3)))

    jemb, emb, kw = low_scale_pair
    cfg = [{"target": "sgm.modules.encoders.modules.LowScaleEncoder", "input_key": "img",
            "params": kw}]
    jcond, cond = JaxConditioner(cfg), GeneralConditioner(cfg)
    jcond.embedders[0] = jemb
    jemb.input_key = "img"
    cond.embedders[0] = emb
    emb.input_key = "img"
    x = np.tanh(np.random.RandomState(12).randn(2, HW, HW, 3)).astype(np.float32)
    tx = {"img": torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))}
    rng = jax.random.PRNGKey(14)
    ref = jcond({"img": jnp.asarray(x)}, rng=rng)
    _, emb_rng, _ = jax.random.split(rng, 3)
    lat = (2, HW // 2, HW // 2, 4)
    pin_low_scale(monkeypatch, *_jax_draws(emb_rng, lat, 2, kw["max_noise_level"]))
    out = cond(tx, generator=torch.Generator().manual_seed(0))
    assert out["concat"].shape == (2, 4, 6, 6) and out["vector"].shape == (2, 1)
    _same({k: v.permute(0, 2, 3, 1) if v.ndim == 4 else v for k, v in out.items()}, ref)
    jc, _ = jcond.get_unconditional_conditioning({"img": jnp.asarray(x)})
    pin_low_scale(monkeypatch, *_jax_draws(jax.random.PRNGKey(0), lat, 2, kw["max_noise_level"]))
    c, _ = cond.get_unconditional_conditioning(tx)
    _same({k: v.permute(0, 2, 3, 1) if v.ndim == 4 else v for k, v in c.items()}, jc)

    gauss = [{"target": "sgm.modules.encoders.modules.GaussianEncoder", "input_key": "img",
              "params": DD}]
    with pytest.raises(AttributeError):
        JaxConditioner(gauss)({"img": jnp.asarray(x)})
    with pytest.raises(AttributeError):
        GeneralConditioner(gauss)(tx)


# --- the port imports no JAX, and transformers only to tokenize T5 ------------


def _imports(path: pathlib.Path):
    """(module imported, enclosing function's qualified name) of every import."""
    tree = ast.parse(path.read_text())
    found = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                visit(child, scope + [child.name])
            elif isinstance(child, ast.Import):
                found.extend((a.name, ".".join(scope)) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                found.append((child.module, ".".join(scope)))
            else:
                visit(child, scope)

    visit(tree, [])
    return found


def test_port_imports_no_jax_and_transformers_only_in_the_t5_tokenizer():
    files = sorted((ROOT / "hi3d_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    transformers_sites = []
    for path in files:
        for mod, scope in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "hi3d_tpu"), (path, mod)
            if top == "transformers":
                transformers_sites.append((path.name, scope))
    assert transformers_sites == [("conditioners.py", "FrozenT5Embedder.tokenize")]
    code = """
import sys
for name in ('jax', 'flax', 'transformers', 'hi3d_tpu'):
    sys.modules[name] = None
import torch
from hi3d_tpu_torch import conditioners, registry, convert
from hi3d_tpu_torch.models import clip, inception, t5, unet, wrappers
from hi3d_tpu_torch.config import get_obj_from_str, load_config
for name in registry._ALIASES:
    get_obj_from_str(name)
print(conditioners.FrozenByT5Embedder(max_length=6).tokenize(['hi']).tolist())
try:
    conditioners.FrozenT5Embedder('x')(['hi'])
except NotImplementedError as e:
    print('refused:', e)
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "[[107, 108, 1, 0, 0, 0]]" in r.stdout and "refused:" in r.stdout
