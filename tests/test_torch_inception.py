"""The port's InceptionV3 (the FID trunk and its embedder) against the JAX
package's, on the CPU in fp32.

One random torchvision-layout Inception-v3 file (with the `fc` and
`AuxLogits` heads and `num_batches_tracked` counters a released file has)
is loaded by both packages' readers; inputs come from numpy.random.

Tolerances: relative L2 error ≤ 1e-5 of every block's output (fp32 on both
sides, summation order only); the 512² → 299² antialiased bilinear resize
≤ 1e-6 absolute against JAX's own resampling matrices applied in float64.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401

REL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def inception_file(tmp_path_factory):
    """A torchvision-layout file: the port trunk's tensors randomised (BN
    statistics too), plus fc, AuxLogits and num_batches_tracked entries."""
    from hi3d_tpu_torch.models.inception import InceptionV3Trunk

    torch.manual_seed(0)
    g = torch.Generator().manual_seed(1)
    sd = {}
    for k, v in InceptionV3Trunk().state_dict().items():
        if k.endswith("running_var"):
            v = 1.0 + 0.2 * torch.rand(v.shape, generator=g)
        elif k.endswith(("running_mean", "bn.bias")):
            v = 0.1 * torch.randn(v.shape, generator=g)
        elif k.endswith("bn.weight"):
            v = 1.0 + 0.1 * torch.randn(v.shape, generator=g)
        sd[k] = v
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    path = tmp_path_factory.mktemp("inception") / "pt_inception.pth"
    torch.save(sd, path)
    return str(path)


@pytest.mark.parametrize("fid_variant", [True, False], ids=["pytorch_fid", "torchvision"])
def test_inception_trunk_blocks_match_jax(inception_file, fid_variant):
    """All four FID blocks at a 96² input, pytorch-fid's pool modes and
    torchvision's, weights read by each package from the same file."""
    from hi3d_tpu.models.inception import InceptionV3Trunk as JaxTrunk
    from hi3d_tpu.models.inception import load_inception_params
    from hi3d_tpu_torch.convert import load_inception_state_dict
    from hi3d_tpu_torch.models.inception import InceptionV3Trunk

    x = np.random.RandomState(2).randn(2, 96, 96, 3).astype(np.float32)
    jm = JaxTrunk(output_blocks=(0, 1, 2, 3), fid_variant=fid_variant)
    refs = jax.jit(jm.apply)(load_inception_params(inception_file), x)
    tm = InceptionV3Trunk((0, 1, 2, 3), fid_variant)
    tm.load_state_dict(load_inception_state_dict(inception_file), strict=True)
    with torch.no_grad():
        outs = tm(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    for ref, out in zip(refs, outs):
        got = out.numpy().transpose(0, 2, 3, 1)
        assert got.shape == ref.shape
        assert _rel(got, ref) <= REL


def test_inception_embedder_resizes_512_to_299_as_jax(inception_file):
    """The config-facing InceptionV3 on a 512² image in [0, 1] with
    normalize_input: the antialiased bilinear downscale to 299² against
    JAX's own weight matrices in float64; the embedder (resize, [-1, 1],
    trunk) against JAX's at FID block 0 (the trunk's deeper blocks are held
    above); the default embedder's (B, 2048) features are the pooled block 3
    squeezed; JAX's params carried by `convert.load_flax_inception` equal
    the file's."""
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    from hi3d_tpu.models.inception import InceptionV3 as JaxInception
    from hi3d_tpu_torch.convert import load_flax_inception, load_inception_state_dict
    from hi3d_tpu_torch.models.clip import image_resize
    from hi3d_tpu_torch.models.inception import InceptionV3, InceptionV3Trunk

    x = np.random.RandomState(3).rand(1, 512, 512, 3).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    w = np.asarray(compute_weight_mat(512, 299, 299 / 512, 0.0, _fill_triangle_kernel, True),
                   np.float64)
    want = np.einsum("hH,nchw,wW->ncHW", w, xt.numpy().astype(np.float64), w, optimize=True)
    resized = image_resize(xt, (299, 299), "bilinear")
    np.testing.assert_allclose(resized.numpy(), want, rtol=0, atol=1e-6)

    jemb = JaxInception(normalize_input=True, output_blocks=(0,), ckpt_path=inception_file)
    ref = np.asarray(jemb(jnp.asarray(x)))
    emb = InceptionV3(normalize_input=True, output_blocks=(0,), ckpt_path=inception_file)
    with torch.no_grad():
        out = emb(xt).numpy().transpose(0, 2, 3, 1)
        pooled = InceptionV3(normalize_input=True, ckpt_path=inception_file)(xt)
        trunk = InceptionV3Trunk()
        trunk.load_state_dict(load_inception_state_dict(inception_file), strict=True)
        (block3,) = trunk(2.0 * resized - 1.0)
    assert out.shape == ref.shape == (1, 73, 73, 64)
    assert _rel(out, ref) <= REL
    assert pooled.shape == (1, 2048) and torch.equal(pooled, block3.flatten(1))

    carried = InceptionV3Trunk()
    load_flax_inception(carried, jax.tree_util.tree_map(np.asarray, jemb.params))
    want_sd = load_inception_state_dict(inception_file)
    for k, v in carried.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
