"""Multi-GPU serving on the CPU: `OrbitServer`, `RefineServer`,
`TwoStageServer` and the serve CLI over gloo groups of 2, 3 and 4
processes, against one process and against JAX.

One spawn a world size (`serve_run`): the ranks of each group run the jobs of
tests/torch_dist_scenarios.py (which imports no JAX) on the tiny stage-1
engine of tests/test_torch_slice.py and the tiny stage-2 engine of
tests/test_torch_stage2.py (their port halves, loaded from the fixtures'
weights), and save their results; the test process meanwhile runs the same
jobs in one process and JAX's unsharded `generate_orbit` and
`blend_refine_batch` on the pinned jobs. Every collective has a 150 s
timeout (`torch_dist_scenarios.SERVE_TIMEOUT`: 9 rank processes share the
CPU with the other test workers) and the spawns are joined within
SPAWN_LIMIT_S.

Both sides run one intra-op thread: a different thread count alone moves
a stage-2 refinement by up to 4e-4 here.

Bounds (fp32). Where the ranks and one process do the same arithmetic,
EXACT_ATOL (they agree bit for bit): a throughput rank (B % W == 0, whole
assets a rank) against one process computing that rank's assets with that
rank's rows of the noise, and a two-stage stream against its stages run
one after the other on the same ranks. Where the batch shapes differ, the
CPU kernels round differently: oneDNN's convolutions are not
batch-invariant (the tiny UNet's first 1×1 convolution puts a video 2.4e-7
apart in a batch of 4 and of 2 videos), the latency mode's GroupNorms
combine the ranks' moments (Chan's formula) where one process takes
one-pass sums, and the σ = 700 first step and the VAE decode amplify that
to ~1e-4 of the frames. The stage-1 server is then held to one process's
output of the whole batch within LATENCY_ATOL, throughput (measured 1.0e-4)
and latency (frames split, blocks that straddle assets, location blocks
that do not divide evenly at W = 3; up to 1.4e-4) alike. The tiny stage-2
engine amplifies far more (a 1e-4 change of its input videos moves its
output by 1e-2: the random DPT's depth is min-max normalised), so its
cross-shape comparisons are held within STAGE2_ATOL (measured up to
2.5e-4). Against JAX's unsharded functions with the same initial and
conditioning noise, JAX_ATOL, the one-process bound of
tests/test_torch_serve.py.
"""

import contextlib
import multiprocessing
import os
import socket
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
import yaml

import torch_dist_scenarios as scen
from test_torch_slice import models as stage1_models  # noqa: F401  (module fixture)
from test_torch_slice import tiny_config
from test_torch_stage2 import models as stage2_models  # noqa: F401  (module fixture)
from test_torch_stage2 import tiny_stage2_config

T, RES1, RES2, STEPS = 4, 32, 64, 2
EXACT_ATOL = 1e-5
LATENCY_ATOL = 2e-4
STAGE2_ATOL = 5e-4
JAX_ATOL = 2e-3
SPAWN_LIMIT_S = 240
EMBEDDER = "torch_dist_scenarios.TinyImageEmbedder"
# a guidance interval that leaves the first of the 2 steps (σ = 700) unguided
INTERVAL = (0.0, 1.0)


def _free_ports(n: int):
    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(n)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]


def _orbit_job(seed, b, t=T, pinned=False, **kw):
    rnd = np.random.RandomState(seed)
    job = {"kind": "orbit", "t": t, "seed": seed, "elev": list(rnd.uniform(-20, 20, b)),
           "images": rnd.rand(b, RES1, RES1, 3).astype(np.float32) * 2 - 1, **kw}
    if pinned:
        job.update(noise=rnd.randn(b * t, RES1 // 8, RES1 // 8, 4).astype(np.float32),
                   cond_frames=(job["images"] + 0.02 * rnd.randn(b, RES1, RES1, 3)).astype(
                       np.float32), cond_aug=np.full((b,), 0.02, np.float32))
    return job


def _refine_job(seed, b, t=T, pinned=False, **kw):
    rnd = np.random.RandomState(seed)
    videos = rnd.rand(b, t, RES2, RES2, 3).astype(np.float32) * 2 - 1
    job = {"kind": "refine", "seed": seed, "elev": list(rnd.uniform(-20, 20, b)),
           "videos": videos, **kw}
    if pinned:
        job.update(noise=rnd.randn(b * t, RES2 // 8, RES2 // 8, 4).astype(np.float32),
                   cond_frames=(videos.reshape(b * t, RES2, RES2, 3)
                                + 0.02 * rnd.randn(b * t, RES2, RES2, 3)).astype(np.float32),
                   cond_aug=np.full((b,), 0.02, np.float32))
    return job


def _stream_job(seed, batches, **kw):
    rnd = np.random.RandomState(seed)
    return {"kind": "stream", "t": T, "seed": seed, "elev": 5.0, "stage2_hw": (RES2, RES2),
            "batches": [rnd.rand(1, RES1, RES1, 3).astype(np.float32) * 2 - 1
                        for _ in range(batches)], **kw}


JOBS = {
    2: {"throughput": _orbit_job(1, 2),
        "latency": _orbit_job(2, 1, pinned=True),
        "ancestral": {**_orbit_job(4, 1), "kind": "orbit_ancestral"},
        "reuse": _orbit_job(5, 1, encoder_reuse=2, steps=3),
        "interval": _orbit_job(6, 1, cfg_interval=INTERVAL),
        "refine": _refine_job(7, 1, pinned=True),
        "refine_reuse": _refine_job(9, 1, encoder_reuse=2, steps=3),
        "refine_interval": _refine_job(10, 1, cfg_interval=INTERVAL),
        "refine_throughput": _refine_job(11, 2),
        "stream": _stream_job(12, 2)},
    3: {"uneven": _orbit_job(13, 1, t=6)},
    4: {"latency": _orbit_job(14, 1),
        "straddle": _orbit_job(15, 3),
        "stream": _stream_job(16, 2)},
}


def _write_pngs(root, n, seed):
    from hi3d_tpu_torch.utils.png import write_png

    os.makedirs(root, exist_ok=True)
    rnd = np.random.RandomState(seed)
    for name in "bac"[:n]:
        write_png(os.path.join(root, f"{name}.png"), rnd.randint(0, 256, (40, 48, 3), np.uint8))
    return root


def _cli_argvs(work, cfg1, cfg2):
    images = _write_pngs(os.path.join(work, "pngs"), 3, 17)
    common = ["--image_dir", images, "--stage1_config", cfg1, "--clip_size", str(T),
              "--resolution", str(RES1), str(RES1), "--seed", "3"]
    return {
        "orbit_throughput": common + ["--output_dir", os.path.join(work, "cli_tp"),
                                      "--batch", "2"],
        "orbit_latency": common + ["--output_dir", os.path.join(work, "cli_lat"), "--batch", "1"],
        "two_stage": common + ["--output_dir", os.path.join(work, "cli_two"), "--batch", "2",
                               "--mode", "two_stage", "--stage2_config", cfg2,
                               "--stage2_resolution", str(RES2), str(RES2)],
    }


def _read_frames(out_dir, name):
    from hi3d_tpu_torch.utils.png import read_png

    frame_dir = os.path.join(out_dir, name, "frames")
    return np.stack([read_png(os.path.join(frame_dir, f)) for f in sorted(os.listdir(frame_dir))])


@pytest.fixture(scope="module")
def serve_dist(tmp_path_factory, stage1_models, stage2_models):  # noqa: F811
    from hi3d_tpu.pipelines.i2v import generate_orbit as jax_generate_orbit
    from hi3d_tpu.pipelines.v2v import blend_refine_batch as jax_blend
    from hi3d_tpu_torch.pipelines import serve

    work = str(tmp_path_factory.mktemp("serve_dist"))
    jm1, tm1 = stage1_models
    jm2, tm2 = stage2_models
    cfg1 = tiny_config(EMBEDDER, num_steps=STEPS)
    cfg2 = tiny_stage2_config(EMBEDDER, num_steps=STEPS)
    inp = {"cfg1": cfg1, "cfg2": cfg2, "state1": os.path.join(work, "stage1.pt"),
           "state2": os.path.join(work, "stage2.pt"), "jobs": JOBS,
           "ancestral": {**cfg1["params"]["sampler_config"],
                         "target": "sgm.modules.diffusionmodules.sampling.EulerAncestralSampler"}}
    torch.save(tm1.state_dict(), inp["state1"])
    torch.save(tm2.state_dict(), inp["state2"])
    yamls = []
    for name, cfg in (("tiny1.yaml", cfg1), ("tiny2.yaml", cfg2)):
        yamls.append(os.path.join(work, name))
        with open(yamls[-1], "w") as f:
            yaml.safe_dump({"model": cfg}, f)
    argvs = _cli_argvs(work, *yamls)
    inp["cli"] = {2: argvs}

    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    procs = {}
    for world in JOBS:
        ports = _free_ports(1 + len(inp["cli"].get(world, {})))
        procs[world] = [ctx.Process(target=scen.serve_run, args=(r, world, ports, work, inp))
                        for r in range(world)]
    for group in procs.values():
        for p in group:
            p.start()
    try:
        # meanwhile: every job in one process, JAX's unsharded references,
        # and the CLI runs in one process
        tj = time.perf_counter()
        m1, m2 = scen.serve_engines(inp)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # the ranks' arithmetic (the module docstring)
        try:
            one = {world: scen.serve_jobs(inp, jobs, m1, m2) for world, jobs in JOBS.items()}
            throughput = {name: JOBS[2][name] for name in ("throughput", "refine_throughput")}
            split = [scen.serve_jobs(inp, throughput, m1, m2, split=(2, r)) for r in range(2)]
            one["split"] = {name: np.concatenate([s[name] for s in split]) for name in throughput}
        finally:
            torch.set_num_threads(threads)
        job = JOBS[2]["latency"]
        jm1.num_samples = T
        jax_orbit = jax_generate_orbit(
            jm1, np.repeat(job["images"], T, axis=0), elevation=job["elev"][0],
            rng=jax.random.PRNGKey(0), num_steps=STEPS, randn=jnp.asarray(job["noise"]),
            batch_overrides={"cond_frames": jnp.asarray(job["cond_frames"]),
                             "cond_aug": jnp.asarray(job["cond_aug"])})
        job = JOBS[2]["refine"]
        jm2.num_samples = T
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("HI3D_PROGRAM_CACHE", "0")
            jax_refine = jax_blend(
                jm2, job["videos"], elevations=job["elev"], rng=jax.random.PRNGKey(0),
                num_steps=STEPS, init_noise=jnp.asarray(job["noise"]),
                batch_overrides={"cond_frames": jnp.asarray(job["cond_frames"]),
                                 "cond_aug": jnp.asarray(job["cond_aug"])},
                steps_per_launch=None)
        cli_one = {}
        for name in ("orbit_throughput", "orbit_latency"):
            argv = list(argvs[name])
            cli_one[name] = argv[argv.index("--output_dir") + 1] = os.path.join(work, "one_" + name)
            serve.main(argv + ["--device", "cpu"])
        tj = time.perf_counter() - tj
    finally:
        deadline = time.monotonic() + SPAWN_LIMIT_S
        every = [p for group in procs.values() for p in group]
        for p in every:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in every if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    if hung or any(p.exitcode for p in every):
        pytest.fail(f"ranks exited {[p.exitcode for p in every]} "
                    f"({len(hung)} killed after {SPAWN_LIMIT_S} s)")
    ranks = {world: [torch.load(os.path.join(work, f"serve{world}_{r}.pt"), weights_only=False)
                     for r in range(world)] for world in JOBS}
    print(f"[serve_dist] groups of {list(JOBS)} ran in {time.perf_counter() - t0:.1f} s "
          f"(one process and JAX meanwhile {tj:.1f} s)")
    return {"ranks": ranks, "one": one, "jax_orbit": jax_orbit, "jax_refine": jax_refine,
            "cli": argvs, "cli_one": cli_one, "work": work}


def _writer(run, world, name):
    """The job's result on the writer (rank 0), after checking that every
    other rank returned None."""
    results = [r["jobs"][name] for r in run["ranks"][world]]
    if name.startswith("stream"):  # a list a batch
        writer = 1 if world == 2 else 2  # stage 2's first rank
        assert all(v is None for i, r in enumerate(results) if i != writer for v in r)
        return np.stack(results[writer])
    assert all(v is None for v in results[1:])
    return results[0]


def _one(run, world, name):
    result = run["one"][world][name]
    return np.stack(result) if name.startswith("stream") else result


def _check(got, want, atol):
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    assert np.abs(want).max() > 0.05  # not two blank videos
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("name,atol", [("throughput", LATENCY_ATOL),
                                       ("refine_throughput", STAGE2_ATOL)])
def test_throughput_equals_one_process(serve_dist, name, atol):
    """B = 2 at W = 2: each rank takes one whole asset and its rows of the
    one-process noise, and nothing crosses ranks inside the UNet: the
    gathered videos equal, bit for bit, one process computing each rank's
    asset alone with those rows, and the one-process batch of both assets
    within the cross-shape bound."""
    got = _writer(serve_dist, 2, name)
    _check(got, serve_dist["one"]["split"][name], EXACT_ATOL)
    _check(got, _one(serve_dist, 2, name), atol)


@pytest.mark.parametrize("world,name,atol", [
    (2, "latency", LATENCY_ATOL), (4, "latency", LATENCY_ATOL), (4, "straddle", LATENCY_ATOL),
    (3, "uneven", LATENCY_ATOL), (2, "ancestral", LATENCY_ATOL), (2, "refine", STAGE2_ATOL)])
def test_latency_equals_one_process(serve_dist, world, name, atol):
    """Frames split over the ranks: B = 1 at W = 2 and 4 (4 and 1 frames a
    rank); B = 3 at W = 4 (3 frames a rank, blocks that straddle assets);
    T = 6 at W = 3 (location blocks 5/5/6 and 1/1/2 of the tiny UNet's 4×4
    and 2×2 latents); Euler ancestral (every step's noise is the one
    process's draw, cut to the rank's rows); the stage-2 refinement."""
    _check(_writer(serve_dist, world, name), _one(serve_dist, world, name), atol)


@pytest.mark.parametrize("name,atol", [("reuse", LATENCY_ATOL), ("interval", LATENCY_ATOL),
                                       ("refine_reuse", STAGE2_ATOL),
                                       ("refine_interval", STAGE2_ATOL)])
def test_turbo_flags_sharded(serve_dist, name, atol):
    """encoder_reuse 2 (3 steps: the middle one decodes from the cache) and a
    cfg_interval that leaves a step unguided, in latency mode at W = 2,
    against one process with the same flag."""
    _check(_writer(serve_dist, 2, name), _one(serve_dist, 2, name), atol)


def test_orbit_server_matches_jax(serve_dist):
    """The W = 2 latency orbit against JAX's unsharded `generate_orbit` with
    the same initial noise and conditioning noise."""
    out = _writer(serve_dist, 2, "latency")
    _check(out[0], np.asarray(serve_dist["jax_orbit"]), JAX_ATOL)


def test_refine_server_matches_jax(serve_dist):
    """The W = 2 latency refinement against JAX's unsharded
    `blend_refine_batch` with the same initial noise and cond frames."""
    _check(_writer(serve_dist, 2, "refine"), np.asarray(serve_dist["jax_refine"]), JAX_ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_two_stage_stream_equals_its_stages(serve_dist, world):
    """generate_stream over 2 batches, stage 2 of batch 0 beside stage 1 of
    batch 1, at W = 2 (one rank a stage) and W = 4 (two ranks a stage,
    latency within each): bit for bit what the same ranks give running
    each batch's two stages in turn with the batch's generators (the
    stream changes when work runs, not what it computes; each stage
    against one process: the tests above); at W = 2, the one-process
    stream's videos within STAGE2_ATOL. At W = 4 stage 1's latency-mode
    rounding (~1e-4) reaches stage 2's input, which the tiny stage-2
    engine amplifies a hundredfold, so its end-to-end comparison is the
    two stages'."""
    got = _writer(serve_dist, world, "stream")
    assert got.shape == (2, 1, T, RES2, RES2, 3)
    _check(got, _writer(serve_dist, world, "stream_parts"), EXACT_ATOL)
    if world == 2:
        _check(got, _one(serve_dist, 2, "stream"), STAGE2_ATOL)


@pytest.mark.parametrize("world", [2, 3])
def test_regroup_round_trip_and_split_group_norm(serve_dist, world):
    """Frame-split → location-split → frame-split is the identity, the
    location-split layout is the batch's block (uneven at 7 locations over 2
    and 16 over 3), and the GroupNorm whose statistics combine the ranks'
    moments equals the whole tensor's."""
    for r in serve_dist["ranks"][world]:
        assert r["regroup"]["roundtrip"] == 0.0
        assert r["regroup"]["locations"] == 0.0
        assert r["regroup"]["group_norm"] < 1e-5


@pytest.mark.parametrize("name", ["orbit_throughput", "orbit_latency", "two_stage"])
def test_cli_under_torchrun(serve_dist, name):
    """serve.main under torchrun's variables (gloo, --device cpu) at W = 2:
    3 PNGs, each asset written once by one rank, the padding dropped; the
    orbit modes' frames equal the one-process CLI's (uint8, within one
    level where fp32 rounding lands on a boundary)."""
    runs = [r["cli"][name] for r in serve_dist["ranks"][2]]
    written = [p for run in runs for p in run["outputs"]]
    assert len(written) == len(set(written)) == 3
    assert all(run["group_left"] for run in runs)
    writer = 1 if name == "two_stage" else 0
    assert not any(run["outputs"] for i, run in enumerate(runs) if i != writer)
    argv = serve_dist["cli"][name]
    out_dir = argv[argv.index("--output_dir") + 1]
    assert sorted(os.listdir(out_dir)) == ["a", "b", "c"]
    res = RES2 if name == "two_stage" else RES1
    for asset in ("a", "b", "c"):
        frames = _read_frames(out_dir, asset)
        assert frames.shape == (8, res, res, 3)  # padded to 1 s at --fps 8
        if name in serve_dist["cli_one"]:
            one = _read_frames(serve_dist["cli_one"][name], asset)
            assert np.abs(frames.astype(int) - one).max() <= 1


def test_cli_refuses_indivisible_batch_before_loading(tmp_path, monkeypatch):
    """--batch 1 --clip_size 3 at W = 2: SystemExit before any group or
    model exists, as JAX's CLI refuses a batch the mesh does not divide."""
    from hi3d_tpu_torch.pipelines import common, serve

    _write_pngs(str(tmp_path / "pngs"), 1, 3)
    monkeypatch.setenv("WORLD_SIZE", "2")

    def no_model(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(common, "load_inference_model", no_model)
    monkeypatch.setattr(serve.dist, "init", no_model)
    with pytest.raises(SystemExit, match="--batch 1 × --clip_size 3 must divide the 2 ranks"):
        serve.main(["--image_dir", str(tmp_path / "pngs"), "--output_dir", str(tmp_path / "o"),
                    "--batch", "1", "--clip_size", "3", "--device", "cpu"])


def test_server_mode_split_and_refusal(monkeypatch):
    """The mode a batch takes over W ranks (JAX's split): whole assets where
    B % W == 0, blocks of frames where only B·T divides, else a ValueError
    naming B, T and W; a forced mode must divide too."""
    from hi3d_tpu_torch.pipelines import serve

    monkeypatch.setattr(serve.dist, "world", lambda group=None: 4)
    monkeypatch.setattr(serve.dist, "rank", lambda group=None: 1)
    server = serve.OrbitServer(None, group=object())
    tp = server.frames(8, 16)
    assert (tp.group, tp.offset, tp.count) == (None, 32, 32)
    lat = server.frames(1, 16)
    assert (lat.group is server.group, lat.offset, lat.count) == (True, 4, 4)
    with pytest.raises(ValueError, match="1·3 not divisible by the 4 ranks"):
        server.frames(1, 3)
    with pytest.raises(ValueError, match="do not split"):
        serve.OrbitServer(None, group=object(), mode="throughput").frames(2, 16)


def test_stage_ranks_follow_jax_split():
    """TwoStageServer's default split: power-of-two halves (JAX's
    hi3d_tpu/pipelines/serve.py:219-242), both stages on the one rank at
    W = 1, one side given and the other the rest; overlapping sides past
    W = 1 raise."""
    from hi3d_tpu_torch.pipelines.serve import stage_ranks

    assert stage_ranks(1) == ([0], [0])
    assert stage_ranks(2) == ([0], [1])
    assert stage_ranks(3) == ([0], [1])
    assert stage_ranks(4) == ([0, 1], [2, 3])
    assert stage_ranks(6) == ([0, 1], [2, 3])
    assert stage_ranks(8) == ([0, 1, 2, 3], [4, 5, 6, 7])
    assert stage_ranks(4, stage2_ranks=[1, 2, 3]) == ([0], [1, 2, 3])
    with pytest.raises(ValueError, match="disjoint"):
        stage_ranks(2, [0, 1], [1])


def test_frame_shard_rows_and_draws():
    """A FrameShard without a group: its rows of copies, their frames and
    videos, its cut of one process's draw, and its part of a conditioning
    dict (per-frame rows cut, per-video rows cut to its whole videos)."""
    from hi3d_tpu_torch.parallel.dist import FrameShard

    shard = FrameShard(frames=4, total=12, offset=3, count=3)
    assert shard.rows(2).tolist() == [3, 4, 5, 15, 16, 17]
    assert shard.frame_index(2).tolist() == [3, 0, 1, 3, 0, 1]
    assert shard.video_index(1).tolist() == [0, 1, 1]
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    assert torch.equal(shard.randn((12, 2), g1), torch.randn((12, 2), generator=g2)[3:6])
    whole = FrameShard(frames=4, total=12, offset=4, count=4)
    cond = whole.take_cond({"concat": torch.arange(12), "vector": torch.arange(3), "k": 1.0})
    assert cond["concat"].tolist() == [4, 5, 6, 7] and cond["vector"].tolist() == [1]
    with pytest.raises(ValueError, match="neither"):
        whole.take_cond({"crossattn": torch.arange(5)})

