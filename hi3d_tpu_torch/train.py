"""Stage-1 and stage-2 training on one GPU or N (counterpart of train.py, same flags).

    python -m hi3d_tpu_torch.train --base configs/train-v01.yaml \
        [--device cuda] [--max_steps N] [--resume logs/<run>] [--no_test True] \
        [--logger tensorboard|testtube|wandb|jsonl] [--outckpt out.safetensors] \
        [key.sub=value ...]
    python -m hi3d_tpu_torch.train --base configs/train-v02.yaml ...
    torchrun --nproc_per_node N -m hi3d_tpu_torch.train --base configs/train-v01.yaml ...

Under torchrun each process joins the group (`parallel.dist`: NCCL, device
`cuda:LOCAL_RANK`; gloo with `--device cpu`) and trains data parallel with a
ZeRO-2-sharded AdamW: `data.params.batch_size` videos per GPU, the LR scaled
by world × accumulation × batch, the loader seeded `seed + rank`. Every rank
builds the model from the same seed and loads the checkpoint, then takes rank
0's weights. Rank 0 alone writes the config snapshot, metrics, media and
checkpoints, runs the test pass and writes `--outckpt`; a checkpoint holds
the one-process layout, so `--resume` works at any world size.

The config picks the stage: train-v01.yaml fine-tunes the image-to-orbit
model on 16×512² clips, train-v02.yaml the 1024² video-to-video refiner,
whose conditioning video is degraded on the device each step
(VideoLDMStage2.add_custom_cond, data/degradation.py).

Builds the config's model directly on `--device` (fp32 master weights; the
UNet computes in the config's compute_dtype), loads `model.params.ckpt_path`
when the file exists and otherwise trains from the seeded random
initialisation with a printed notice, builds the `data:` module with a
per-device batch, and runs the Trainer. Checkpoints, metrics.jsonl (every
10th step; TensorBoard events under tb/ or a wandb run when `--logger`, else
`lightning.logger`, else tensorboard, names a backend whose package
imports), the image logger's media (`image_log/`, every
`lightning.callbacks.image_logger.params.batch_frequency` steps) and a config
snapshot go under `<logdir>/<time>_<name>`.

After training, unless `--no_test True`: the JAX CLI's test pass, the image
logger on the first item of the eval set (`data.params.eval_folder`) into
`<logdir>/test/`. That item is one eval image, not a video batch, so
`log_images` raises KeyError('video') and the logger prints it and writes
nothing, in the JAX package as here. `--outckpt` then writes the trained UNet
and the VAE in the reference layout (`model.diffusion_model.`,
`first_stage_model.`, fp32 .safetensors).
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
from typing import List, Optional

import numpy as np
import torch


def str2bool(v: str) -> bool:
    return str(v).lower() in ("yes", "true", "t", "1")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Hi3D stage-1 / stage-2 trainer (PyTorch port)")
    p.add_argument("-b", "--base", nargs="*", default=["configs/train-v01.yaml"],
                   help="config yaml(s), merged left-to-right")
    p.add_argument("-t", "--train", type=str2bool, default=True)
    p.add_argument("--no-test", "--no_test", dest="no_test", type=str2bool, default=False,
                   help="skip the post-train eval-set media dump")
    p.add_argument("-r", "--resume", type=str, default="",
                   help="logdir or checkpoint dir to resume from")
    p.add_argument("-l", "--logdir", type=str, default="logs")
    p.add_argument("-n", "--name", type=str, default="")
    p.add_argument("-f", "--postfix", type=str, default="", help="post-postfix for the run name")
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("-d", "--debug", type=str2bool, default=False,
                   help="post-mortem debugger on exception")
    p.add_argument("--scale_lr", type=str2bool, default=True)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("-p", "--project", "--projectname", dest="projectname", type=str,
                   default="hi3d_tpu")
    p.add_argument("--logger", type=str, default="",
                   choices=["", "tensorboard", "testtube", "wandb", "jsonl"],
                   help="metrics backend (default: config `lightning.logger` or tensorboard; "
                        "jsonl = no event files)")
    p.add_argument("-o", "--outckpt", type=str, default="",
                   help="export the final weights as a reference-layout safetensors")
    p.add_argument("--device", default="cuda")
    return p.parse_known_args(argv)


def resolve_data_batch(data_cfg: dict, local_device_count: int):
    """data.params.batch_size is per device (reference DDP semantics): the
    loader yields batch_size × local devices. Returns (cfg, per_device_bs)."""
    per_device_bs = int(data_cfg.get("params", {}).get("batch_size", 1))
    data_cfg = dict(data_cfg)
    data_cfg["params"] = dict(data_cfg.get("params", {}))
    data_cfg["params"]["batch_size"] = per_device_bs * local_device_count
    return data_cfg, per_device_bs


def main(argv: Optional[List[str]] = None):
    """Run the CLI; returns the Trainer. Under torchrun it joins the process
    group first and leaves it at the end."""
    from .parallel import dist as pdist

    args, unknown = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"[train] --device {args.device} requested but CUDA is not available")
    device, own_group = pdist.init(args.device)
    trainer = _run(args, unknown, device)
    # Left only on success: after an exception another rank may still wait in
    # a collective, so the process exits with the exception and torchrun
    # stops the others.
    if own_group:
        torch.distributed.destroy_process_group()
    return trainer


def _run(args, unknown, device: torch.device):
    from .config import apply_dotlist, instantiate_from_config, load_config
    from .parallel import dist as pdist
    from .pipelines.common import configure_precision
    from .training.trainer import Trainer

    if args.debug:
        def _post_mortem(tp, value, tb):
            import pdb
            import traceback

            traceback.print_exception(tp, value, tb)
            pdb.post_mortem(tb)

        sys.excepthook = _post_mortem

    cfg = load_config(args.base)
    overrides = [u for u in unknown if "=" in u]
    if overrides:
        cfg = apply_dotlist(cfg, overrides)

    if args.resume:
        logdir = args.resume.rstrip("/")
        if logdir.endswith("checkpoints"):
            logdir = os.path.dirname(logdir)
    else:
        now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
        name = args.name or os.path.splitext(os.path.basename(args.base[0]))[0]
        logdir = pdist.broadcast_object(os.path.join(args.logdir, f"{now}_{name}{args.postfix}"))
    main_rank = pdist.is_main()
    if main_rank:
        import yaml

        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, "config.yaml"), "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)

    np.random.seed(args.seed + pdist.rank())
    configure_precision()
    model_cfg = {"target": cfg["model"]["target"], "params": dict(cfg["model"].get("params", {}))}
    ckpt_path = model_cfg["params"].pop("ckpt_path", None)
    model_cfg["params"].setdefault("base_learning_rate", cfg["model"].get("base_learning_rate"))
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []), device:
        torch.manual_seed(args.seed)
        model = instantiate_from_config(model_cfg)
    if ckpt_path and os.path.exists(ckpt_path):
        model.init_from_ckpt(ckpt_path)
    else:
        print(f"[train] checkpoint {ckpt_path!r} not found — random weights (smoke mode)")
    pdist.broadcast_module(model)  # the ranks cannot start apart

    data_cfg = cfg.get("data")
    if data_cfg is None:
        raise ValueError("config needs a `data:` section")
    data_cfg, per_device_bs = resolve_data_batch(data_cfg, 1)
    data = instantiate_from_config(data_cfg)
    data.setup()

    lightning_cfg = cfg.get("lightning", {})
    trainer_cfg = lightning_cfg.get("trainer", {})
    ckpt_cfg = lightning_cfg.get("modelcheckpoint", {}).get("params", {})
    img_cb = lightning_cfg.get("callbacks", {}).get("image_logger", {}).get("params", {})
    trainer = Trainer(
        model, logdir=logdir, scale_lr=args.scale_lr,
        accumulate_grad_batches=trainer_cfg.get("accumulate_grad_batches", 1),
        batch_size=per_device_bs,
        ckpt_every_n_steps=ckpt_cfg.get("every_n_train_steps", 3000),
        log_images_every=img_cb.get("batch_frequency", 200),
        max_to_keep=ckpt_cfg.get("save_top_k", 10),
        monitor=ckpt_cfg.get("monitor"), monitor_mode=ckpt_cfg.get("mode", "min"),
        seed=args.seed,
        logger_backend=args.logger or lightning_cfg.get("logger", "tensorboard"),
    )
    max_steps = args.max_steps or trainer_cfg.get("max_steps", 100000)
    if args.train:
        trainer.fit(data.train_dataloader(), max_steps=max_steps, resume=bool(args.resume))
    pdist.barrier()
    if not main_rank:
        return trainer

    if not args.no_test:
        from .training.trainer import ImageLogger

        try:
            val = data.val_dataloader()
            batch = next(iter(val)) if val is not None else None
        except Exception as e:
            print(f"[train] no eval set for the test pass ({e})")
            batch = None
        if batch is not None:
            ImageLogger(os.path.join(logdir, "test"), every_n_steps=1).maybe_log(model, batch,
                                                                                step=0)
    if args.outckpt:
        from .convert import export_engine_state_dict, save_safetensors

        save_safetensors(export_engine_state_dict(model), args.outckpt)
        print(f"[train] exported {args.outckpt}")
    return trainer


if __name__ == "__main__":
    main()
