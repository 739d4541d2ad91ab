"""Training CLI (port of ``cvssl_tpu/train/cli.py``): the same flags, so a
JAX-package invocation runs here unchanged, plus ``--device``:

    python -m cvssl_tpu_torch.train.cli --root_path ../data/ACDC \\
        --exp ACDC/Mean_Teacher --method mean_teacher --model unet \\
        --max_iterations 30000 --batch_size 24 --labeled_bs 12 --labeled_num 7

It trains on one CUDA card; ``--device cpu --dtype float32`` runs on the
CPU. On N cards of a node, one process per card:

    torchrun --nproc_per_node N -m cvssl_tpu_torch.train.cli --distributed \
        --batch_size 24 ...

``--distributed`` joins the process group from torchrun's environment
before the config is built (``parallel/mesh.py::distributed_init``; unlike
JAX's it does not set ``dcn_slices``), and the batch is split over the
ranks. ``--dcn_slices`` raises (TPU mesh folding); the TPU-only flags
(``--rng_impl``, ``--s2d_levels``, ``--compile_cache``, ``--num_workers``)
are accepted and inert, as in the port's ``TrainConfig``.
"""
from __future__ import annotations

import argparse

from cvssl_tpu_torch.train.config import TrainConfig
from cvssl_tpu_torch.train.methods.base import available_methods


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="cvssl_tpu_torch trainer")
    d = TrainConfig()
    p.add_argument("--root_path", type=str, default=d.root_path)
    p.add_argument("--exp", type=str, default=d.exp)
    p.add_argument("--model", type=str, default=d.model)
    p.add_argument("--model2", type=str, default=d.model2)
    p.add_argument("--method", type=str, default=d.method,
                   help=f"one of {available_methods()}")
    p.add_argument("--num_classes", type=int, default=d.num_classes)
    p.add_argument("--in_channels", type=int, default=d.in_channels)
    p.add_argument("--max_iterations", type=int, default=d.max_iterations)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--base_lr", type=float, default=d.base_lr)
    p.add_argument("--patch_size", type=int, nargs="+", default=[256, 256])
    p.add_argument("--patch_size2", type=int, nargs="+", default=None,
                   help="val patch size for the model2 slot (dual runs)")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--deterministic", type=int, default=1,
                   help="0 = draw the run seed from OS entropy")
    p.add_argument("--labeled_bs", type=int, default=d.labeled_bs)
    p.add_argument("--labeled_num", type=int, default=d.labeled_num)
    p.add_argument("--labeled_slices", type=int, default=None,
                   help="bypass the patients->slices table")
    p.add_argument("--total_num", type=int, default=None)
    p.add_argument("--ema_decay", type=float, default=d.ema_decay)
    p.add_argument("--consistency", type=float, default=d.consistency)
    p.add_argument("--consistency_rampup", type=float,
                   default=d.consistency_rampup)
    p.add_argument("--consistency_type", type=str, default=d.consistency_type)
    p.add_argument("--conf_thresh", type=float, default=d.conf_thresh)
    p.add_argument("--snapshot_root", type=str, default=d.snapshot_root)
    p.add_argument("--val_every", type=int, default=d.val_every)
    p.add_argument("--ckpt_every", type=int, default=d.ckpt_every)
    p.add_argument("--num_workers", type=int, default=d.num_workers,
                   help="inert: the host pipeline loads samples one "
                        "after another in one prefetch thread, so its "
                        "generator is drawn in a fixed order")
    p.add_argument("--rng_impl", type=str, default=d.rng_impl,
                   choices=["auto", "threefry", "rbg"],
                   help="inert: JAX PRNG implementation")
    p.add_argument("--dtype", type=str, default=d.dtype,
                   choices=["auto", "float32", "bfloat16"],
                   help="model compute dtype; auto = bf16 on CUDA, f32 on "
                        "the CPU")
    p.add_argument("--s2d_levels", type=int, default=d.s2d_levels,
                   help="inert: TPU space-to-depth levels")
    p.add_argument("--pretrained_ckpt", type=str, default=None,
                   help="local torch .pth with ImageNet weights: Res2Net-101 "
                        "v1b (preunet), EfficientNet-B3 (efficient_unet) or "
                        "Swin-tiny (swin_unet / ViT_Seg)")
    p.add_argument("--dim", type=int, default=2, choices=[2, 3])
    p.add_argument("--num_devices", type=int, default=None,
                   help="the world size (default: the process group's, 1 "
                        "without --distributed)")
    p.add_argument("--distributed", action="store_true",
                   help="join torchrun's process group: one process per "
                        "card, the batch split over them")
    p.add_argument("--dcn_slices", type=int, default=None,
                   help="TPU mesh folding: not ported (raises)")
    p.add_argument("--scan_steps", type=int, default=1)
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--compile_cache", type=str, default=d.compile_cache,
                   help="inert: XLA compilation cache")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def config_from_args(args) -> TrainConfig:
    """The config of ``args``; with ``--distributed`` this process joins
    torchrun's process group first, so that the config sees its size."""
    if args.dcn_slices is not None:
        raise NotImplementedError("--dcn_slices folds a TPU mesh across "
                                  "hosts; the port's mesh is the process "
                                  "group (--distributed)")
    if args.distributed:
        from cvssl_tpu_torch.parallel.mesh import distributed_init
        distributed_init(device=args.device)
    return TrainConfig(
        root_path=args.root_path, exp=args.exp, model=args.model,
        model2=args.model2, method=args.method,
        num_classes=args.num_classes, in_channels=args.in_channels,
        max_iterations=args.max_iterations, batch_size=args.batch_size,
        base_lr=args.base_lr, patch_size=tuple(args.patch_size),
        patch_size2=tuple(args.patch_size2) if args.patch_size2 else None,
        seed=args.seed, deterministic=bool(args.deterministic),
        labeled_bs=args.labeled_bs, labeled_num=args.labeled_num,
        labeled_slices_override=args.labeled_slices,
        total_num=args.total_num, ema_decay=args.ema_decay,
        consistency=args.consistency,
        consistency_rampup=args.consistency_rampup,
        consistency_type=args.consistency_type, conf_thresh=args.conf_thresh,
        snapshot_root=args.snapshot_root, val_every=args.val_every,
        ckpt_every=args.ckpt_every, num_workers=args.num_workers,
        rng_impl=args.rng_impl,
        dtype=args.dtype, s2d_levels=args.s2d_levels, dim=args.dim,
        num_devices=args.num_devices, scan_steps=args.scan_steps,
        profile_dir=args.profile_dir, pretrained_ckpt=args.pretrained_ckpt,
        compile_cache=args.compile_cache)


def main(argv=None, data=None):
    """Parse ``argv`` and train. ``data`` is ``fit``'s: in-memory train
    and val sets instead of ``--root_path``'s files."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    from cvssl_tpu_torch.train.engine import fit
    try:
        result = fit(cfg, device=args.device, data=data)
    finally:
        if args.distributed:
            import torch.distributed as dist
            dist.destroy_process_group()
    print({"iterations": result["iterations"],
           "slices_per_sec": round(result["slices_per_sec"], 2),
           "best_dice": result["best_dice"]})
    return result


if __name__ == "__main__":
    main()
