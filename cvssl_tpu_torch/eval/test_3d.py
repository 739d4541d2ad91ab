"""3D test CLI (port of ``cvssl_tpu/eval/test_3d.py``; parity with the
reference ``code/test_3D.py`` and ``test_3D_util.py``): the sliding window
(patch 96^3, stride 64) over the held-out volumes, per-case (dice, ravd,
hd95, asd) rows and their mean in ``metrics.txt``, and each case's
prediction, image and label as ``.nii.gz`` under
``{snapshot}_predictions``.

    python -m cvssl_tpu_torch.eval.test_3d --root_path ../data/BraTS2019 \\
        --exp BraTS2019/Mean_Teacher --model unet_3D --labeled_num 25

The same flags as JAX's, plus ``--device``: the card unless ``--device
cpu``; without CUDA it raises. The net runs in eval mode in float32, as
JAX's test CLI builds it without a dtype.
"""
from __future__ import annotations

import argparse
import os

import torch


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, default="../data/BraTS2019")
    p.add_argument("--exp", type=str, default="BraTS2019/Fully_Supervised")
    p.add_argument("--model", type=str, default="unet_3D")
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--labeled_num", type=int, default=25)
    p.add_argument("--patch_size", type=int, nargs=3, default=[96, 96, 96])
    p.add_argument("--stride_xy", type=int, default=64)
    p.add_argument("--stride_z", type=int, default=64)
    p.add_argument("--snapshot_root", type=str, default="../model")
    # the reference's test_3D.py:33 reads test.txt; --split val serves a
    # tree without a test list
    p.add_argument("--split", type=str, default="test",
                   choices=["test", "val"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def snapshot_dir(flags) -> str:
    """``{snapshot_root}/{exp}_{labeled_num}_labeled/{model}``."""
    return os.path.join(flags.snapshot_root,
                        f"{flags.exp}_{flags.labeled_num}_labeled",
                        flags.model)


def resolve_device(name: str) -> torch.device:
    """``name`` as a device; "cuda" on a machine without CUDA raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the "
                           "CPU")
    return device


def load_net(factory, flags, ckpt_path=None):
    """``flags.model`` from ``factory`` with the weights of ``ckpt_path``
    (default ``{snapshot}/{model}_best_model.ckpt``), in eval mode, float32,
    on ``flags.device``. The net is built with the constructor arguments
    ``fit`` gives it at ``flags.patch_size`` (``TrainConfig.model_kwargs``:
    the ViTs are built for the patch). ``test_2d`` loads its nets here
    too."""
    from cvssl_tpu_torch.train.config import TrainConfig
    from cvssl_tpu_torch.utils import checkpoint as ckpt
    device = resolve_device(getattr(flags, "device", "cuda"))
    cfg = TrainConfig(model=flags.model, dim=len(flags.patch_size),
                      num_classes=flags.num_classes,
                      patch_size=tuple(flags.patch_size))
    net = factory(flags.model, cfg.in_channels, flags.num_classes,
                  **cfg.model_kwargs(flags.model))
    if ckpt_path is None:
        ckpt_path = os.path.join(snapshot_dir(flags),
                                 f"{flags.model}_best_model.ckpt")
    net.load_state_dict(ckpt.load_weights(ckpt_path))
    print(f"init weight from {ckpt_path}")
    return net.to(device).eval()


def load_predictor(flags, ckpt_path=None):
    """The float32 softmax over the classes (axis 1) of a (B, 1, D, H, W)
    float32 batch, from the net's main logits."""
    from cvssl_tpu_torch.models import net_factory_3d
    net = load_net(net_factory_3d, flags, ckpt_path)

    @torch.no_grad()
    def predict(x):
        out = net(x)
        logits = out[0] if isinstance(out, (tuple, list)) else out
        return torch.softmax(logits.float(), dim=1)
    return predict


def inference(flags, predictor=None, dataset=None, times=None):
    """Run the held-out split (``dataset``: default ``VolumeDataset(
    root_path, split)``; any sequence of samples with ``image``, ``label``
    and ``case``) and write ``metrics.txt`` and the exports; returns the
    per-class mean (classes - 1, 4). ``times``: see
    ``val3d.test_all_case_full_metrics``."""
    from cvssl_tpu_torch.eval.val3d import test_all_case_full_metrics
    device = resolve_device(getattr(flags, "device", "cuda"))
    if dataset is None:
        from cvssl_tpu_torch.data.datasets import VolumeDataset
        dataset = VolumeDataset(flags.root_path,
                                getattr(flags, "split", "test"))
    predict = predictor or load_predictor(flags)
    out_dir = snapshot_dir(flags) + "_predictions"
    rows, mean = test_all_case_full_metrics(
        predict, dataset, flags.num_classes, tuple(flags.patch_size),
        flags.stride_xy, flags.stride_z, export_dir=out_dir, device=device,
        times=times)
    # the reference's per-case rows (test_3D_util.py:98-109)
    with open(os.path.join(out_dir, "metrics.txt"), "w") as f:
        for i, row in enumerate(rows):
            f.write(f"{i},{','.join(str(v) for v in row.ravel())}\n")
        f.write(f"mean,{','.join(str(v) for v in mean.ravel())}\n")
    print("per-class (dice, ravd, hd95, asd) mean:\n", mean)
    return mean


if __name__ == "__main__":
    inference(build_parser().parse_args())
