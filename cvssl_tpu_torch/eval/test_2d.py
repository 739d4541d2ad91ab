"""2D test CLI (port of ``cvssl_tpu/eval/test_2d.py``; parity with the
reference ``code/test_2D_fully.py``): loads ``{model}_best_model.ckpt``
from the snapshot dir (or ``--ckpt``), predicts every volume of
``--list_name`` slice by slice at the patch (order-0 zoom to the patch and
back on the host), reports the per-class Dice (and HD95 and ASD with
``--full_metrics``, which the reference has commented out), and exports
``{case}_pred/img/gt.nii.gz`` (float32, spacing (1, 1, 10),
``utils/nifti.py``) under ``{snapshot}_predictions``.

    python -m cvssl_tpu_torch.eval.test_2d --root_path ../data/ACDC \\
        --exp ACDC/Fully_Supervised --model unet --num_classes 4 \\
        --labeled_num 3

The same flags as JAX's, plus ``--device``: the card unless ``--device
cpu``; without CUDA it raises. The net runs in eval mode in float32.
The slices go through the predictor in chunks (``val2d.predict_slices``);
JAX pads them to shape buckets for its compiler, which changes no label.
With ``--full_metrics`` a class absent from the prediction or the label
scores (dice, 0, 0), where JAX's rows would be ragged.
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
from scipy.ndimage import zoom

from cvssl_tpu_torch.eval.test_3d import (load_net, resolve_device,
                                          snapshot_dir)
from cvssl_tpu_torch.ops import metrics as M
from cvssl_tpu_torch.utils import tracing

PHASES = ("zoom_in", "predict", "zoom_out", "metrics", "export")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, default="../data/ACDC")
    p.add_argument("--exp", type=str, default="ACDC/Fully_Supervised")
    p.add_argument("--model", type=str, default="unet")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--labeled_num", type=int, default=3)
    p.add_argument("--patch_size", type=int, nargs=2, default=[256, 256])
    p.add_argument("--snapshot_root", type=str, default="../model")
    p.add_argument("--list_name", type=str, default="test.list")
    p.add_argument("--full_metrics", action="store_true",
                   help="also compute hd95/asd (reference comments these out)")
    p.add_argument("--ckpt", type=str, default=None,
                   help="explicit checkpoint path (e.g. a dual-model run's "
                        "unet_best_model1.ckpt — replaces test_CNNVIT.py's "
                        "interactive prompt)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def load_predictor(flags, ckpt_path=None):
    """A batched argmax predictor: (B, 1, H, W) float32 -> (B, H, W)
    uint8, on the net's device."""
    import torch

    from cvssl_tpu_torch.models import net_factory
    net = load_net(net_factory, flags, ckpt_path)

    @torch.no_grad()
    def predict(x):
        out = net(x.to(next(net.parameters()).device))
        logits = out[0] if isinstance(out, (tuple, list)) else out
        return logits.argmax(dim=1).to(torch.uint8)
    return predict


def read_volume(root_path: str, case: str):
    """(image, label) of ``{root_path}/data/{case}.h5``."""
    import h5py
    with h5py.File(os.path.join(root_path, "data", f"{case}.h5"), "r") as f:
        return f["image"][:], f["label"][:]


def test_single_volume(image, label, predict, flags, case=None,
                       test_save_path=None, times=None):
    """Score one (S, H, W) volume: per foreground class (dice,), or (dice,
    hd95, asd) with ``flags.full_metrics``; export it when
    ``test_save_path`` is given. ``times``: a dict that gains the seconds
    of each of ``PHASES``, from the host spans ``test_2d.<phase>``
    (``utils/tracing.py``). Returns (rows, prediction)."""
    from cvssl_tpu_torch.eval.val2d import predict_slices
    ph, pw = flags.patch_size
    _, x, y = image.shape
    with tracing.span("test_2d.zoom_in", times):
        zoomed = zoom(image, (1, ph / x, pw / y), order=0)
    with tracing.span("test_2d.predict", times):
        pred_patch = predict_slices(predict, zoomed).cpu().numpy()
    with tracing.span("test_2d.zoom_out", times):
        prediction = zoom(pred_patch, (1, x / ph, y / pw), order=0)
    with tracing.span("test_2d.metrics", times):
        rows = []
        for c in range(1, flags.num_classes):
            p, g = prediction == c, label == c
            if not flags.full_metrics:
                rows.append((M.dc(p, g),))
            elif p.sum() > 0 and g.sum() > 0:
                rows.append((M.dc(p, g), M.hd95(p, g), M.asd(p, g)))
            else:
                rows.append((M.dc(p, g), 0.0, 0.0))
    if test_save_path:
        # the reference's export (test_2D_fully.py:73-81)
        with tracing.span("test_2d.export", times):
            from cvssl_tpu_torch.utils.nifti import save_nifti
            sp = (1.0, 1.0, 10.0)
            for tag, arr in (("pred", prediction), ("img", image),
                             ("gt", label)):
                save_nifti(os.path.join(test_save_path,
                                        f"{case}_{tag}.nii.gz"),
                           np.asarray(arr).astype(np.float32), sp)
    return rows, prediction


def inference(flags, predictor=None, volumes=None, times=None):
    """Score every case of ``{root_path}/{list_name}`` (``volumes``: an
    optional {case: (image, label)} in place of the h5 files), export them,
    print each class's mean and the mean over classes, and return the
    (classes - 1, metrics) average."""
    resolve_device(getattr(flags, "device", "cuda"))
    if volumes is None:
        with open(os.path.join(flags.root_path, flags.list_name)) as f:
            cases = sorted(ln.strip().split(".")[0] for ln in f
                           if ln.strip())
    else:
        cases = sorted(volumes)
    test_save_path = snapshot_dir(flags) + "_predictions"
    if os.path.exists(test_save_path):
        shutil.rmtree(test_save_path)
    os.makedirs(test_save_path)
    predict = predictor or load_predictor(flags,
                                          getattr(flags, "ckpt", None))
    totals = None
    for case in cases:
        image, label = (volumes[case] if volumes is not None
                        else read_volume(flags.root_path, case))
        rows, _ = test_single_volume(image, label, predict, flags, case,
                                     test_save_path, times)
        m = np.asarray(rows, dtype=np.float64)
        totals = m if totals is None else totals + m
    avg = totals / len(cases)
    for c in range(avg.shape[0]):
        print(f"class {c + 1}: {avg[c]}")
    print("mean:", avg.mean(axis=0))
    return avg


if __name__ == "__main__":
    inference(build_parser().parse_args())
