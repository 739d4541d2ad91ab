"""Metrics logging (port of ``cvssl_tpu/utils/logging.py``): JSONL always;
TensorBoard when tensorboardX or torch's tensorboard writer imports (the
reference logs to tensorboardX, ``train_fully_supervised_2D.py:96,124-141``).
"""
from __future__ import annotations

import json
import logging
import os
import time


def setup_logging(snapshot_path: str) -> logging.Logger:
    """Reference contract: log to {snapshot}/log.txt + stdout
    (``train_fully_supervised_2D.py:214-217``)."""
    os.makedirs(snapshot_path, exist_ok=True)
    logger = logging.getLogger("cvssl_tpu_torch")
    logger.setLevel(logging.INFO)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fmt = logging.Formatter("[%(asctime)s.%(msecs)03d] %(message)s",
                            datefmt="%H:%M:%S")
    fh = logging.FileHandler(os.path.join(snapshot_path, "log.txt"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter  # type: ignore
            self._tb = SummaryWriter(log_dir)
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except ImportError:
                pass

    def add_scalar(self, tag: str, value, step: int):
        self._jsonl.write(json.dumps(
            {"step": int(step), "tag": tag, "value": float(value),
             "time": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def add_scalars(self, scalars: dict, step: int):
        for tag, value in scalars.items():
            self.add_scalar(tag, value, step)

    def add_image(self, tag: str, image, step: int):
        """An (H, W) or (H, W, C) image, written as CHW; a no-op without a
        TensorBoard backend (the reference logs image, prediction and
        label every 20-50 iterations, ``train_fully_supervised_2D.py:
        124-141``). JAX: ``MetricsWriter.add_image``."""
        if self._tb is None:
            return
        import numpy as np
        img = np.asarray(image)
        if img.ndim == 2:
            img = img[None]
        elif img.ndim == 3:
            img = img.transpose(2, 0, 1)
        self._tb.add_image(tag, img, int(step))

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
