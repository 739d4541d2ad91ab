"""cvssl_tpu_torch — the PyTorch/CUDA port of ``cvssl_tpu``.

Mirrors the JAX package's module layout (``ops/``, ``models/``, ``data/``,
``train/``, ``train/methods/``, ``eval/``, ``utils/``) so every module has an
obvious counterpart; CUDA sources live in ``csrc/``.
Layout is NCHW with the class axis at 1, as in the original torch code.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

The package imports torch, numpy and scipy only: nothing of JAX and nothing
of ``cvssl_tpu``.
"""
