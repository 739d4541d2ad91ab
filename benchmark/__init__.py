"""The benchmark of cvssl_tpu_torch (see run.py)."""
