"""Data parallelism across processes (port of ``cvssl_tpu/parallel``):
``mesh`` (the process group, the split model call, the collectives),
``spatial`` (the sliding window with its windows split over the ranks),
``halo`` (UNet3D's forward with its H axis split over the ranks) and
``dryrun`` (the multi-rank checks of JAX's ``dryrun_multichip``)."""
