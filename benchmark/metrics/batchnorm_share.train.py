"""batchnorm_share.train (%): the device seconds of the BatchNorm kernels,
ATen's (names holding ``batch_norm_``) or the port's own (names beginning
``bnact_``, ``csrc/batch_norm_act.cu``), over the traced window's busy
seconds."""

KERNELS = ("batch_norm_", "bnact_")


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    seconds, launches = t.kernel_seconds(KERNELS)
    if not launches:
        return None
    return 100.0 * seconds / t.busy_s
