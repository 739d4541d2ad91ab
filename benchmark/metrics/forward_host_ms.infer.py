"""forward_host_ms.infer (ms): host time of the program's spans
``val3d.forward`` (each batch of windows through the predictor: the
UNet3D forward's launches) in the traced window, a volume's share."""
from benchmark import spans


def read(run):
    return spans.host_span_ms(run, "val3d.forward")
