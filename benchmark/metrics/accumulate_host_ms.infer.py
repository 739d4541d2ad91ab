"""accumulate_host_ms.infer (ms): host time of the program's spans
``val3d.accumulate`` (each batch's window stacking and its indexed adds
into the score map) in the traced window, a volume's share."""
from benchmark import spans


def read(run):
    return spans.host_span_ms(run, "val3d.accumulate")
