"""step_gather_ms.uamt3d (ms): step phase ``gather`` (the store's gather) of
the program's newest step, the traced window's last graph replay: device
time between the phase's timing events, recorded by the replay."""
from benchmark import spans


def read(run):
    return spans.phase_ms(run, "gather")
