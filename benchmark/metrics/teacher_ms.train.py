"""teacher_ms.train (ms): step phase ``teacher`` (every EMA-teacher pass,
inside the forward) of the program's newest step, the traced window's last
graph replay: device time between the phase's timing events, recorded by the
replay."""
from benchmark import spans


def read(run):
    return spans.phase_ms(run, "teacher")
