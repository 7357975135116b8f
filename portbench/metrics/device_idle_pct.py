"""device_idle_pct (``.sat``, ``.light``): the share of the traced window
in which no kernel, copy or memset ran on the card (torch.profiler, CUDA
activity), in %."""
from portbench.readers import idle_pct


def read(rec):
    return idle_pct(rec)
