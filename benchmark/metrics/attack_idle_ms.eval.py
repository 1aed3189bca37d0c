"""Card-idle ms a batch of the traced run's ranged pass while the host
was inside the evaluation's attack call (`layer:eval.attack`): the gaps
between the device's activities whose middle lies in that span."""
from harness.program_spans import idle_ms_per_step


def read(run):
    return idle_ms_per_step(run, "eval", "layer:eval.attack")
