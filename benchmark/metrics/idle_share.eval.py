"""% of the traced window in which no operation ran on the card (one
minus the union of the device's activities over the window)."""
from harness.readings import idle_share


def read(run):
    return idle_share(run, "eval")
