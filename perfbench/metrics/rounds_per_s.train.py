"""Rounds a second on the host's clock: the rounds completed over the
untraced rest of the training window (the end-to-end number until the
host's speed, which varies by up to a factor of two on a shared host,
made it too unsteady for any bound)."""


def read(run):
    return run.get("rounds_per_s")
