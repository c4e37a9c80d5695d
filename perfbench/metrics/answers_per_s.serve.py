"""Answers a second on the host's clock: the window's requests over the
time from its opening until the last of them was answered (the
end-to-end number until the host's speed, which varies by up to a
factor of two on a shared host, made it too unsteady for any bound)."""


def read(run):
    return run.get("answers_per_s")
