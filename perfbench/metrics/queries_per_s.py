"""Queries completed in the measured window over the window's seconds
(host clock; the window ends on an iteration whose results the host has
read, so the card has finished them)."""


def read(run, name):
    return len(run.completions) / run.window_s
