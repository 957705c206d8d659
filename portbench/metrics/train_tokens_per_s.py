"""Tokens of every step completed in the window over the window's wall
time (host clock; the window ends with its last step's loss read)."""


def read(run):
    if not run.steps:
        return None
    return run.tokens_per_step * run.steps / run.window_s
