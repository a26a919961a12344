"""Env steps completed per second: every env's steps of the window over the
host-clock time from the synchronised start to the final synchronise."""


def read(ctx):
    if ctx.trace is not None or ctx.window_s <= 0:
        return None
    return ctx.n_envs * ctx.steps / ctx.window_s
