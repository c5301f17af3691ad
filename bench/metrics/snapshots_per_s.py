"""snapshots_per_s (end to end, host clock): the live snapshots of every
call completed in the window (ragged tails' padding not counted), over the
window's seconds, from the first call's start to the last call's
synchronised end."""


def read(ctx):
    if not ctx.calls or ctx.window_s <= 0:
        return None
    return ctx.live / ctx.window_s
