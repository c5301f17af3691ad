"""setup_s (end to end, host clock): from the top of bench/run.py to the
first timed call: the engine's build or load, the inputs, the port's
ingest and upload, the params, the session and the warm-up calls."""


def read(ctx):
    return ctx.setup_s
