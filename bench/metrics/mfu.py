"""mfu (model step, host clock over the benchmark's count): the model
step's operations over the whole window (every completed call: both graph
convolutions, the RNN cell or the weights' evolution, the edge
projections, the output head; bench/work/<config>.py) over the window's
seconds times the card's fp32 peak. None where the card has no entry in
the peaks table."""


def read(ctx):
    if ctx.peaks is None or not ctx.calls or ctx.window_s <= 0:
        return None
    return (100.0 * ctx.totals["step_flops"]
            / (ctx.window_s * ctx.peaks["fp32_flops"]))
