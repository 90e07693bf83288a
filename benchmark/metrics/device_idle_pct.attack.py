"""device_idle_pct.attack: the share of the traced stretch of whole attack
calls in which no kernel, copy or fill ran on the card (the union of
their intervals against the stretch's span)."""


def read(ctx):
    t = ctx.trace
    if not t.device_events():
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
