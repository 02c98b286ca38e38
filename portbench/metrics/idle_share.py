"""idle_share.<kind>: the share of the time the program was working in
which no kernel or copy ran on the device, in %. Training: the traced
window, back-to-back epochs. Serving: the traced requests' time from call
to answer (the waits for arrivals left out), 1 - (the device's busy time
inside it) / it."""


def read(ctx: dict):
    span, busy = ((ctx["request_s"], ctx["request_busy_s"]) if ctx["kind"] == "serve"
                  else (ctx["window_s"], ctx["busy_s"]))
    if span <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / span)
