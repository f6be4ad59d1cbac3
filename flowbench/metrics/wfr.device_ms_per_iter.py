"""WFR ALG2 loop: the traced sub-window's device busy time over the
kernel #1 launches the program counted in it (ms), one launch an
iteration, the iterations the device loop runs past a pair's stop
included; the flow extraction's and the growth's device time lie inside
the busy time."""


def read(rec):
    prof = rec["profile"]
    if prof is None:
        return None
    launches = prof["launches"].get("fused_pointwise", 0)
    if launches == 0:
        return None
    return 1e3 * prof["busy_s"] / launches
