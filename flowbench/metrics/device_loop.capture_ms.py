"""Device loop (solvers/device_loop.py): the milliseconds its graph
captures took during set-up (the change in stats.capture_ms), a counter
of the program."""


def read(rec):
    return rec["setup_loop"]["capture_ms"]
