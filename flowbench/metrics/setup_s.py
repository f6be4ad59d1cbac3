"""Process start to the first timed call (s): imports, the CUDA context,
the kernel library (built at the first run in a checkout), the traffic
pool and the warm-up call of the cell's shapes, host clock."""


def read(rec):
    return rec["setup_s"]
