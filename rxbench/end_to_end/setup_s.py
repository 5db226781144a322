"""setup_s: process start to the first timed step (host clock): imports,
the cell's files, the host encoding of the base frame, the pool made on
the card, the program's superstep and acquisition, one warm step per pool
entry (and, in a fresh checkout, the program's nvcc builds)."""


def read(rec):
    return rec["setup_s"]
