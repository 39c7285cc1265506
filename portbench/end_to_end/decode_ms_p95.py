"""`decode_ms_p95`: the 95th percentile of one clip's decode call over
every call of the decode half, each timed by CUDA events recorded around
it, in ms."""

from portbench.end_to_end import _rate


def read(rec: dict) -> float:
    return _rate.p95_ms(rec, "dec")
