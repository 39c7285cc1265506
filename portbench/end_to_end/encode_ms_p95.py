"""`encode_ms_p95`: the 95th percentile of one clip's encode call over
every call of the encode half, each timed by CUDA events recorded around
it, in ms."""

from portbench.end_to_end import _rate


def read(rec: dict) -> float:
    return _rate.p95_ms(rec, "enc")
