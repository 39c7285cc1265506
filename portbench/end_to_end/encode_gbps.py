"""`encode_gbps`: u8 pixel bytes of every clip encoded in the window's
encode half over that half's wall time (host clock), in GB/s."""

from portbench.end_to_end import _rate


def read(rec: dict) -> float:
    return _rate.gbps(rec, "enc")
