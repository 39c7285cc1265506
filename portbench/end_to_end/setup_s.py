"""`setup_s`: process start to the first timed call, in s (imports, the
kernel library, the pool of clips, the tables, the warm-up)."""


def read(rec: dict) -> float:
    return rec["setup_s"]
