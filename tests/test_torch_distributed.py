"""Two real processes over Gloo on the CPU: the port's distribution layer
across a process boundary (mirrors tests/test_distributed.py).

The worker (tests/_torch_dist_worker.py) joins through
`dist.initialize` with a coordinator and runs `global_mesh`, the
collectives across the processes (histogram and float psum, broadcast,
the DWT's halo ring), LBT's step and the k-means against the same shards
in one process, and the codec: each rank encodes every other frame of an
8-frame clip and `gather_streams` gives every frame in order.  Its
streams, planes and shared Lloyd-Max levels must equal a one-process run
byte for byte.  The workers get 180 s; a timeout fails the test.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np

from vcf_tpu_torch import Codec, CodecConfig
from vcf_tpu_torch.parallel import BatchCodec

WORKER = os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py")
TIMEOUT_S = 180

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dist_worker as worker  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sha(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


def test_two_process_distributed():
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, f"localhost:{port}", "2", str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, _, err in outs:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
    report = json.loads(
        [ln for ln in outs[0][1].splitlines() if ln.startswith("{")][-1])
    assert report["processes"] == 2 and report["backend"] == "gloo"
    for key in ("hist_ok", "psum_ok", "replicate_ok", "dwt_ok", "lbt_ok",
                "kmeans_ok", "imports_clean"):
        assert report[key] is True, key

    frames = worker.clip(64, 96)
    codec = Codec(CodecConfig(entropy="grans"), "cpu")
    assert report["stream_sha"] == [_sha(codec.encode(f).to_bytes())
                                    for f in frames]
    lm = BatchCodec(CodecConfig(quantizer="lloydmax", entropy="zlib"), "cpu",
                    shared_levels=True)
    planes = lm.encode_planes(frames)
    assert report["planes_sha"] == [_sha(p.tobytes()) for p in planes]
    assert report["levels_sha"] == _sha(
        np.ascontiguousarray(lm.last_qside["levels"]).tobytes())
