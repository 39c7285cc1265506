"""The port's profiler hooks (vcf_tpu_torch.utils.profiling) on the CPU:
`trace` writes one Chrome trace of the block it wraps into its
directory, and `device_memory_stats` is empty without a card."""

import json
import os

import numpy as np
import torch

from vcf_tpu_torch import Codec, CodecConfig
from vcf_tpu_torch.io import test_image as make_test_image
from vcf_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    log_dir = str(tmp_path / "trace")
    codec = Codec(CodecConfig(entropy="zlib"), "cpu")
    with profiling.trace(log_dir) as d:
        assert d == log_dir
        rec = codec.decode(codec.encode(make_test_image(32, 48, seed=1)))
    assert rec.shape == (32, 48, 3) and rec.dtype == np.uint8
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}
