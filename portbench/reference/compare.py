"""The comparisons that decide `correct`: numbers read from what a coder
produced, against the plain reference.  Each number is a count or a
share that a sound run keeps under its limit (the workload's `limits`).

- `enc_index_diff_share`: the share of the index entries that a stream
  decodes to (by `rans.decode`) that differ from the reference's indexes
  of the same clip;
- `enc_index_diff_over1`: entries that differ by more than 1 (still
  clips: the float order of a sum moves an index by one at most);
- `mv_diff_share` (IPP): the share of motion vectors that differ from
  the reference closed loop's;
- `stream_errors`: `rans.decode`'s count of ways in which a stream is not
  the encoding of what it decodes to (exact: limit 0);
- `table_diff_entries`: entries of the coder's static tables that differ
  from the tables the reference trains on its own indexes of the first
  clip;
- `dec_pixel_diff_share` / `dec_pixel_diff_over1`: pixels of a decode's
  output that differ from the reference's decode of the same stream.
"""

from __future__ import annotations

import torch


def diff_share(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return 1.0
    return float((a != b).sum()) / a.numel()


def diff_over1(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        return a.numel() + b.numel()
    return int(((a.to(torch.int32) - b.to(torch.int32)).abs() > 1).sum())


def table_diff(freqs_a, freqs_b) -> int:
    a, b = torch.as_tensor(freqs_a), torch.as_tensor(freqs_b)
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a.to(torch.int64) != b.to(torch.int64)).sum())


class Readings:
    """The worst reading of each number over the answers compared."""

    def __init__(self):
        self.values = {}

    def worst(self, name: str, value) -> None:
        self.values[name] = max(self.values.get(name, value), value)

    def add(self, name: str, value) -> None:
        self.values[name] = self.values.get(name, 0) + value
