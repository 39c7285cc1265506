"""Shared pieces of the A/B scripts (dct_ab.py, encode_ab.py, sad_ab.py,
lookback_ab.py, grid_ab.py, mc_ab.py, rows_ab.py), which compare the
current tree's kernels with other builds on one GPU.

Other builds live under _ab/ (git-ignored, so never committed): a library
compiled from another directory's source or from an edited copy of the
current one (`build_lib`), or a whole copy of vcf_tpu_torch with edits
(`copy_package`), or another commit's tree unpacked there by `git
archive`, which a process of its own imports (`import_tree`,
`run_in_turns`).  Times are taken in turns, (other, current, current,
other), so a drift of the card's clock over the call shows as a spread
within each build's pair, not as a difference between them.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
AB = os.path.join(ROOT, "_ab")


def edited(text: str, edits, what: str) -> str:
    """`text` with each (old, new) of `edits` replaced; each old must occur
    exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{what}: {old!r} is not once in the source")
        text = text.replace(old, new)
    return text


def build_lib(name: str, src_dir: str, main: str, also=(), edits=(),
              signatures=None, flags=()) -> tuple:
    """Compile src_dir's `main` .cu (with `edits`, the headers `also`
    copied beside it) by nvcc with the package's flags into
    _ab/build_<name>/lib.so; load it, and set the argtypes of every entry
    of `signatures` (entry -> argtypes, restype int).  Returns (the
    library, nvcc's stderr)."""
    sys.path.insert(0, ROOT)
    from vcf_tpu_torch.ops.cuda import _build

    out = os.path.join(AB, f"build_{name}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    for f in also:
        shutil.copy(os.path.join(src_dir, f), out)
    path = os.path.join(out, main)
    with open(os.path.join(src_dir, main)) as fh:
        text = edited(fh.read(), edits, f"{name} {main}")
    with open(path, "w") as fh:
        fh.write(text)
    lib = os.path.join(out, "lib.so")
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags,
                           f"-I{out}", "-shared", "-o", lib, path],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{done.stderr}")
    dll = ctypes.CDLL(lib)
    for entry, argtypes in (signatures or {}).items():
        fn = getattr(dll, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return dll, done.stderr


def copy_package(name: str, edits) -> str:
    """A copy of vcf_tpu_torch (without its build) under _ab/<name>/ with
    `edits`, each (path in the package, old, new); returns the directory
    to import it from."""
    root = os.path.join(AB, name)
    shutil.rmtree(root, ignore_errors=True)
    pkg = os.path.join(root, "vcf_tpu_torch")
    shutil.copytree(os.path.join(ROOT, "vcf_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in edits:
        path = os.path.join(pkg, rel)
        with open(path) as fh:
            text = edited(fh.read(), [(old, new)], f"{name} {rel}")
        with open(path, "w") as fh:
            fh.write(text)
    return root


def import_tree(root: str):
    """Make this process import vcf_tpu_torch from `root` (the current
    tree's chip_smoke.py drives it); returns chip_smoke.  Call it before
    anything imports vcf_tpu_torch."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, root)   # after chip_smoke, which puts ROOT first
    from vcf_tpu_torch.ops.cuda import _build

    cs.require(os.path.samefile(_build.SRC_DIR.parent.parent, root),
               f"imported {_build.SRC_DIR}, not {root}")
    return cs


def run_in_turns(script: str, roots, timeout: int = 900, args=()) -> list:
    """Run `python3 script *args --time ROOT` for each of `roots` in order,
    each in a process of its own (stderr passed through); returns the JSON
    object each printed as its last line."""
    out = []
    for root in roots:
        done = subprocess.run([sys.executable, script, *args, "--time", root],
                              stdout=subprocess.PIPE, text=True,
                              timeout=timeout, check=True)
        out.append(json.loads(done.stdout.strip().splitlines()[-1]))
    return out


@contextlib.contextmanager
def quiet():
    """Send what chip_smoke's phases print to stderr, so that a timing
    process's stdout holds its JSON line alone."""
    with contextlib.redirect_stdout(sys.stderr):
        yield


def sha(*tensors) -> str:
    """A short SHA-256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def queued_ms(fn, reps: int = 20) -> float:
    """Device ms a call of `fn` with the host out of its way: the calls
    are issued while a sleeping kernel (~5 ms) holds the stream, so they
    run back to back once it ends."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda._sleep(10_000_000)
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def tree_lines(name: str, runs: list, head, exact: bool = True) -> list:
    """The rows of an A/B of trees from `run_in_turns`' results, run as
    (other, current, current, other) per round: every output's "sha" must
    agree across all runs (for an exact other tree; a timing-only one
    records whether it did); a kernel row is `head(key, the first run's
    row)` (shape, bound, ...) and each tree's values of every timed field
    in run order (with the multiples of "bound_ms" for "ms"); a path row
    each tree's values."""
    import chip_smoke as cs

    theirs = [r for i, r in enumerate(runs) if i % 4 in (0, 3)]
    mine = [r for i, r in enumerate(runs) if i % 4 in (1, 2)]
    lines = []
    for key in runs[0]["rows"]:
        same = len({r["rows"][key]["sha"] for r in runs}) == 1
        cs.require(same or not exact, f"{key}: the {name} tree's output "
                   "differs")
        row = {**head(key, runs[0]["rows"][key]),
               f"bit_identical_to_{name}": same}
        for who, rs in ((name, theirs), ("current", mine)):
            for k in rs[0]["rows"][key]:
                if k == "sha":
                    continue
                vals = [r["rows"][key][k] for r in rs]
                row[f"{who}_{k}"] = vals
                if k == "ms" and "bound_ms" in row:
                    row[f"{who}_x_bound"] = [t / row["bound_ms"] for t in vals]
        lines.append(row)
    for path in runs[0].get("paths", {}):
        same = len({r["paths"][path]["sha"] for r in runs}) == 1
        cs.require(same or not exact, f"phase {path}: the {name} tree's "
                   "output differs")
        row = {"path": path, f"bit_identical_to_{name}": same}
        for who, rs in ((name, theirs), ("current", mine)):
            for k in rs[0]["paths"][path]:
                if k == "sha":
                    continue
                vals = [r["paths"][path][k] for r in rs]
                if isinstance(vals[0], dict):
                    row[f"{who}_{k}"] = {part: [v[part] for v in vals]
                                         for part in vals[0]}
                else:
                    row[f"{who} {k}"] = vals
        lines.append(row)
    return lines


def compare_trees(script: str, parent, variants: dict, rounds: int,
                  head, timing_only=()) -> list:
    """Run `script --time TREE` for the parent tree (if given) and each
    variant package (name -> edits, copied by `copy_package`) in turns
    with the current tree, `rounds` times each; print and return
    `tree_lines`' rows (variants named in `timing_only` may differ)."""
    others = {}
    if parent:
        others["parent"] = os.path.abspath(parent)
    for name, edits in variants.items():
        others[name] = copy_package(name, edits)
    lines = []
    for name, root in others.items():
        runs = run_in_turns(script, [root, ROOT, ROOT, root] * rounds)
        for row in tree_lines(name, runs, head, name not in timing_only):
            print(json.dumps(row), flush=True)
            lines.append(row)
    return lines


def turns(other, current, reps: int) -> dict:
    """CUDA-event ms a call of `other` and `current` (chip_smoke.cuda_ms,
    `reps` calls after a warm-up), in turns: {"other": [first, last],
    "current": [second, third]}."""
    import chip_smoke as cs

    t = [cs.cuda_ms(f, reps) for f in (other, current, current, other)]
    return {"other": [t[0], t[3]], "current": [t[1], t[2]]}


def write_json(lines: list, path: str | None) -> None:
    """Write the A/B's rows to `path` (if given), creating its directory."""
    if not path:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(lines, fh, indent=1)
