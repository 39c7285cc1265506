"""Worker for the two-process test of the port's distribution layer
(tests/test_torch_distributed.py; chip_smoke.py runs it on the card).

Run as:

    python tests/_torch_dist_worker.py <coordinator> <n_procs> <rank> \
        [<device> <height> <width>]

Each rank joins a Gloo group through `dist.initialize` with a
coordinator and runs, on `device` (default cpu): `global_mesh`,
`allreduce_histogram` and a float psum across the processes,
`replicate` of rank 0's table, the row-sharded DWT with its halos crossing
the processes, LBT's data-parallel step and the sharded k-means (each
against the same work on this process's shards alone), and the codec:
rank p encodes the frames p, p + n_procs, ... of an 8-frame clip (rolled
copies of test_image(height, width, seed=3)) with the `grans` Codec and a
shared-levels Lloyd-Max BatchCodec whose histogram spans the processes,
then `gather_streams` collects every frame's stream and planes (variable
lengths, interleaved) in frame order.  Rank 0 prints one JSON line; the
caller compares its hashes with a one-process run.  Neither jax nor
vcf_tpu may be imported.
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_FRAMES = 8


def sha(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


def clip(h: int, w: int):
    import numpy as np
    from vcf_tpu_torch.io import test_image

    base = test_image(h, w, seed=3)
    return np.stack([np.roll(base, (7 * i, 13 * i), (0, 1))
                     for i in range(N_FRAMES)])


def main() -> None:
    coordinator, n_procs, rank = sys.argv[1], int(sys.argv[2]), int(
        sys.argv[3])
    device = sys.argv[4] if len(sys.argv) > 4 else "cpu"
    h, w = (int(sys.argv[5]), int(sys.argv[6])) if len(sys.argv) > 6 else (
        64, 96)

    import numpy as np
    import torch
    import torch.distributed as tdist

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    from vcf_tpu_torch import Codec, CodecConfig
    from vcf_tpu_torch.ops import dwt, lbt, prng, vq
    from vcf_tpu_torch.parallel import BatchCodec, Mesh, dist

    dist.initialize(coordinator, n_procs, rank, backend="gloo")
    assert dist.process_count() == n_procs
    gmesh = dist.global_mesh()
    assert gmesh.devices == (torch.device("cpu"),) and gmesh.group is not None
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    mesh = Mesh((dev,), group=gmesh.group)
    mesh2 = Mesh((dev, dev), group=gmesh.group)          # two shards a rank
    report = {"processes": dist.process_count(),
              "backend": tdist.get_backend(), "device": str(dev)}

    # allreduce_histogram and a float psum across the processes: rank p
    # holds p + 1 in every bin
    hist = dist.allreduce_histogram(
        torch.full((1, 8), rank + 1, dtype=torch.int64), gmesh)
    report["hist_ok"] = bool((hist == n_procs * (n_procs + 1) // 2).all())
    vals = [torch.linspace(0, 1, 5, device=dev) * (rank + 1) / 3]
    total = dist._psum(vals, mesh)
    want = sum(torch.linspace(0, 1, 5) * (p + 1) / 3 for p in range(n_procs))
    report["psum_ok"] = bool(torch.allclose(total.cpu(), want, rtol=1e-6))

    # replicate: rank 0's table on every device of every process
    table = dist.replicate(np.arange(16, dtype=np.float32) + 100 * rank, mesh2)
    report["replicate_ok"] = all(
        torch.equal(t.cpu(), torch.arange(16, dtype=torch.float32))
        and t.device == dev for t in table)

    # the row-sharded DWT: 2 slabs a rank, the halos crossing processes
    frame = torch.from_numpy(clip(h, w)[0].astype(np.float32)).to(dev)
    rows = frame.shape[0] // n_procs
    mine = frame[rank * rows:(rank + 1) * rows]
    report["dwt_ok"] = True
    for name in ("haar", "db5", "bior4.4"):
        bank = dwt.get_bank(name)
        ll, det = dwt.analyze_level_rows_sharded(list(mine.chunk(2)), bank,
                                                 mesh2)
        ref_ll, ref_det = dwt.analyze_level(frame, bank)
        for got, ref in zip([ll, *det], [ref_ll, *ref_det]):
            half = ref.shape[0] // n_procs
            report["dwt_ok"] &= torch.equal(
                torch.cat(got), ref[rank * half:(rank + 1) * half])

    # LBT's step and the k-means, one shard a rank: across the processes,
    # bit for bit the same shards in this process (a sum of two terms is
    # the same in either order)
    blocks = lbt.blocks_of(frame - 128.0, 8)
    blocks = blocks[:blocks.shape[0] // n_procs * n_procs]
    blocks = blocks - blocks.mean(0)
    shards = list(blocks.chunk(n_procs))
    w0 = torch.from_numpy(lbt.dct_init(8)).to(dev)
    params = {"enc": w0, "dec": w0.T.contiguous()}
    init, step = lbt.train_step_fn()
    one = Mesh((dev,) * n_procs)
    p_dist, _, loss_dist = step(params, init(params), shards[rank:rank + 1],
                                mesh)
    p_one, _, loss_one = step(params, init(params), shards, one)
    report["lbt_ok"] = (all(torch.equal(p_dist[k], p_one[k]) for k in params)
                        and bool(torch.equal(loss_dist, loss_one)))
    km_dist = vq.kmeans_sharded(prng.PRNGKey(1), blocks, 16, mesh, iters=5)
    km_one = vq.kmeans_sharded(prng.PRNGKey(1), blocks, 16, one, iters=5)
    # equal on the CPU; on CUDA the float64 sums' atomics may round one
    # centre coordinate the other way (ops/vq.py), so within 1e-3 there
    report["kmeans_ok"] = bool(
        np.allclose(km_dist[0], km_one[0], rtol=0, atol=1e-3)
        and (km_dist[1] == km_one[1]).mean() >= 0.999
        and np.array_equal(km_dist[2], km_one[2]))

    # the codec: this rank's frames, gathered in frame order
    frames = clip(h, w)
    ids = list(range(rank, N_FRAMES, n_procs))
    codec = Codec(CodecConfig(entropy="grans"), dev)
    streams = dist.gather_streams(
        [(i, codec.encode(frames[i]).to_bytes()) for i in ids], N_FRAMES)
    lm = BatchCodec(CodecConfig(quantizer="lloydmax", entropy="zlib"), dev,
                    mesh=mesh, shared_levels=True)
    planes = lm.encode_planes(frames[ids])
    gathered = dist.gather_streams(
        [(i, p.tobytes()) for i, p in zip(ids, planes)], N_FRAMES)
    report["stream_sha"] = [sha(s) for s in streams]
    report["planes_sha"] = [sha(p) for p in gathered]
    report["levels_sha"] = sha(np.ascontiguousarray(
        lm.last_qside["levels"]).tobytes())
    report["imports_clean"] = not any(
        m in ("jax", "vcf_tpu") or m.startswith(("jax.", "vcf_tpu."))
        for m in sys.modules)
    assert report["imports_clean"], "jax or vcf_tpu imported"
    tdist.destroy_process_group()
    if rank == 0:
        print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
