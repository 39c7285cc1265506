"""The port's distribution layer (vcf_tpu_torch.parallel, the sharded paths
of IIICodec/IPPCodec, the row-sharded DWT, LBT's data-parallel step and
the sharded k-means) against vcf_tpu's on the CPU.

vcf_tpu shards over conftest's 8 virtual CPU devices (`make_mesh(8)`);
the port over a mesh that names the CPU 8 times, whose shards run one
after another.

Tolerances, each with its reason:
* the port's sharded paths against its own one-device paths: equal, byte
  for byte (planes, levels, streams, decoded frames) and bit for bit (the
  DWT subbands): each shard runs the same per-frame work;
* index planes against vcf_tpu's: the +-1 rule (float32 sums in another
  order; at most 0.01% of entries, 0.05% in the IPP closed loop, ROADMAP
  C7), rmse to 3 decimals, equal streams where the planes are equal;
* k-means: centres atol 1e-3 and labels equal (vcf_tpu's own test);
* the DWT against vcf_tpu's shard_map form: atol 1e-5 (its own test);
* LBT's step: parameters and loss within rtol 1e-5 (float32 gradients
  summed in another order), on a test image's blocks: on
  __graft_entry__'s linspace blocks every coefficient but a few has a
  variance of rounding alone (~1e-16), which the coding term's log
  divides by, so no float order agrees there (ROADMAP C14).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import vcf_tpu
import vcf_tpu.video as jvideo
from vcf_tpu.io.video import test_video as make_test_video
from vcf_tpu.ops import dwt as jdwt
from vcf_tpu.ops import lbt as jlbt
from vcf_tpu.ops import vq as jvq
from vcf_tpu.parallel import mesh as jmesh
from vcf_tpu_torch import CodecConfig, CodeStream, metrics, video
from vcf_tpu_torch.config import VideoConfig
from vcf_tpu_torch.io import test_image as make_test_image
from vcf_tpu_torch.ops import dwt as tdwt
from vcf_tpu_torch.ops import lbt as tlbt
from vcf_tpu_torch.ops import prng
from vcf_tpu_torch.ops import vq as tvq
from vcf_tpu_torch.parallel import BatchCodec, Mesh, dist, make_mesh
from vcf_tpu_torch.parallel import shard_batch

MAX_DIFF_SHARE = 1e-4
MAX_IPP_DIFF_SHARE = 5e-4
CPU = torch.device("cpu")


def cpu_mesh(n):
    return Mesh((CPU,) * n)


@pytest.fixture(scope="module")
def jmesh8():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    return jmesh.make_mesh(8)


def _index_rule(got, want, share=MAX_DIFF_SHARE):
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(want))
    assert d.max() <= 1
    assert np.count_nonzero(d) <= share * d.size


# ---------------------------------------------------------------------------
# Mesh, make_mesh, shard_batch
# ---------------------------------------------------------------------------

def test_make_mesh_raises_past_the_visible_devices():
    assert make_mesh(device_type="cpu").devices == (CPU,)
    with pytest.raises(RuntimeError, match="2 cpu devices"):
        make_mesh(2, "cpu")
    with pytest.raises(RuntimeError, match="cuda devices"):
        make_mesh(torch.cuda.device_count() + 1)


def test_shard_batch_and_codec_meshes():
    x = np.arange(24).reshape(8, 3)
    shards = shard_batch(x, cpu_mesh(4))
    assert [s.tolist() for s in shards] == [x[2 * i:2 * i + 2].tolist()
                                            for i in range(4)]
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(x[:7], cpu_mesh(4))
    with pytest.raises(ValueError, match="first device"):
        BatchCodec(CodecConfig(), "cpu", mesh=Mesh((torch.device("meta"),)))
    with pytest.raises(ValueError, match="first device"):
        video.IPPCodec(VideoConfig(mode="ipp"), CodecConfig(), "cpu",
                       mesh=Mesh((torch.device("meta"),)))


# ---------------------------------------------------------------------------
# BatchCodec
# ---------------------------------------------------------------------------

ROUTES = {"cdct": dict(), "planes": dict(color="none"),
          "torch": dict(use_pallas=False)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_batch_codec_sharded(route, jmesh8):
    """8 frames over 8 shards: byte for byte the one-device port, and
    vcf_tpu's sharded planes under the +-1 rule."""
    frames = make_test_video(8, 64, 80)
    kw = dict(qss=32, entropy="zlib", **ROUTES[route])
    one = BatchCodec(CodecConfig(**kw), "cpu")
    sharded = BatchCodec(CodecConfig(**kw), "cpu", mesh=cpu_mesh(8))
    assert sharded.route == route
    planes = sharded.encode_planes(frames)
    np.testing.assert_array_equal(planes, one.encode_planes(frames))
    rec = sharded.decode_planes(planes)
    np.testing.assert_array_equal(rec, one.decode_planes(planes))
    jc = jmesh.BatchCodec(vcf_tpu.CodecConfig(**kw), jmesh8)
    planes_j = np.asarray(jc.encode_planes(frames))
    _index_rule(planes, planes_j)
    rec_j = np.asarray(jc.decode_planes(planes_j))
    assert abs(metrics.rmse(frames, rec) - metrics.rmse(frames, rec_j)) < 1e-3


def test_batch_codec_ragged_batch():
    """5 frames (61x45, padded to blocks) over 8 shards: the padding of
    the batch and of the frames is invisible."""
    frames = np.stack([make_test_image(61, 45, seed=i) for i in range(5)])
    cfg = CodecConfig(qss=32, entropy="zlib")
    sharded = BatchCodec(cfg, "cpu", mesh=cpu_mesh(8))
    planes = sharded.encode_planes(frames)
    assert planes.shape[0] == 5
    one = BatchCodec(cfg, "cpu")
    np.testing.assert_array_equal(planes, one.encode_planes(frames))
    rec = sharded.decode_planes(planes, original_hw=(61, 45))
    assert rec.shape == frames.shape
    np.testing.assert_array_equal(
        rec, one.decode_planes(planes, original_hw=(61, 45)))


@pytest.mark.parametrize("shared", [False, True], ids=["per-frame", "shared"])
def test_batch_codec_lloydmax_sharded(shared, jmesh8):
    """Lloyd-Max over 8 shards: levels and planes equal to the one-device
    port's, and vcf_tpu's sharded route (per-frame levels; with
    shared_levels, one set from the psummed histogram): levels equal,
    planes under the +-1 rule."""
    frames = make_test_video(8, 64, 80)
    cfg = CodecConfig(quantizer="lloydmax", qss=32, entropy="zlib")
    sharded = BatchCodec(cfg, "cpu", mesh=cpu_mesh(8), shared_levels=shared)
    one = BatchCodec(cfg, "cpu", shared_levels=shared)
    planes = sharded.encode_planes(frames)
    levels = sharded.last_qside["levels"]
    np.testing.assert_array_equal(planes, one.encode_planes(frames))
    np.testing.assert_array_equal(levels, one.last_qside["levels"])
    assert levels.ndim == (2 if shared else 3)
    np.testing.assert_array_equal(sharded.decode_planes(planes),
                                  one.decode_planes(planes))
    jc = jmesh.BatchCodec(vcf_tpu.CodecConfig(
        quantizer="lloydmax", qss=32, entropy="zlib"), jmesh8,
        shared_levels=shared)
    planes_j = np.asarray(jc.encode_planes(frames))
    np.testing.assert_array_equal(levels, jc.last_qside["levels"])
    _index_rule(planes, planes_j)


def test_shared_levels_leave_the_padding_out():
    """A ragged batch's shared levels do not depend on the mesh: the
    padding frames are not counted."""
    frames = make_test_video(5, 64, 80)
    cfg = CodecConfig(quantizer="lloydmax", qss=32, entropy="zlib")
    runs = [BatchCodec(cfg, "cpu", mesh=m, shared_levels=True)
            for m in (None, cpu_mesh(4))]
    planes = [r.encode_planes(frames) for r in runs]
    np.testing.assert_array_equal(planes[0], planes[1])
    np.testing.assert_array_equal(runs[0].last_qside["levels"],
                                  runs[1].last_qside["levels"])


def test_iii_codec_mesh_stream_equals_one_device():
    frames = make_test_video(8, 64, 80)
    vcfg = VideoConfig(n_frames=8)
    for ccfg in (CodecConfig(entropy="grans"), CodecConfig(entropy="zlib")):
        one = video.IIICodec(vcfg, ccfg, "cpu")
        sharded = video.IIICodec(vcfg, ccfg, "cpu", mesh=cpu_mesh(8))
        cs = sharded.encode(frames)
        assert cs.to_bytes() == one.encode(frames).to_bytes()
        np.testing.assert_array_equal(
            sharded.decode(CodeStream.from_bytes(cs.to_bytes())),
            one.decode(cs))


# ---------------------------------------------------------------------------
# IPPCodec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vkw", [dict(), dict(rdo_lambda=0.5)],
                         ids=["plain", "rdo"])
def test_ipp_codec_mesh(vkw, jmesh8):
    """8 frames at gop 2 (4 GOPs on 8 shards: the GOP batch is padded):
    the stream equals the one-device port's byte for byte and vcf_tpu's
    sharded stream under C7's rule; both decoders give the encoder's
    reconstruction."""
    frames = make_test_video(8, 64, 80)
    vkw = dict(mode="ipp", n_frames=8, gop_size=2, search_range=4, **vkw)
    ckw = dict(qss=32, entropy="grans")
    one = video.IPPCodec(VideoConfig(**vkw), CodecConfig(**ckw), "cpu")
    sharded = video.IPPCodec(VideoConfig(**vkw), CodecConfig(**ckw), "cpu",
                             mesh=cpu_mesh(8))
    cs = CodeStream.from_bytes(sharded.encode(frames).to_bytes())
    assert cs.to_bytes() == one.encode(frames).to_bytes()
    rec = sharded.decode(cs)
    np.testing.assert_array_equal(rec, sharded.last_recon.numpy())
    np.testing.assert_array_equal(rec, one.decode(cs))
    jc = jvideo.IPPCodec(vcf_tpu.config.VideoConfig(**vkw),
                         vcf_tpu.CodecConfig(**ckw), mesh=jmesh8)
    cs_j = jc.encode(frames)
    assert list(cs) == list(cs_j)
    assert cs.get_json("payload") == cs_j.get_json("payload")
    for name in cs_j:
        if name.startswith(("mv_", "modes_")):
            np.testing.assert_array_equal(cs.get_array(name),
                                          cs_j.get_array(name))
    side = {k[len("clip."):]: cs_j[k] for k in cs_j
            if k.startswith("clip.") and k != "clip.payload"}
    planes_j = np.asarray(sharded.entropy_codec.decode(cs_j["clip.payload"],
                                                       side))
    _index_rule(sharded.last_planes, planes_j, MAX_IPP_DIFF_SHARE)
    if np.array_equal(sharded.last_planes, planes_j):
        assert cs.to_bytes() == cs_j.to_bytes()
    np.testing.assert_array_equal(sharded.decode(cs_j),
                                  np.asarray(jc.decode(cs_j)))


# ---------------------------------------------------------------------------
# parallel.dist within one process
# ---------------------------------------------------------------------------

def test_gather_streams_single_process():
    streams = [(2, b"cc"), (0, b"aaa"), (1, b"b")]
    assert dist.gather_streams(streams, 3) == [b"aaa", b"b", b"cc"]
    with pytest.raises(ValueError, match="missing streams"):
        dist.gather_streams([(0, b"x")], 2)


def test_allreduce_histogram_and_replicate():
    # shard i contributes i + 1 to every bin (tests/test_parallel.py)
    local = np.stack([np.full(16, i + 1, np.int32) for i in range(8)])
    out = dist.allreduce_histogram(local, cpu_mesh(8))
    assert out.shape == (1, 16) and bool((out == 36).all())
    as_list = dist.allreduce_histogram(list(torch.from_numpy(local)[:, None]),
                                       cpu_mesh(8))
    assert torch.equal(as_list, out)
    arr = np.arange(10, dtype=np.float32)
    copies = dist.replicate(arr, cpu_mesh(8))
    assert len(copies) == 8
    assert all(torch.equal(c, torch.from_numpy(arr)) for c in copies)
    assert len({c.data_ptr() for c in copies}) == 8       # one copy each


# ---------------------------------------------------------------------------
# The sharded k-means, DWT and LBT step
# ---------------------------------------------------------------------------

def test_kmeans_sharded_matches_vcf_tpu(jmesh8):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4096, 12)).astype(np.float32) * 40 + 100
    cb_j, lab_j, init_j = jvq.kmeans_sharded(jax.random.PRNGKey(3), x, 16,
                                             jmesh8)
    cb, lab, init = tvq.kmeans_sharded(prng.PRNGKey(3), x, 16, cpu_mesh(8))
    np.testing.assert_array_equal(init, init_j)
    np.testing.assert_allclose(cb, cb_j, atol=1e-3)
    np.testing.assert_array_equal(lab, lab_j)
    # the unsharded trainer from the same init
    cb_u, lab_u = tvq.kmeans(prng.PRNGKey(3), torch.from_numpy(x), 16,
                             init_centers=torch.from_numpy(init))
    np.testing.assert_allclose(cb, cb_u.numpy(), atol=1e-3)
    np.testing.assert_array_equal(lab, lab_u.numpy())


def test_kmeans_sharded_mesh_size_invariance():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2048, 8)).astype(np.float32) * 30
    cb1, lab1, _ = tvq.kmeans_sharded(prng.PRNGKey(5), x, 8, cpu_mesh(1))
    cb8, lab8, _ = tvq.kmeans_sharded(prng.PRNGKey(5), x, 8, cpu_mesh(8))
    np.testing.assert_allclose(cb1, cb8, atol=1e-3)
    np.testing.assert_array_equal(lab1, lab8)


@pytest.mark.parametrize("wavelet", ["haar", "db5", "bior4.4"])
def test_rows_sharded_dwt_level(wavelet):
    """4 row slabs of a 128x32x3 frame: bit for bit the port's
    analyze_level, and vcf_tpu's shard_map form (tests/test_dwt.py)
    within 1e-5."""
    x = np.random.default_rng(0).normal(size=(128, 32, 3)).astype(np.float32)
    bank = jdwt.get_bank(wavelet)
    jm4 = JMesh(np.array(jax.devices()[:4]), ("tile",))

    @jax.jit
    @functools.partial(shard_map, mesh=jm4, in_specs=(P("tile"),),
                       out_specs=(P("tile"), (P("tile"),) * 3))
    def sharded(xl):
        return jdwt.analyze_level_rows_sharded(xl, bank, "tile", 4)

    ll_j, det_j = sharded(jnp.asarray(x))
    assert tdwt.halo_sizes(tdwt.get_bank(wavelet)) == jdwt.halo_sizes(bank)
    ll, det = tdwt.analyze_level_rows_sharded(
        list(torch.from_numpy(x).chunk(4)), tdwt.get_bank(wavelet),
        cpu_mesh(4))
    ref_ll, ref_det = tdwt.analyze_level(torch.from_numpy(x),
                                         tdwt.get_bank(wavelet))
    for got, ref, want in zip([ll, *det], [ref_ll, *ref_det],
                              [ll_j, *det_j]):
        got = torch.cat(got)
        assert torch.equal(got, ref)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_rows_sharded_dwt_refuses_short_slabs():
    bank = tdwt.get_bank("db5")
    with pytest.raises(ValueError, match="even height"):
        tdwt.analyze_level_rows_sharded(list(torch.zeros(16, 4).chunk(4)),
                                        bank, cpu_mesh(4))


def test_lbt_train_step_matches_vcf_tpu(jmesh8):
    """One step over 8 shards, composed as __graft_entry__.py composes
    vcf_tpu's (replicated params, the blocks sharded), on a test image's
    mean-removed blocks.  vcf_tpu's step sums the shards' gradients
    (ROADMAP C14), and so does the port's."""
    img = make_test_image(64, 128, seed=4).astype(np.float32) - 128.0
    blocks = tlbt.blocks_of(torch.from_numpy(img), 8)
    blocks = (blocks - blocks.mean(0)).numpy()
    w0 = tlbt.dct_init(8)
    opt, step = jlbt.train_step_fn(lr=1e-3, coding_lambda=1e-2)
    params_j = {"enc": jnp.asarray(w0), "dec": jnp.asarray(w0.T)}

    @jax.jit
    @functools.partial(shard_map, mesh=jmesh8,
                       in_specs=(P(), P(), P("data")),
                       out_specs=(P(), P(), P()))
    def train_step(params, opt_state, blocks):
        return step(params, opt_state, blocks, axis_names=("data",))

    p_j, _, loss_j = train_step(params_j, opt.init(params_j),
                                jnp.asarray(blocks))
    init, tstep = tlbt.train_step_fn(lr=1e-3, coding_lambda=1e-2)
    params = {"enc": torch.from_numpy(w0),
              "dec": torch.from_numpy(np.ascontiguousarray(w0.T))}
    p, state, loss = tstep(params, init(params),
                           list(torch.from_numpy(blocks).chunk(8)),
                           cpu_mesh(8))
    assert state["count"] == 1
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for k in ("enc", "dec"):
        assert np.abs(p[k].numpy() - params[k].numpy()).max() > 1e-4
        np.testing.assert_allclose(p[k].numpy(), np.asarray(p_j[k]),
                                   rtol=1e-5)
