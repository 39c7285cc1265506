"""The luma wrapper `ops.cuda.luma_kernel` on the CPU: its plain route
against `ops.motion.to_luma`, bit for bit, in every layout the planar IPP
loop hands it (the planar reference frame, a frame of the (G, T, H, W, 3)
u8 clip, the loop's channels-last float32 frames), with and without the
round on half-integer inputs; the mode its kernel would take
(`launch_mode`, the Python mirror of `vcf_luma_mode`, which the card
tests hold equal); no launch on the CPU; and its refusals.  The kernel
itself runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from vcf_tpu_torch import CodecConfig, video
from vcf_tpu_torch.config import VideoConfig
from vcf_tpu_torch.io import test_video as make_test_video
from vcf_tpu_torch.ops import motion
from vcf_tpu_torch.ops.cuda import luma_kernel as lk

G, T, H, W = 2, 3, 8, 48


def _clip(seed=1, h=H, w=W):
    """(G, T, H, W, 3) u8 pixels, every value 0..255 present."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (G, T, h, w, 3),
                                         dtype=np.uint8))


def _half_integers(shape, seed=2):
    """float32 pixels on a half-integer grid, ties of the round included,
    a few below 0 and above 255."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.integers(-6, 2 * 255 + 6, shape) / 2).astype(np.float32))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


# each case: (tensor, channel axis, what the kernel's mode would be)
def _layouts():
    clip = _clip()
    planar = clip.permute(0, 1, 4, 2, 3).contiguous()      # (G, T, 3, H, W)
    loop_frames = clip.permute(0, 1, 4, 2, 3).to(torch.float32)
    return {
        "u8 clip frame gops[:, t]": (clip[:, 1], -1, "channels_last"),
        "u8 channels-last": (clip[:, 1].contiguous(), -1, "channels_last"),
        "u8 planar frame": (planar[:, 2], -3, "planar"),
        "f32 planar (the loop's ref)": (planar[:, 1].to(torch.float32), -3,
                                        "planar"),
        "f32 loop frame frames[:, t]": (loop_frames[:, 2], -3,
                                        "channels_last"),
        "f32 channels-last view": (clip.to(torch.float32)[:, 0], -1,
                                   "channels_last"),
        "f32 half-integers planar": (_half_integers((G, 3, H, W)), -3,
                                     "planar"),
        "f32 half-integers channels-last": (_half_integers((G, H, W, 3)), -1,
                                            "channels_last"),
    }


LAYOUTS = list(_layouts())


@pytest.mark.parametrize("round_", [False, True])
@pytest.mark.parametrize("name", LAYOUTS)
def test_plain_route_equals_to_luma(name, round_):
    x, axis, _ = _layouts()[name]
    got = lk.luma(x, axis, round=round_)
    want = motion.to_luma(torch.round(x) if round_ and x.is_floating_point()
                          else x, channel_axis=axis)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.shape == (G, H, W)
    assert torch.equal(_bits(got), _bits(want))


def test_round_is_half_to_even_before_the_chain():
    """round(x) for float inputs, a no-op for u8: the luma of the rounded
    pixels, and the u8 frame's luma equals its float32 copy's."""
    x = torch.tensor([[[0.5, 1.5, 2.5]], [[-0.5, 254.5, 255.5]]])
    got = lk.luma(x, -1, round=True)
    want = motion.to_luma(torch.tensor([[[0.0, 2.0, 2.0]],
                                        [[-0.0, 254.0, 256.0]]]))
    assert torch.equal(_bits(got), _bits(want))
    u8 = _clip()[:, 0]
    assert torch.equal(_bits(lk.luma(u8, -1, round=True)),
                       _bits(lk.luma(u8.to(torch.float32), -1)))


@pytest.mark.parametrize("name", LAYOUTS)
def test_launch_mode_of_the_loop_layouts(name):
    x, axis, mode = _layouts()[name]
    xs, strides = lk.frames_of(x, axis)
    assert xs.data_ptr() == x.data_ptr()          # a view: nothing copied
    assert lk.launch_mode(xs.data_ptr(), x.dtype, xs.shape[:3],
                          strides) == mode


def test_launch_mode_scalar_cases():
    clip = _clip(w=42)                             # 42 % 4 != 0
    cases = {
        "u8 width not a multiple of 4": (clip[:, 0], -1),
        "u8 three bytes off alignment": (torch.zeros(G * H * W * 3 + 3,
                                                     dtype=torch.uint8)[3:]
                                         .view(G, H, W, 3), -1),
        "f32 width 46": (torch.zeros(G, 3, H, 46), -3),
        "f32 one element off alignment": (torch.zeros(G * 3 * H * W + 1)[1:]
                                          .view(G, 3, H, W), -3),
        "f32 channel stride off 16 bytes": (
            torch.zeros(G * 1156).as_strided((G, 3, H, W),
                                             (1156, H * W + 1, W, 1)), -3),
        "f32 pixel stride 6": (torch.zeros(G, H, W, 6)[..., ::2], -1),
        "f32 rows of 4 + 1 floats": (torch.zeros(G, 3, H, W + 1)[..., :W],
                                     -3),
    }
    for name, (x, axis) in cases.items():
        xs, strides = lk.frames_of(x, axis)
        assert lk.launch_mode(xs.data_ptr(), x.dtype, xs.shape[:3],
                              strides) == "scalar", name
        assert torch.equal(_bits(lk.luma(x, axis)),
                           _bits(motion.to_luma(x, axis))), name


def test_frames_of_shapes_and_strides():
    """Leading axes merge into G, axes of size 1 read stride 0, and the
    output takes the input's shape without the channel axis."""
    x = torch.zeros(2, 4, 3, 8, 16)
    xs, strides = lk.frames_of(x, 2)
    assert xs.shape == (8, 8, 16, 3)
    assert strides == (3 * 8 * 16, 8 * 16, 16, 1)
    xs, strides = lk.frames_of(torch.zeros(8, 16, 3), -1)
    assert xs.shape == (1, 8, 16, 3) and strides == (0, 1, 48, 3)
    for shape, axis, out in (((3, 8, 16), 0, (8, 16)),
                             ((8, 3, 16), -2, (8, 16)),
                             ((16, 3), -1, (16,)),
                             ((2, 4, 3, 8, 16), 2, (2, 4, 8, 16))):
        x = _half_integers(shape)
        got = lk.luma(x, axis)
        assert got.shape == out and got.is_contiguous()
        assert torch.equal(_bits(got), _bits(motion.to_luma(x, axis)))


def test_no_launch_on_the_cpu():
    before = (lk.luma.launches, lk.luma.generic_launches)
    for name in LAYOUTS:
        x, axis, _ = _layouts()[name]
        lk.luma(x, axis, round=True)
    frames = make_test_video(3, 32, 48)
    codec = video.get(VideoConfig(mode="ipp", n_frames=3, gop_size=3),
                      CodecConfig(entropy="grans"), "cpu")
    codec._gop_encode_grid_batch(torch.from_numpy(frames)[None])
    assert (lk.luma.launches, lk.luma.generic_launches) == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16,
                                   torch.int32, torch.int16])
def test_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError, match="float32 or uint8"):
        lk.luma(torch.zeros(2, 4, 4, 3, dtype=dtype))


@pytest.mark.parametrize("shape,axis", [((2, 4, 4, 4), -1), ((2, 2, 4, 4), -3),
                                        ((4, 4, 3), 0), ((3, 5), -1)])
def test_refuses_a_channel_axis_not_of_3(shape, axis):
    with pytest.raises(ValueError, match="not 3 channels"):
        lk.luma(torch.zeros(shape), axis)


def test_refuses_another_device():
    with pytest.raises(ValueError, match="no kernel for device"):
        lk.luma(torch.zeros(2, 3, 4, 4, device="meta"), -3)
