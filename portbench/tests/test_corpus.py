"""The frozen corpus maker writes the port's encoder's bytes."""

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu_torch.testing import encoder
from portbench import corpus

S420 = ((2, 2), (1, 1), (1, 1))
S444 = ((1, 1), (1, 1), (1, 1))


@pytest.mark.parametrize("h,w,samplings,dri", [
    (48, 64, S420, 0), (48, 64, S420, 4), (37, 53, S420, 0),
    (37, 53, S420, 4), (40, 72, S444, 0), (40, 72, S444, 9),
    (120, 200, S420, 13), (33, 41, S444, 6)])
def test_bytes_equal_the_port_encoder(h, w, samplings, dri):
    """4:2:0 and 4:4:4, no restart interval and one of an MCU row (dri is
    the frame's MCUs across), odd sizes included."""
    gen = torch.Generator()
    gen.manual_seed(h * 1000 + w + dri)
    rgb = corpus.photo(gen, h, w)
    frame = corpus.encode(rgb, samplings, 90, dri)
    blob, planes = encoder.encode(rgb.numpy(), samplings=samplings,
                                  quality=90, restart_interval=dri)
    assert frame.blob == blob
    for got, want in zip(frame.planes, planes):
        np.testing.assert_array_equal(got.numpy(), want)
    mcus = -(-w // (8 * samplings[0][0])) * -(-h // (8 * samplings[0][1]))
    assert frame.segments == (-(-mcus // dri) if dri else 1)


def test_frames_follow_the_seed():
    recipe = {"width": 64, "height": 32, "samplings": S420, "quality": 90,
              "restart_interval": 4}
    a = corpus.make_frames(recipe, 2**31 + 5, 2, "cpu")
    b = corpus.make_frames(recipe, 2**31 + 5, 2, "cpu")
    c = corpus.make_frames(recipe, 2**31 + 6, 2, "cpu")
    assert [f.blob for f in a] == [f.blob for f in b]
    assert a[0].blob != a[1].blob and a[0].blob != c[0].blob
