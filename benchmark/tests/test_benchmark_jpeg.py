"""The JPEG route's reference against the standard and against the
port's core on the CPU: ``std::mt19937_64``, the core's shuffle, and
Pillow's decode with the core's resize arithmetic."""

import numpy as np
import pytest
from PIL import Image

from reference import jpeg


def test_mt19937_64_is_the_standard_engine():
    rng = jpeg.MT19937_64(5489)  # the default seed
    for _ in range(9999):
        rng()
    assert rng() == 9981545732273789042  # [rand.predef]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpeg")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(12):
        rgb = np.clip(rng.normal(120 + 8 * i, 30, (70, 90, 3)), 0,
                      255).astype(np.uint8)
        path = root / f"{i:02d}.jpg"
        Image.fromarray(rgb).save(path, quality=92, subsampling=2)
        paths.append(str(path))
    return paths


def test_index_stream_is_the_cores(files):
    from endoscopy_tpu_torch.data.native_loader import _Handle

    handle = _Handle(files, 16, 1, 64, 2 ** 40 + 7, shuffle=True)
    try:
        _, got = handle.next(30)  # one worker thread: the stream's order
    finally:
        handle.close()
    assert got.tolist() == jpeg.index_stream(len(files), 2 ** 40 + 7,
                                             30).tolist()


@pytest.mark.parametrize("size", [16, 38, 134])
def test_pillow_decode_and_resize_are_the_cores_pixels(files, size):
    from endoscopy_tpu_torch.data.native_loader import decode_files

    core = decode_files(files, size, device="cpu")
    ref = np.stack([jpeg.resize(jpeg.decode(p), size) for p in files])
    assert np.array_equal(core, ref)


def test_taps_of_336_to_134():
    assert jpeg.taps(336, 134) == 268
