"""Write the JPEG fixture of the card's decode check.

    python tools/torch_port/make_jpeg_fixture.py [--out DIR]

``DIR`` (default ``tests/torch_port_checks/jpeg_fixture/``) gets the
JPEGs of :data:`FILES`, a PNG named ``.jpg`` and ``expected.npz``: the
libjpeg core's ``decode_files`` pixels of every JPEG at 134 px
(``libjpeg_134``) and cv2's ``decode_canonical`` pixels of :data:`CV2_FILES`
at 224 px (``cv2_224``). ``chip_smoke.py`` (path O1) holds the card's
nvJPEG decode against them; ``tests/torch_port_checks/native.py`` holds
them against the JAX package's native loader and ``decode_canonical``, so
that the stored pixels cannot drift.

The JPEGs are made on the host that runs this script, with the port's
libjpeg core (``data/native_loader.py::write_jpeg``: quality 92, 4:2:0,
as the generator writes them) and cv2 (the 4:4:4, grayscale and quality-95
files, the last as ``cli/preprocess.py`` writes them). It needs the port's
core (g++ and libjpeg) and cv2.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "tests" / "torch_port_checks" / "jpeg_fixture"
# name: what it is
FILES = {
    "gen_420_q92_160.jpg": "the generator's: libjpeg, 4:2:0, quality 92, 160 px",
    "cv2_444_q92_160.jpg": "cv2, 4:4:4, quality 92, 160 px",
    "cv2_gray_q92_144.jpg": "cv2, one grayscale component, 144 px",
    "odd_420_q92_161x127.jpg": "libjpeg, 4:2:0, quality 92, 161 x 127 px",
    "cv2_q95_336.jpg": "cv2 quality 95 after preprocess_image (crop, 336 px)",
}
CV2_FILES = ("gen_420_q92_160.jpg", "cv2_q95_336.jpg")
PNG_NAMED_JPG = "png_named.jpg"
SIDE, SERVE_SIDE = 134, 224


def _frame(rng: np.random.Generator) -> np.ndarray:
    """A 400 x 480 RGB endoscope-like frame: a lit disk with a smooth
    texture inside a black border (what ``preprocess_image`` crops)."""
    h, w = 400, 480
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = np.sqrt((yy - 200) ** 2 + (xx - 250) ** 2)
    base = np.stack([170 + 50 * np.sin(xx / 23.0),
                     90 + 40 * np.cos(yy / 17.0),
                     80 + 30 * np.sin((xx + yy) / 31.0)], -1)
    img = base + rng.normal(0.0, 6.0, (h, w, 3))
    img *= (r < 170)[..., None]
    return np.clip(img, 0, 255).astype(np.uint8)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=OUT)
    args = parser.parse_args(argv)

    import cv2

    from endoscopy_tpu_torch.data import native_loader
    from endoscopy_tpu_torch.data.pipeline import decode_canonical
    from endoscopy_tpu_torch.data.preprocess import preprocess_image
    from endoscopy_tpu_torch.data.synthetic import _class_image

    out = args.out
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    native_loader.write_jpeg(str(out / "gen_420_q92_160.jpg"),
                             _class_image(rng, 2, 160))
    bgr = cv2.cvtColor(_class_image(rng, 4, 160), cv2.COLOR_RGB2BGR)
    cv2.imwrite(str(out / "cv2_444_q92_160.jpg"), bgr,
                [cv2.IMWRITE_JPEG_QUALITY, 92, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    gray = cv2.cvtColor(_class_image(rng, 1, 144), cv2.COLOR_RGB2GRAY)
    cv2.imwrite(str(out / "cv2_gray_q92_144.jpg"), gray,
                [cv2.IMWRITE_JPEG_QUALITY, 92])
    native_loader.write_jpeg(str(out / "odd_420_q92_161x127.jpg"),
                             _class_image(rng, 5, 161)[:, 17:144])
    rgb = preprocess_image(_frame(rng), min_edge=336)
    cv2.imwrite(str(out / "cv2_q95_336.jpg"),
                cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                [cv2.IMWRITE_JPEG_QUALITY, 95])
    ok, png = cv2.imencode(".png", _class_image(rng, 0, 16))
    assert ok
    (out / PNG_NAMED_JPG).write_bytes(png.tobytes())

    paths = [str(out / f) for f in FILES]
    libjpeg = native_loader.decode_files(paths, SIDE, device="cpu")
    served = np.stack([decode_canonical(str(out / f), SERVE_SIDE)
                       for f in CV2_FILES])
    np.savez_compressed(out / "expected.npz", libjpeg_134=libjpeg,
                        cv2_224=served)
    total = sum(os.path.getsize(p) for p in out.iterdir())
    print(f"wrote {len(FILES) + 2} files to {out}: {total} bytes")


if __name__ == "__main__":
    main()
