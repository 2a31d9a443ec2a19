"""Image ingestion for the gen-1 image-GAN modes (port of
``gennet_tpu.data.images``; ref: tests/ganymede.py:272-314).

- A directory of images (:func:`load_image_dir`): greyscale, resized to
  n_pix × n_pix, rescaled to [−1, 1], optionally with horizontally flipped
  copies. The readers are tried in the reference's order: PIL (``resize``
  at PIL's default filter), then matplotlib with a nearest-neighbour
  resize. Where neither imports, binary PGM files (P5, 8-bit) are read
  here in numpy, with the same nearest-neighbour resize; the reference
  reads the same files through PIL, which at the file's own size gives the
  same arrays. Any other file then raises ``ImportError``.
- MNIST (:func:`load_mnist_idx`): a dependency-free IDX3 reader over a
  local file.

Both return host numpy arrays: the caller moves them to its device.
"""

import glob
import gzip
import re
import struct

import numpy as np


# a binary PGM header: magic, width, height, maxval, separated by
# whitespace or '#' comments, then one whitespace character
_P5 = re.compile(rb"P5(?:\s|#[^\n]*\n)+(\d+)(?:\s|#[^\n]*\n)+(\d+)(?:\s|#[^\n]*\n)+(\d+)\s")


def _pgm_p5(path: str) -> np.ndarray:
    """An 8-bit binary PGM as float32 (H, W); ``ImportError`` for any
    other file, since only PIL or matplotlib could read it."""
    with open(path, "rb") as fh:
        data = fh.read()
    m = _P5.match(data)
    if m is None or int(m[3]) > 255:
        raise ImportError(
            f"cannot read {path!r}: neither PIL nor matplotlib imports here, and without them "
            f"only binary 8-bit PGM (P5) files are read; install Pillow or matplotlib, or "
            f"convert the images to P5 PGM")
    w, h = int(m[1]), int(m[2])
    return np.frombuffer(data, np.uint8, count=w * h, offset=m.end()).reshape(h, w).astype(
        np.float32)


def _nearest(img: np.ndarray, n_pix: int) -> np.ndarray:
    yi = np.linspace(0, img.shape[0] - 1, n_pix).astype(int)
    xi = np.linspace(0, img.shape[1] - 1, n_pix).astype(int)
    return img[np.ix_(yi, xi)].astype(np.float32)


def _reader(n_pix: int):
    """The first reader that imports: PIL, matplotlib, then the P5 reader."""
    try:
        from PIL import Image

        return lambda p: np.asarray(Image.open(p).convert("L").resize((n_pix, n_pix)),
                                    np.float32)
    except ImportError:
        pass
    try:
        import matplotlib.image as mpimg
    except ImportError:
        return lambda p: _nearest(_pgm_p5(p), n_pix)

    def read(p):
        img = mpimg.imread(p)
        if img.ndim == 3:
            img = img.mean(-1)
        return _nearest(img, n_pix)

    return read


def load_image_dir(pattern: str, n_pix: int = 28, flip: bool = True,
                   limit: int | None = None) -> np.ndarray:
    """Load the images matching ``pattern`` (sorted; the first ``limit``)
    → (N, n_pix, n_pix, 1) float32 in [−1, 1], each followed by its
    horizontal flip when ``flip``. ``FileNotFoundError`` when nothing
    matches."""
    read = _reader(n_pix)
    paths = sorted(glob.glob(pattern))
    if limit:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no images match {pattern!r}")
    out = []
    for p in paths:
        img = read(p)
        lo, hi = img.min(), img.max()
        img = (2 * (img - lo) / max(hi - lo, 1e-9)) - 1.0
        out.append(img)
        if flip:
            out.append(img[:, ::-1])
    return np.asarray(out)[..., None]


def load_mnist_idx(path: str, n_pix: int = 28, limit: int | None = None) -> np.ndarray:
    """Read an MNIST IDX3 image file (optionally .gz) → (N, n_pix, n_pix, 1)
    rescaled to [−1, 1] (the reference's mnist mode, ganymede.py:283-287,
    without the tensorflow dependency). IDX3: big-endian magic 0x00000803,
    N, rows, cols, then uint8 pixels; ``n_pix`` resizes by nearest
    neighbour."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        magic, n, rows, cols = struct.unpack(">IIII", fh.read(16))
        if magic != 0x803:
            raise ValueError(f"{path!r} is not an IDX3 image file (magic {magic:#x})")
        if limit:
            n = min(n, limit)
        data = np.frombuffer(fh.read(n * rows * cols), np.uint8, count=n * rows * cols)
    imgs = data.reshape(n, rows, cols).astype(np.float32)
    if n_pix != rows or n_pix != cols:
        yi = np.linspace(0, rows - 1, n_pix).astype(int)
        xi = np.linspace(0, cols - 1, n_pix).astype(int)
        imgs = imgs[:, np.ix_(yi, xi)[0], np.ix_(yi, xi)[1]]
    return (imgs / 127.5 - 1.0)[..., None]
