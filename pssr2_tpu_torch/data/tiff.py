"""Minimal, dependency-free TIFF codec (numpy only); counterpart:
pssr2_tpu/data/tiff.py without its native C++ fast path, which the port
has not taken over yet.

The reference reads/writes tiles with ``tifffile`` (reference:
pssr/data.py:566-577, pssr/predict.py:71); that package is not part of this
framework's environment, so we implement the subset PSSR workflows need:

- read: classic TIFF, little/big endian, uncompressed strips, grayscale
  uint8/uint16/float32, multi-page stacks -> (N, H, W) arrays.
  Falls back to PIL for anything else (compressed, RGB, ...).
- write: uncompressed single-strip pages, one page per 2-D plane.

Only grayscale single-sample data is produced, matching the reference's
mode="L" convention (pssr/data.py:66).
"""

import struct

import numpy as np

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8,
               13: 4, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d", 13: "I",
             16: "Q", 17: "q", 18: "Q"}


def _read_ifd_entries(data, offset, endian, big=False):
    """Parse one IFD.  ``big=True`` uses the BigTIFF layout (8-byte counts,
    20-byte entries, 8-byte inline values and next-IFD pointer)."""
    if big:
        (count,) = struct.unpack_from(endian + "Q", data, offset)
        pos = offset + 8
        entry_size, n_fmt, inline = 20, "Q", 8
    else:
        (count,) = struct.unpack_from(endian + "H", data, offset)
        pos = offset + 2
        entry_size, n_fmt, inline = 12, "I", 4
    entries = {}
    for _ in range(count):
        tag, typ = struct.unpack_from(endian + "HH", data, pos)
        (n,) = struct.unpack_from(endian + n_fmt, data, pos + 4)
        size = _TYPE_SIZES.get(typ, 1) * n
        value_pos = pos + 4 + struct.calcsize(n_fmt)
        if size <= inline:
            raw = data[value_pos : value_pos + size]
        else:
            (ptr,) = struct.unpack_from(endian + n_fmt, data, value_pos)
            raw = data[ptr : ptr + size]
        if typ in _TYPE_FMT:
            vals = struct.unpack(endian + _TYPE_FMT[typ] * n, raw)
        elif typ == 5 or typ == 10:  # rational
            ints = struct.unpack(endian + ("I" if typ == 5 else "i") * (2 * n), raw)
            vals = tuple(a / b if b else 0 for a, b in zip(ints[::2], ints[1::2]))
        else:
            vals = (raw,)
        entries[tag] = vals
        pos += entry_size
    (next_ifd,) = struct.unpack_from(endian + n_fmt, data, pos)
    return entries, next_ifd


def _decode_page(data, tags, endian):
    width = tags[256][0]
    height = tags[257][0]
    bits = tags.get(258, (8,))[0]
    compression = tags.get(259, (1,))[0]
    spp = tags.get(277, (1,))[0]
    sample_format = tags.get(339, (1,))[0]
    if compression != 1 or spp != 1:
        raise NotImplementedError(
            f"tiff: unsupported compression={compression} samples={spp}"
        )
    if sample_format == 3:
        dtype = {32: "f4", 64: "f8"}[bits]
    elif sample_format == 2:
        dtype = {8: "i1", 16: "i2", 32: "i4"}[bits]
    else:
        dtype = {8: "u1", 16: "u2", 32: "u4"}[bits]
    dt = np.dtype(("<" if endian == "<" else ">") + dtype)

    offsets = tags[273]
    counts = tags[279]
    buf = b"".join(data[o : o + c] for o, c in zip(offsets, counts))
    arr = np.frombuffer(buf, dtype=dt, count=width * height)
    return arr.reshape(height, width)


def _parse_header(data, endian, path):
    """-> (is_bigtiff, first_ifd_offset).  Magic 42 = classic, 43 = BigTIFF
    (8-byte offsets; tifffile writes these for >4GB stacks, which the
    reference reads transparently — reference: pssr/data.py:566-577)."""
    (magic,) = struct.unpack_from(endian + "H", data, 2)
    if magic == 42:
        (ifd,) = struct.unpack_from(endian + "I", data, 4)
        return False, ifd
    if magic == 43:
        offsize, zero = struct.unpack_from(endian + "HH", data, 4)
        if offsize != 8 or zero != 0:
            raise ValueError(f"{path}: malformed BigTIFF header")
        (ifd,) = struct.unpack_from(endian + "Q", data, 8)
        return True, ifd
    raise ValueError(f"{path}: not a TIFF (magic={magic})")


def imread(path) -> np.ndarray:
    """Read a (possibly multi-page) TIFF into a 2-D or 3-D numpy array:
    the pure-Python strip reader, then PIL for what it does not decode."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"II":
        endian = "<"
    elif data[:2] == b"MM":
        endian = ">"
    else:
        raise ValueError(f"{path}: not a TIFF file")
    big, ifd = _parse_header(data, endian, path)

    pages = []
    try:
        while ifd:
            tags, ifd = _read_ifd_entries(data, ifd, endian, big)
            pages.append(_decode_page(data, tags, endian))
    except (NotImplementedError, KeyError):
        return _imread_pil(path)

    if len(pages) == 1:
        return pages[0]
    return np.stack(pages)


def _imread_pil(path) -> np.ndarray:
    from PIL import Image

    image = Image.open(path)
    frames = []
    for frame in range(getattr(image, "n_frames", 1)):
        image.seek(frame)
        frames.append(np.asarray(image))
    return frames[0] if len(frames) == 1 else np.stack(frames)


def num_pages_and_size(path):
    """Fast metadata probe: (n_pages, (height, width)) without decoding pixels.

    Replaces the reference's per-file PIL open pass at dataset init
    (reference: pssr/data.py:70-74) with a tag-only scan.
    """
    with open(path, "rb") as f:
        data = f.read(8)
        endian = "<" if data[:2] == b"II" else ">"
        f.seek(0)
        data = f.read()
    big, ifd = _parse_header(data, endian, path)
    n, size = 0, (0, 0)
    while ifd:
        tags, ifd = _read_ifd_entries(data, ifd, endian, big)
        if n == 0:
            size = (tags[257][0], tags[256][0])
        n += 1
    return n, size


def imwrite(path, image: np.ndarray, bigtiff: bool = None):
    """Write a 2-D plane or 3-D stack as uncompressed little-endian TIFF.

    ``bigtiff`` forces the BigTIFF (magic 43, 8-byte offsets) layout;
    default None auto-selects it when the data exceeds the 4 GB classic
    limit."""
    image = np.asarray(image)
    if image.dtype == np.float64:
        image = image.astype(np.float32)
    if bigtiff is None:
        bigtiff = image.nbytes + 65536 > 2**32
    if bigtiff:
        return _imwrite_bigtiff(path, image)
    if image.ndim == 2:
        planes = image[np.newaxis]
    elif image.ndim == 3:
        planes = image
    else:
        raise ValueError(f"tiff: cannot write array of shape {image.shape}")

    if planes.dtype == np.float64:
        planes = planes.astype(np.float32)
    dt = planes.dtype
    if dt == np.uint8:
        bits, sample_format = 8, 1
    elif dt == np.uint16:
        bits, sample_format = 16, 1
    elif dt == np.int16:
        bits, sample_format = 16, 2
    elif dt == np.float32:
        bits, sample_format = 32, 3
    else:
        raise ValueError(f"tiff: unsupported dtype {dt}")

    n, height, width = planes.shape
    out = bytearray()
    out += b"II*\x00"
    out += struct.pack("<I", 8)  # first IFD right after header

    n_entries = 10
    ifd_size = 2 + n_entries * 12 + 4
    data_start = 8 + n * ifd_size

    def entry(tag, typ, count, value):
        return struct.pack("<HHII", tag, typ, count, value)

    strip_size = height * width * (bits // 8)
    for i in range(n):
        strip_offset = data_start + i * strip_size
        next_ifd = 8 + (i + 1) * ifd_size if i + 1 < n else 0
        out += struct.pack("<H", n_entries)
        out += entry(256, 4, 1, width)
        out += entry(257, 4, 1, height)
        out += entry(258, 3, 1, bits)
        out += entry(259, 3, 1, 1)  # no compression
        out += entry(262, 3, 1, 1)  # BlackIsZero
        out += entry(273, 4, 1, strip_offset)
        out += entry(277, 3, 1, 1)  # one sample per pixel
        out += entry(278, 4, 1, height)  # rows per strip
        out += entry(279, 4, 1, strip_size)
        out += entry(339, 3, 1, sample_format)
        out += struct.pack("<I", next_ifd)

    for plane in planes:
        out += plane.astype(plane.dtype.newbyteorder("<"), copy=False).tobytes()

    with open(path, "wb") as f:
        f.write(bytes(out))


def _sample_layout(dt):
    if dt == np.uint8:
        return 8, 1
    if dt == np.uint16:
        return 16, 1
    if dt == np.int16:
        return 16, 2
    if dt == np.float32:
        return 32, 3
    raise ValueError(f"tiff: unsupported dtype {dt}")


def _imwrite_bigtiff(path, image: np.ndarray):
    """Uncompressed little-endian BigTIFF (magic 43): 8-byte IFD offsets and
    strip offsets/counts, so stacks past the classic 4 GB limit round-trip."""
    planes = image[np.newaxis] if image.ndim == 2 else image
    if planes.ndim != 3:
        raise ValueError(f"tiff: cannot write array of shape {image.shape}")
    bits, sample_format = _sample_layout(planes.dtype)

    n, height, width = planes.shape
    n_entries = 10
    ifd_size = 8 + n_entries * 20 + 8
    data_start = 16 + n * ifd_size
    strip_size = height * width * (bits // 8)

    def entry(tag, typ, count, value):
        return struct.pack("<HHQQ", tag, typ, count, value)

    with open(path, "wb") as f:
        f.write(b"II+\x00" + struct.pack("<HHQ", 8, 0, 16))
        for i in range(n):
            strip_offset = data_start + i * strip_size
            next_ifd = 16 + (i + 1) * ifd_size if i + 1 < n else 0
            f.write(struct.pack("<Q", n_entries))
            f.write(entry(256, 4, 1, width))
            f.write(entry(257, 4, 1, height))
            f.write(entry(258, 3, 1, bits))
            f.write(entry(259, 3, 1, 1))  # no compression
            f.write(entry(262, 3, 1, 1))  # BlackIsZero
            f.write(entry(273, 16, 1, strip_offset))  # LONG8
            f.write(entry(277, 3, 1, 1))
            f.write(entry(278, 4, 1, height))
            f.write(entry(279, 16, 1, strip_size))  # LONG8
            f.write(entry(339, 3, 1, sample_format))
            f.write(struct.pack("<Q", next_ifd))
        for plane in planes:
            f.write(plane.astype(plane.dtype.newbyteorder("<"), copy=False).tobytes())
