"""Scanline OpenEXR files in numpy, as far as the benchmark needs them:
the reference reads the scenes' textures (uncompressed, ZIPS or ZIP
blocks; half or float channels), and the benchmark writes the images it
makes itself (uncompressed half RGB).  Written from the OpenEXR file
layout: a magic number and version, a header of named attributes, a
table of block offsets, then each block as (first line, size, data);
ZIP data is zlib's, over bytes that were split into two halves (even
and odd positions) and delta-coded."""

import struct
import zlib

import numpy as np

MAGIC = 20000630
_DTYPES = {1: np.float16, 2: np.float32}
_LINES = {0: 1, 2: 1, 3: 16}  # lines a block: none, ZIPS, ZIP


def _cstr(buf, pos):
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _header(buf):
    if struct.unpack_from("<i", buf, 0)[0] != MAGIC:
        raise ValueError("not an OpenEXR file")
    if buf[5] & 0x1A:  # tiled, deep or multi-part
        raise ValueError("only single-part scanline files are read")
    pos, attrs = 8, {}
    while buf[pos] != 0:
        name, pos = _cstr(buf, pos)
        kind, pos = _cstr(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        attrs[name] = buf[pos + 4:pos + 4 + size]
        pos += 4 + size
    return attrs, pos + 1


def _channels(raw):
    out, pos = [], 0
    while raw[pos] != 0:
        name, pos = _cstr(raw, pos)
        ptype = struct.unpack_from("<i", raw, pos)[0]
        xs, ys = struct.unpack_from("<ii", raw, pos + 8)
        if (xs, ys) != (1, 1) or ptype not in _DTYPES:
            raise ValueError(f"channel {name}: unsupported layout")
        out.append((name, np.dtype(_DTYPES[ptype])))
        pos += 16
    return out


def _unzip(data):
    d = np.frombuffer(zlib.decompress(data), np.uint8).astype(np.int64)
    d[1:] -= 128
    d = (np.cumsum(d) % 256).astype(np.uint8)
    out = np.empty_like(d)
    half = (len(d) + 1) // 2
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def read(path):
    """The R, G and B channels of a scanline EXR file as float32 (h, w,
    3), rows from the top."""
    with open(path, "rb") as f:
        buf = f.read()
    attrs, pos = _header(buf)
    comp = attrs["compression"][0]
    if comp not in _LINES:
        raise ValueError(f"{path}: compression {comp} is not read here")
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    chans = _channels(attrs["channels"])
    lines = _LINES[comp]
    n_blocks = -(-h // lines)
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, pos)
    row_bytes = sum(dt.itemsize for _, dt in chans) * w
    planes = {name: np.empty((h, w), np.float32) for name, _ in chans}
    for off in offsets:
        line, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8:off + 8 + size]
        n = min(lines, y1 - line + 1)
        if size < row_bytes * n:
            data = _unzip(data)
        if len(data) != row_bytes * n:
            raise ValueError(f"{path}: a block of the wrong size")
        at = 0
        for r in range(n):
            for name, dt in chans:  # channels stored by name, a line each
                planes[name][line - y0 + r] = np.frombuffer(
                    data, dt, count=w, offset=at)
                at += dt.itemsize * w
    return np.stack([planes[c] for c in "RGB"], axis=-1)


def write_half_rgb(path, rgb):
    """Write float (h, w, 3) as an uncompressed half-float RGB EXR."""
    half = np.ascontiguousarray(np.asarray(rgb, np.float32).astype(np.float16))
    h, w, _ = half.shape

    def attr(name, kind, data):
        return (name.encode() + b"\x00" + kind.encode() + b"\x00"
                + struct.pack("<i", len(data)) + data)

    chans = b"".join(c + b"\x00" + struct.pack("<i4xii", 1, 1, 1)
                     for c in (b"B", b"G", b"R")) + b"\x00"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (attr("channels", "chlist", chans)
              + attr("compression", "compression", b"\x00")
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\x00")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\x00")
    # each line: B, G, R planes of w halves
    body = np.ascontiguousarray(half[:, :, ::-1].transpose(0, 2, 1))
    row = 3 * 2 * w
    start = 8 + len(header) + 8 * h
    offsets = start + np.arange(h, dtype=np.uint64) * (8 + row)
    lines = np.empty((h, 8 + row), np.uint8)
    lines[:, :4] = np.arange(h, dtype="<i4").view(np.uint8).reshape(h, 4)
    lines[:, 4:8] = np.frombuffer(struct.pack("<i", row), np.uint8)
    lines[:, 8:] = body.view(np.uint8).reshape(h, row)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", MAGIC, 2))
        f.write(header)
        f.write(offsets.astype("<u8").tobytes())
        f.write(lines.tobytes())
