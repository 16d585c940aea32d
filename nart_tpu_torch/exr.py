"""EXR image I/O in numpy: scanline reader for NONE/RLE/ZIPS/ZIP/PIZ and a
ZIPS writer.

Counterpart of ``nart_tpu/exr.py``'s pure-Python codec (``_py_read``,
``_py_write``).  The JAX package reads PIZ through a ctypes binding to the
system OpenEXR library; this package must run where that library is not
installed, so PIZ is decoded here: Huffman-decode the block's 16-bit words,
undo the 2D Haar wavelet per channel, map them back through the bitmap's
reverse look-up table, then interleave the channel planes into scanlines
(the algorithm of OpenEXR's PIZ compressor, written from its description).

``read`` returns float32 (h, w, 4) RGBA; ``write`` stores half RGBA, ZIPS.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 0x01312F76
_PIXEL_TYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
# scanlines per block: none, rle, zips, zip, piz
_SCANLINES_PER_BLOCK = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32}
_PIZ = 4


def _read_cstr(f):
    out = b""
    while True:
        c = f.read(1)
        if c in (b"\x00", b""):
            return out.decode("latin-1")
        out += c


def _parse_header(f):
    attrs = {}
    while True:
        name = _read_cstr(f)
        if name == "":
            return attrs
        typ = _read_cstr(f)
        (size,) = struct.unpack("<i", f.read(4))
        attrs[name] = (typ, f.read(size))


def _parse_channels(data):
    chans = []
    i = 0
    while data[i] != 0:
        j = data.index(b"\x00", i)
        name = data[i:j].decode("latin-1")
        ptype, xs, ys = struct.unpack("<i4xii", data[j + 1 : j + 17])
        chans.append((name, ptype, xs, ys))
        i = j + 17
    return chans


def _predictor_undo(d):
    # zip/rle post-filter: delta-decode (x[i] = x[i-1] + d[i] - 128), then
    # merge the two byte planes (even positions | odd positions)
    d = np.frombuffer(d, np.uint8).astype(np.int64)
    n = len(d)
    d = ((np.cumsum(d) - 128 * np.arange(n)) % 256).astype(np.uint8)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half : half + n // 2]
    return out.tobytes()


def _predictor_apply(raw):
    d = np.frombuffer(raw, np.uint8)
    inter = np.concatenate([d[0::2], d[1::2]]).astype(np.int64)
    delta = np.empty(len(d), np.int64)
    delta[0] = inter[0]
    delta[1:] = inter[1:] - inter[:-1] + 128 + 256
    return (delta % 256).astype(np.uint8).tobytes()


def _rle_decode(data):
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        count = struct.unpack("<b", data[i : i + 1])[0]
        if count < 0:
            out += data[i + 1 : i + 1 - count]
            i += 1 - count
        else:
            out += data[i + 1 : i + 2] * (count + 1)
            i += 2
    return bytes(out)


# ---------------------------------------------------------------------------
# PIZ: Huffman coding of 16-bit words
# ---------------------------------------------------------------------------

_HUF_ENCSIZE = (1 << 16) + 1
_HUF_DECBITS = 14
_HUF_DECMASK = (1 << _HUF_DECBITS) - 1
_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN


def _huf_unpack_enc_table(data, pos, im, i_max):
    """Code lengths of symbols im..i_max (6 bits each, with zero-run
    escapes), then canonical codes.  Returns (hcode, pos after table) where
    hcode[i] = length | (code << 6)."""
    lengths = np.zeros(_HUF_ENCSIZE, np.int64)
    c = 0
    lc = 0

    def bits(n):
        nonlocal c, lc, pos
        while lc < n:
            c = ((c << 8) | data[pos]) & 0xFFFFFFFF
            pos += 1
            lc += 8
        lc -= n
        return (c >> lc) & ((1 << n) - 1)

    i = im
    while i <= i_max:
        ln = bits(6)
        if ln == _LONG_ZEROCODE_RUN:
            run = bits(8) + _SHORTEST_LONG_RUN
            if i + run > i_max + 1:
                raise ValueError("EXR PIZ: Huffman table too long")
            i += run  # lengths already zero
            continue
        if ln >= _SHORT_ZEROCODE_RUN:
            run = ln - _SHORT_ZEROCODE_RUN + 2
            if i + run > i_max + 1:
                raise ValueError("EXR PIZ: Huffman table too long")
            i += run
            continue
        lengths[i] = ln
        i += 1

    # canonical code assignment: longest codes get the smallest values
    n = np.bincount(lengths, minlength=59)[:59].astype(np.int64)
    start = np.zeros(59, np.int64)
    c = 0
    for ln in range(58, 0, -1):
        nc = (c + int(n[ln])) >> 1
        start[ln] = c
        c = nc
    hcode = np.zeros(_HUF_ENCSIZE, np.int64)
    nz = np.nonzero(lengths > 0)[0]
    ln_nz = lengths[nz]
    # codes of one length increase with the symbol index
    order = np.argsort(ln_nz, kind="stable")
    ln_sorted = ln_nz[order]
    first = np.searchsorted(ln_sorted, ln_sorted, side="left")
    rank = np.arange(len(ln_sorted)) - first
    codes = np.empty(len(nz), np.int64)
    codes[order] = start[ln_sorted] + rank
    hcode[nz] = ln_nz | (codes << 6)
    return hcode, pos


def _huf_decode(data, pos, n_bits, hcode, im, i_max, n_raw):
    """Decode n_bits of canonical-Huffman data into n_raw 16-bit words.

    Symbol i_max is the run-length code: it is followed by an 8-bit count of
    repeats of the previous word."""
    dec_len = np.zeros(1 << _HUF_DECBITS, np.int64)
    dec_lit = np.zeros(1 << _HUF_DECBITS, np.int64)
    long_codes = {}
    for sym in range(im, i_max + 1):
        hc = int(hcode[sym])
        ln = hc & 63
        code = hc >> 6
        if ln == 0:
            continue
        if code >> ln:
            raise ValueError("EXR PIZ: invalid Huffman table entry")
        if ln > _HUF_DECBITS:
            long_codes.setdefault(code >> (ln - _HUF_DECBITS), []).append(
                (ln, code, sym)
            )
        else:
            lo = code << (_HUF_DECBITS - ln)
            hi = lo + (1 << (_HUF_DECBITS - ln))
            if dec_len[lo:hi].any():
                raise ValueError("EXR PIZ: invalid Huffman table entry")
            dec_len[lo:hi] = ln
            dec_lit[lo:hi] = sym
    dec_len = dec_len.tolist()
    dec_lit = dec_lit.tolist()

    out = [0] * n_raw
    n_out = 0
    c = 0
    lc = 0
    end = pos + (n_bits + 7) // 8
    rlc = i_max

    def emit(sym):
        nonlocal c, lc, pos, n_out
        if sym == rlc:
            if lc < 8:
                c = (c << 8) | data[pos]
                pos += 1
                lc += 8
            lc -= 8
            cs = (c >> lc) & 0xFF
            c &= (1 << lc) - 1
            if n_out + cs > n_raw or n_out == 0:
                raise ValueError("EXR PIZ: bad run length")
            s = out[n_out - 1]
            out[n_out : n_out + cs] = [s] * cs
            n_out += cs
        else:
            if n_out >= n_raw:
                raise ValueError("EXR PIZ: too much data")
            out[n_out] = sym
            n_out += 1

    while pos < end:
        c = (c << 8) | data[pos]
        pos += 1
        lc += 8
        while lc >= _HUF_DECBITS:
            k = (c >> (lc - _HUF_DECBITS)) & _HUF_DECMASK
            ln = dec_len[k]
            if ln:
                lc -= ln
                c &= (1 << lc) - 1
                emit(dec_lit[k])
                continue
            for ln, code, sym in long_codes.get(k, ()):
                while lc < ln and pos < end:
                    c = (c << 8) | data[pos]
                    pos += 1
                    lc += 8
                if lc >= ln and ((c >> (lc - ln)) & ((1 << ln) - 1)) == code:
                    lc -= ln
                    c &= (1 << lc) - 1
                    emit(sym)
                    break
            else:
                raise ValueError("EXR PIZ: invalid Huffman code")
    # the last byte holds (8 - n_bits) & 7 padding bits
    i = (8 - n_bits) & 7
    c >>= i
    lc -= i
    while lc > 0:
        k = (c << (_HUF_DECBITS - lc)) & _HUF_DECMASK
        ln = dec_len[k]
        if not ln:
            raise ValueError("EXR PIZ: invalid Huffman code")
        lc -= ln
        c &= (1 << lc) - 1 if lc > 0 else 0
        emit(dec_lit[k])
    if n_out != n_raw:
        raise ValueError("EXR PIZ: not enough data")
    return np.asarray(out, np.int64)


def _huf_uncompress(data, n_raw):
    if len(data) == 0:
        if n_raw:
            raise ValueError("EXR PIZ: not enough data")
        return np.zeros(0, np.int64)
    im, i_max, _table_len, n_bits = struct.unpack("<4i", data[:16])
    if not (0 <= im < _HUF_ENCSIZE and 0 <= i_max < _HUF_ENCSIZE):
        raise ValueError("EXR PIZ: invalid Huffman table size")
    hcode, pos = _huf_unpack_enc_table(data, 20, im, i_max)
    if n_bits > 8 * (len(data) - pos):
        raise ValueError("EXR PIZ: invalid number of bits")
    return _huf_decode(data, pos, n_bits, hcode, im, i_max, n_raw)


# ---------------------------------------------------------------------------
# PIZ: 2D Haar wavelet (14-bit and 16-bit lifting variants)
# ---------------------------------------------------------------------------


def _wdec14(l, h):
    ls = ((l + 0x8000) & 0xFFFF) - 0x8000  # as int16
    hs = ((h + 0x8000) & 0xFFFF) - 0x8000
    ai = ls + (hs & 1) + (hs >> 1)
    return ai & 0xFFFF, (ai - hs) & 0xFFFF


def _wdec16(l, h):
    bb = (l - (h >> 1)) & 0xFFFF
    aa = (h + bb - 0x8000) & 0xFFFF
    return aa, bb


def _wav2_decode(a, max_value):
    """In-place inverse 2D Haar transform of one (ny, nx) int64 plane."""
    ny, nx = a.shape
    dec = _wdec14 if max_value < (1 << 14) else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        cy = (ny - p2) // p2 + 1 if ny >= p2 else 0
        cx = (nx - p2) // p2 + 1 if nx >= p2 else 0
        ey, ex = cy * p2, cx * p2
        if cy and cx:
            s00 = (slice(0, ey, p2), slice(0, ex, p2))
            s01 = (slice(0, ey, p2), slice(p, ex, p2))
            s10 = (slice(p, ey, p2), slice(0, ex, p2))
            s11 = (slice(p, ey, p2), slice(p, ex, p2))
            i00, i10 = dec(a[s00], a[s10])
            i01, i11 = dec(a[s01], a[s11])
            a[s00], a[s01] = dec(i00, i01)
            a[s10], a[s11] = dec(i10, i11)
        if cy and (nx & p):  # odd column
            s0 = (slice(0, ey, p2), ex)
            s1 = (slice(p, ey, p2), ex)
            a[s0], a[s1] = dec(a[s0], a[s1])
        if cx and (ny & p):  # odd line
            s0 = (ey, slice(0, ex, p2))
            s1 = (ey, slice(p, ex, p2))
            a[s0], a[s1] = dec(a[s0], a[s1])
        p2 = p
        p >>= 1


def _piz_uncompress(data, chans, w, rows):
    """One PIZ block -> raw little-endian scanline bytes (channels
    interleaved per line, like the uncompressed layout)."""
    min_nz, max_nz = struct.unpack("<HH", data[:4])
    pos = 4
    bitmap = np.zeros(8192, np.uint8)
    if max_nz >= 8192:
        raise ValueError("EXR PIZ: bad bitmap range")
    if min_nz <= max_nz:
        nb = max_nz - min_nz + 1
        bitmap[min_nz : min_nz + nb] = np.frombuffer(data, np.uint8, nb, pos)
        pos += nb
    bits = np.unpackbits(bitmap, bitorder="little").astype(bool)
    bits[0] = True  # zero is always representable
    lut = np.nonzero(bits)[0].astype(np.int64)
    max_value = len(lut) - 1
    (length,) = struct.unpack("<i", data[pos : pos + 4])
    pos += 4
    sizes = [np.dtype(_PIXEL_TYPES[pt]).itemsize // 2 for _, pt, _, _ in chans]
    n_raw = sum(w * rows * s for s in sizes)
    words = _huf_uncompress(data[pos : pos + length], n_raw)
    planes = []
    off = 0
    for s in sizes:
        plane = words[off : off + w * rows * s].reshape(rows, w, s).copy()
        off += w * rows * s
        for j in range(s):
            comp = np.ascontiguousarray(plane[:, :, j])
            _wav2_decode(comp, max_value)
            plane[:, :, j] = comp
        planes.append(lut[plane].astype(np.uint16))
    # interleave: line y holds each channel's row in channel order
    lines = [
        np.concatenate([pl[y].reshape(-1) for pl in planes]) for y in range(rows)
    ]
    return np.concatenate(lines).astype("<u2").tobytes()


def read(path):
    """Read a scanline EXR into float32 (h, w, 4) RGBA (A = 1 if absent)."""
    with open(path, "rb") as f:
        (magic,) = struct.unpack("<I", f.read(4))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an EXR file")
        version = f.read(4)
        if version[1] & 0x1A:
            raise NotImplementedError("tiled/deep/multipart EXR not supported")
        attrs = _parse_header(f)
        comp = attrs["compression"][1][0]
        if comp not in _SCANLINES_PER_BLOCK:
            raise NotImplementedError(f"EXR compression {comp} not supported")
        xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
        w, h = xmax - xmin + 1, ymax - ymin + 1
        chans = _parse_channels(attrs["channels"][1])
        if any(xs != 1 or ys != 1 for _, _, xs, ys in chans):
            raise NotImplementedError("subsampled EXR channels not supported")
        spb = _SCANLINES_PER_BLOCK[comp]
        nblocks = (h + spb - 1) // spb
        f.read(8 * nblocks)  # offset table (blocks are read sequentially)

        planes = {
            name: np.zeros((h, w), _PIXEL_TYPES[pt]) for name, pt, _, _ in chans
        }
        bytes_per_row = sum(
            np.dtype(_PIXEL_TYPES[pt]).itemsize * w for _, pt, _, _ in chans
        )
        for _ in range(nblocks):
            y0, size = struct.unpack("<ii", f.read(8))
            data = f.read(size)
            rows = min(spb, ymax - y0 + 1)
            expect = bytes_per_row * rows
            if comp == 0 or len(data) == expect:
                raw = data  # stored raw (compression did not help)
            elif comp == 1:
                raw = _predictor_undo(_rle_decode(data))
            elif comp == _PIZ:
                raw = _piz_uncompress(data, chans, w, rows)
            else:
                raw = _predictor_undo(zlib.decompress(data))
            if len(raw) != expect:
                raise ValueError(f"bad scanline block in {path}")
            off = 0
            for r in range(rows):
                for name, pt, _, _ in chans:  # channels stored alphabetically
                    dt = np.dtype(_PIXEL_TYPES[pt])
                    row = np.frombuffer(raw, dt, count=w, offset=off)
                    planes[name][y0 - ymin + r] = row
                    off += dt.itemsize * w

        out = np.zeros((h, w, 4), np.float32)
        out[..., 3] = 1.0
        for i, c in enumerate("RGBA"):
            if c in planes:
                out[..., i] = planes[c].astype(np.float32)
        return out


def write(path, rgba):
    """Write float32 (h, w, 3|4) RGB(A) as a half RGBA EXR (ZIPS)."""
    rgba = np.asarray(rgba, np.float32)
    if rgba.ndim == 3 and rgba.shape[2] == 3:
        rgba = np.concatenate([rgba, np.ones_like(rgba[..., :1])], axis=-1)
    h, w, _ = rgba.shape
    half = rgba.astype(np.float16)
    chans = b""
    for name in (b"A", b"B", b"G", b"R"):
        chans += name + b"\x00" + struct.pack("<i4xii", 1, 1, 1)
    chans += b"\x00"

    def attr(name, typ, data):
        return (
            name.encode() + b"\x00" + typ.encode() + b"\x00"
            + struct.pack("<i", len(data)) + data
        )

    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (
        attr("channels", "chlist", chans)
        + attr("compression", "compression", b"\x02")  # ZIPS
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\x00")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\x00"
    )
    blocks = []
    for y in range(h):
        row = b"".join(half[y, :, c].tobytes() for c in (3, 2, 1, 0))  # ABGR
        comp = zlib.compress(_predictor_apply(row))
        if len(comp) >= len(row):
            comp = row  # stored raw when compression does not help
        blocks.append(struct.pack("<ii", y, len(comp)) + comp)

    with open(path, "wb") as f:
        f.write(struct.pack("<I", _MAGIC) + b"\x02\x00\x00\x00")
        f.write(header)
        offset = 4 + 4 + len(header) + 8 * h
        for b in blocks:
            f.write(struct.pack("<Q", offset))
            offset += len(b)
        for b in blocks:
            f.write(b)
