"""A baseline JPEG encoder in numpy and the standard library (the JAX
package's preview encodes with PIL, which the port does not need).

``encode_jpeg(image, quality=80) -> bytes`` writes a JFIF file: YCbCr with
4:2:0 chroma (2x2 averages, as PIL's default at quality 80), 8x8 DCTs, the
example quantisation tables of ITU-T T.81 Annex K.1 scaled by the IJG
quality rule, and the example Huffman tables of Annex K.3, in one
interleaved baseline scan with byte stuffing. Every stage runs on whole
arrays: the DCT and the quantisation as matrix products over all blocks,
the run-length symbols as sorted index arrays, and the bit packing as one
``np.packbits`` over the concatenated codes.
"""

from __future__ import annotations

import struct

import numpy as np

# T.81 Annex K.1: luminance and chrominance quantisation, natural order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64).reshape(8, 8)
_Q_CHROMA = np.full((8, 8), 99, np.int64)
_Q_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                     [47, 66, 99, 99]]

# T.81 Annex K.3: (code counts by length 1-16, symbols) of the DC and AC
# tables, luminance then chrominance
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _zigzag() -> np.ndarray:
    """The natural index (row * 8 + column) of each zigzag position."""
    cells = [(i, j) for i in range(8) for j in range(8)]
    cells.sort(key=lambda c: (c[0] + c[1],
                              c[0] if (c[0] + c[1]) % 2 else -c[0]))
    return np.array([i * 8 + j for i, j in cells])


ZIGZAG = _zigzag()

# the orthonormal 8-point DCT-II: F = D X D^T is T.81's FDCT
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8.0)
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """An Annex K table scaled by the IJG rule (libjpeg's
    jpeg_quality_scaling), clamped to [1, 255]."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huffman_codes(table):
    """{symbol: (code, length)} of a table given as (counts, symbols), by
    the canonical assignment of T.81 Annex C."""
    counts, symbols = table
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _lookup(table):
    """(code, length) arrays indexed by symbol (0-255)."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    for sym, (c, n) in _huffman_codes(table).items():
        code[sym], length[sym] = c, n
    return code, length


_TABLES = [(_lookup(_DC_LUMA), _lookup(_AC_LUMA)),
           (_lookup(_DC_CHROMA), _lookup(_AC_CHROMA))]


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H / 8, W / 8, 8, 8) blocks."""
    H, W = plane.shape
    return plane.reshape(H // 8, 8, W // 8, 8).swapaxes(1, 2)


def _category(v: np.ndarray) -> np.ndarray:
    """The bits of |v| (the magnitude category of T.81 F.1.2.1)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _extra_bits(v: np.ndarray, cat: np.ndarray) -> np.ndarray:
    """The ``cat`` low bits that code ``v``: v itself when positive, v - 1
    in two's complement (the ones' complement of |v|) when negative."""
    return np.where(v >= 0, v, v + (1 << cat) - 1)


def _scan_symbols(coefs: np.ndarray, comp: np.ndarray):
    """The scan's codes in order: (value, length) arrays whose bits, each
    value's low ``length`` bits from the top, concatenate to the entropy
    coded segment. ``coefs`` (B, 64) holds the quantised coefficients of
    the scan's blocks in zigzag order, in scan order; ``comp`` (B,) each
    block's table (0 luminance, 1 chrominance) and component (0-2) as
    table * 4 + component."""
    B = coefs.shape[0]
    table = comp // 4
    keys, values, lengths = [], [], []

    def emit(key, huff_code, huff_len, extra, extra_len):
        keys.append(key)
        values.append((huff_code << extra_len) | extra)
        lengths.append(huff_len + extra_len)

    # DC: the difference from the previous block of the same component
    dc = coefs[:, 0]
    diff = np.empty(B, np.int64)
    for c in np.unique(comp % 4):
        sel = np.nonzero(comp % 4 == c)[0]
        diff[sel] = np.diff(dc[sel], prepend=0)
    cat = _category(diff)
    for t in (0, 1):
        sel = np.nonzero(table == t)[0]
        (code, length), _ = _TABLES[t]
        emit(sel * 256, code[cat[sel]], length[cat[sel]],
             _extra_bits(diff[sel], cat[sel]), cat[sel])

    # AC: each nonzero coefficient with the zeros before it (ZRL for each
    # run of 16), and EOB where the block ends in zeros
    ac = coefs[:, 1:]
    b, k = np.nonzero(ac)
    k = k + 1
    first = np.ones(b.shape, bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.roll(k, 1))
    run = k - prev - 1
    v = ac[b, k - 1]
    size = _category(v)
    zrl = run // 16
    for t in (0, 1):
        _, (code, length) = _TABLES[t]
        sel = table[b] == t
        sym = (run[sel] % 16) * 16 + size[sel]
        emit(b[sel] * 256 + 2 * k[sel], code[sym], length[sym],
             _extra_bits(v[sel], size[sel]), size[sel])
        # ZRL symbols sort just before their coefficient
        nz = np.repeat(np.nonzero(sel)[0], zrl[sel])
        if nz.size:
            emit(b[nz] * 256 + 2 * k[nz] - 1,
                 np.full(nz.size, code[0xF0]), np.full(nz.size, length[0xF0]),
                 np.zeros(nz.size, np.int64), np.zeros(nz.size, np.int64))
        ends = np.nonzero((table == t) & (ac[:, -1] == 0))[0]
        emit(ends * 256 + 255, np.full(ends.size, code[0x00]),
             np.full(ends.size, length[0x00]), np.zeros(ends.size, np.int64),
             np.zeros(ends.size, np.int64))
    order = np.argsort(np.concatenate(keys), kind="stable")
    return (np.concatenate(values)[order], np.concatenate(lengths)[order])


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """The codes' bits, most significant first, padded with 1-bits to a
    byte, with a 0x00 stuffed after every 0xFF."""
    total = int(lengths.sum())
    ends = np.cumsum(lengths)
    # bit j of the stream is bit (end of its code - 1 - j) of its code
    shift = np.repeat(ends, lengths) - 1 - np.arange(total)
    bits = (np.repeat(values, lengths) >> shift) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits.astype(np.uint8), np.ones(pad, np.uint8)])
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _dht(cls_id: int, table) -> bytes:
    counts, symbols = table
    return bytes([cls_id]) + bytes(counts) + bytes(symbols)


def _to_uint8(image) -> np.ndarray:
    """(H, W, 3) uint8 from uint8, or float in [0, 1]."""
    img = np.asarray(image)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"image must be (H, W, 3), got {img.shape}")
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    return img


def encode_jpeg(image, quality: int = 80) -> bytes:
    """(H, W, 3) uint8, or float in [0, 1], -> the bytes of a baseline
    JFIF file with 4:2:0 chroma at ``quality`` (1-100, the IJG scale)."""
    img = _to_uint8(image)
    H, W = img.shape[:2]
    if not (0 < H < 65536 and 0 < W < 65536):
        raise ValueError(f"a JPEG side must be in [1, 65535], got {H}x{W}")
    # pad to whole 16x16 MCUs by repeating the last row and column
    Hp, Wp = -(-H // 16) * 16, -(-W // 16) * 16
    rgb = np.pad(img, ((0, Hp - H), (0, Wp - W), (0, 0)),
                 mode="edge").astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    def down(c):
        return c.reshape(Hp // 2, 2, Wp // 2, 2).mean(axis=(1, 3))

    qy = quant_table(_Q_LUMA, quality)
    qc = quant_table(_Q_CHROMA, quality)

    def coefficients(plane, q):
        blocks = _blocks(plane - 128.0)
        f = _DCT @ blocks @ _DCT.T
        return np.round(f / q).astype(np.int64).reshape(
            blocks.shape[:2] + (64,))[..., ZIGZAG]

    cy = coefficients(y, qy)                       # (Hp/8, Wp/8, 64)
    ccb = coefficients(down(cb), qc)               # (Hp/16, Wp/16, 64)
    ccr = coefficients(down(cr), qc)
    my, mx = Hp // 16, Wp // 16
    # scan order: per MCU the four luminance blocks (row by row), Cb, Cr
    luma = cy.reshape(my, 2, mx, 2, 64).swapaxes(1, 2).reshape(my, mx, 4, 64)
    mcu = np.concatenate([luma, ccb[:, :, None], ccr[:, :, None]], axis=2)
    comp = np.tile(np.array([0, 0, 0, 0, 5, 6]), my * mx)
    data = _pack(*_scan_symbols(mcu.reshape(-1, 64), comp))

    head = b"\xff\xd8"
    head += _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    head += _segment(0xFFDB, b"".join(
        bytes([t]) + bytes(q.reshape(64)[ZIGZAG].tolist())
        for t, q in ((0, qy), (1, qc))))
    head += _segment(0xFFC0, struct.pack(">BHHB", 8, H, W, 3)
                     + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    head += _segment(0xFFC4, _dht(0x00, _DC_LUMA) + _dht(0x10, _AC_LUMA)
                     + _dht(0x01, _DC_CHROMA) + _dht(0x11, _AC_CHROMA))
    head += _segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return head + data + b"\xff\xd9"
