"""PNG read and write on zlib and numpy, for the eval path and the fixture.

The JAX package reads frames with cv2 and masks and GT instance images with
PIL; neither is installed where the port runs, so this module does what
those calls did:

  * `write_png(path, a)`: 8-bit gray (H, W) uint8, 16-bit gray (H, W)
    uint16, 8-bit RGB (H, W, 3) uint8; one IDAT, one row filter for every
    row (None; `encode_png(a, filter)` takes another);
  * `read_png(path)`: what `np.array(Image.open(path))` gives for colour
    types 0 (8 and 16 bit), 2 and 6 (8 bit): (H, W) uint8 / uint16,
    (H, W, 3) or (H, W, 4) uint8;
  * `read_frame(path)` / `write_frame(path, bgr)`: what `cv2.imread` /
    `cv2.imwrite` do with a frame: BGR, 3 channels, uint8;
  * `read_image(path)`: the frame reader of the sampler and the inference
    CLIs: `.npy` with numpy, PNG with `read_frame`, anything else with
    cv2, imported only there.

Every row filter (None, Sub, Up, Average, Paeth) decodes.  Average and
Paeth take the decoded pixel to the left, so a row cannot be undone in one
numpy step; from the first such row on, the rows are undone along
anti-diagonals instead: pixel (r, x) needs (r, x-1) and (r-1, x) of
diagonal r+x-1 and (r-1, x-1) of diagonal r+x-2, so a frame takes H+W-1
numpy steps.
Palette, gray+alpha, 1/2/4-bit, 16-bit colour and interlaced files raise
ValueError; they are never decoded wrongly.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
LEVEL = 6                     # zlib level of every PNG written (PIL's default)
# colour type -> channels, for the types this codec decodes
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter_rows(rows: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """Apply PNG row filter `kind` to every row of (H, row_bytes) uint8."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]                        # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                                  # up
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]                     # up-left
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1}.get(kind)
    if pred is None:
        pred = _paeth(a, b, c)
    return ((x - pred) & 255).astype(np.uint8)


def encode_png(a: np.ndarray, filter: int = 0) -> bytes:
    """PNG bytes of a (H, W) uint8 / uint16 or (H, W, 3) uint8 array, every
    row filtered with `filter` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    a = np.asarray(a)
    if a.ndim == 2 and a.dtype == np.uint8:
        depth, ctype, rows = 8, 0, a
    elif a.ndim == 2 and a.dtype == np.uint16:
        depth, ctype, rows = 16, 0, a.astype(">u2").view(np.uint8)
    elif a.ndim == 3 and a.shape[2] == 3 and a.dtype == np.uint8:
        depth, ctype, rows = 8, 2, a.reshape(a.shape[0], -1)
    else:
        raise ValueError(f"write_png: (H, W) uint8/uint16 or (H, W, 3) uint8, "
                         f"got {a.shape} {a.dtype}")
    if filter not in range(5):
        raise ValueError(f"write_png: row filter {filter} is not 0-4")
    h, w = a.shape[:2]
    if h == 0 or w == 0:
        raise ValueError(f"write_png: empty image {a.shape}")
    rows = rows.reshape(h, -1)
    raw = np.empty((h, rows.shape[1] + 1), np.uint8)
    raw[:, 0] = filter
    raw[:, 1:] = (_filter_rows(rows, filter, rows.shape[1] // w) if filter
                  else rows)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), LEVEL))
            + _chunk(b"IEND", b""))


def write_png(path: str, a: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(a))


def write_frame(path: str, bgr: np.ndarray) -> None:
    """A (H, W, 3) uint8 BGR frame as an RGB PNG (cv2.imwrite's order)."""
    write_png(path, np.ascontiguousarray(np.asarray(bgr)[..., ::-1]))


def _paeth(a, b, c):
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_row(ft: int, x: np.ndarray, prev: np.ndarray, bpp: int
                  ) -> np.ndarray:
    """One row of filter None, Sub or Up."""
    if ft == 0:
        return x
    if ft == 2:
        return x + prev        # uint8 wraps: the mod-256 sum PNG defines
    lanes = x.reshape(-1, bpp).astype(np.int64)
    return (np.cumsum(lanes, axis=0) & 255).astype(np.uint8).reshape(-1)


def _unfilter_diagonals(x: np.ndarray, ft: np.ndarray, prev: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Undo R rows of any filters (x: (R, W*bpp) uint8, ft: (R,), prev: the
    decoded row above them) one anti-diagonal at a time.  The rows are
    first skewed so that diagonal d is row d of an array (pixel (r, x) at
    [r + x, r]): each step then reads and writes contiguous slices."""
    rows, width = len(ft), x.shape[1] // bpp
    diags = rows + width - 1
    item = bpp * 2                                   # one int16 pixel
    src = np.zeros((diags, rows, bpp), np.int16)     # src[r + x, r]
    np.lib.stride_tricks.as_strided(
        src, (rows, width, bpp), ((rows + 1) * item, rows * item, 2)
    )[:] = x.reshape(rows, width, bpp)
    # q[d + 2, r + 1] = decoded pixel (r, d - r); column 0 holds row -1
    # (prev at q[x + 1, 0]), everything off the image stays 0
    q = np.zeros((diags + 2, rows + 1, bpp), np.int16)
    q[1:width + 1, 0] = prev.reshape(width, bpp)
    kinds = ft.astype(np.int16)[:, None]
    paeth = bool((ft == 4).any())
    for d in range(diags):
        r0, r1 = max(0, d - width + 1), min(rows - 1, d)
        a = q[d + 1, r0 + 1:r1 + 2]      # (r, x - 1)
        b = q[d + 1, r0:r1 + 1]          # (r - 1, x)
        c = q[d, r0:r1 + 1]              # (r - 1, x - 1)
        f = kinds[r0:r1 + 1]
        pred = np.where(f == 1, a, 0)
        pred = np.where(f == 2, b, pred)
        pred = np.where(f == 3, (a + b) >> 1, pred)
        if paeth:
            pred = np.where(f == 4, _paeth(a, b, c), pred)
        q[d + 2, r0 + 1:r1 + 2] = (src[d, r0:r1 + 1] + pred) & 255
    out = np.lib.stride_tricks.as_strided(            # q[r + x + 2, r + 1]
        q.reshape(-1)[(2 * (rows + 1) + 1) * bpp:], (rows, width, bpp),
        ((rows + 2) * item, (rows + 1) * item, 2))
    return out.reshape(rows, -1).astype(np.uint8)


def _unfilter(data: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    if len(data) != h * (row_bytes + 1):
        raise ValueError(f"PNG: {len(data)} bytes of image data, expected "
                         f"{h * (row_bytes + 1)}")
    raw = np.frombuffer(data, np.uint8).reshape(h, row_bytes + 1)
    ft, x = raw[:, 0], raw[:, 1:]
    if ft.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {int(ft.max())}")
    out = np.empty((h, row_bytes), np.uint8)
    slow = np.flatnonzero(ft >= 3)       # Average, Paeth
    first, last = (int(slow[0]), int(slow[-1])) if slow.size else (h, h - 1)
    prev = np.zeros(row_bytes, np.uint8)
    for r in range(first):
        out[r] = prev = _unfilter_row(int(ft[r]), x[r], prev, bpp)
    if slow.size:
        out[first:last + 1] = _unfilter_diagonals(
            x[first:last + 1], ft[first:last + 1], prev, bpp)
        prev = out[last]
    for r in range(last + 1, h):
        out[r] = prev = _unfilter_row(int(ft[r]), x[r], prev, bpp)
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """PNG bytes -> what np.array(Image.open(...)) gives (see module doc)."""
    if buf[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 12 <= len(buf):
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", buf[pos + 8 + length:pos + 12 + length])
        if len(data) != length or zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG: chunk {kind!r} is truncated or corrupt")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG: no IHDR or no IDAT chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype == 3:
        raise ValueError("PNG: palette images are not supported")
    if ctype not in _CHANNELS or comp != 0 or filt != 0:
        raise ValueError(f"PNG: colour type {ctype} is not supported "
                         f"(gray, RGB and RGBA only)")
    if interlace:
        raise ValueError("PNG: interlaced images are not supported")
    if not (depth == 8 or (depth == 16 and ctype == 0)):
        raise ValueError(f"PNG: bit depth {depth} of colour type {ctype} is "
                         f"not supported (8 bit, or 16-bit gray)")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w)
    return rows.reshape(h, w) if channels == 1 else rows.reshape(h, w, channels)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def read_frame(path: str) -> np.ndarray:
    """cv2.imread(path): (H, W, 3) uint8 BGR; gray is repeated over the
    three channels (16-bit gray keeps its high byte), alpha is dropped."""
    a = read_png(path)
    if a.dtype == np.uint16:
        a = (a >> 8).astype(np.uint8)
    if a.ndim == 2:
        return np.repeat(a[:, :, None], 3, axis=2)
    return np.ascontiguousarray(a[:, :, 2::-1])


def read_image(path: str) -> np.ndarray:
    """An HWC uint8 frame: `.npy` as numpy saved it, PNG through
    `read_frame` (BGR, as cv2.imread gives it), JPEG and the rest through
    cv2.imread, which is imported here only.  Raises RuntimeError naming
    cv2 where a non-PNG image needs it and it is missing, and ValueError
    for a file that cannot be decoded."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.lower().endswith(".png"):
        return read_frame(path)
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"{path}: decoding this image needs cv2, which is not "
            f"installed; store frames as .png or .npy instead") from e
    img = cv2.imread(path)
    if img is None:
        raise ValueError(f"{path}: cv2 cannot decode this image")
    return img


def read_mask(path: str) -> np.ndarray:
    """An 8-bit gray mask, as Image.open(path).convert("L") reads it."""
    a = read_png(path)
    if a.ndim != 2 or a.dtype != np.uint8:
        raise ValueError(f"{path}: expected an 8-bit gray mask, got "
                         f"{a.shape} {a.dtype}")
    return a
