"""Image output: PNG/JPG via PIL, EXR via a minimal native writer; the
port's own copy of `ovr_tpu.io.image` (numpy only).

Equivalent of the reference's `ovr/common/imageio.{h,cpp}` (stbi PNG/JPG with
vertical flip + float->u8; tinyexr float EXR). The EXR writer emits an
uncompressed scanline OpenEXR 2.0 file (FLOAT channels) with no external
dependency.
"""

from __future__ import annotations

import struct

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255.99).astype(np.uint8)


def timestamped_path(prefix: str = "screenshot", ext: str = ".png") -> str:
    """`<prefix>-<YYYYmmdd-HHMMSS>.png` — the screenshot naming of
    `ovr/common/vidi_screenshot.h:33-72`."""
    import time

    return f"{prefix}-{time.strftime('%Y%m%d-%H%M%S')}{ext}"


def save_image(path: str, img: np.ndarray, flip: bool = True) -> None:
    """Save float (H, W, 3|4) (or uint8) image; PNG/JPG chosen by extension.

    `flip` mirrors the reference's vertical flip on save (imageio.cpp) —
    framebuffers are y-up, image files are y-down.
    """
    from PIL import Image

    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to_uint8(img)
    if flip:
        img = img[::-1]
    if path.lower().endswith((".jpg", ".jpeg")) and img.shape[-1] == 4:
        img = img[..., :3]
    Image.fromarray(img).save(path)


def save_exr(path: str, img: np.ndarray, flip: bool = True) -> None:
    """Write a float32 EXR (uncompressed, scanline). Channels B, G, R (+A),
    matching the reference's channel order (imageio.cpp save_exr)."""
    img = np.asarray(img, np.float32)
    if flip:
        img = img[::-1]
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    if img.ndim == 2:
        img = img[:, :, None]
    names = {1: ["Y"], 3: ["B", "G", "R"], 4: ["A", "B", "G", "R"]}[c]
    # channel name -> source plane (EXR stores channels alphabetically)
    plane = {"Y": 0, "R": 0, "G": 1, "B": 2, "A": 3}

    def attr(name: bytes, typ: bytes, data: bytes) -> bytes:
        return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data

    chlist = b""
    for n in names:
        chlist += n.encode() + b"\0" + struct.pack("<iiii", 2, 0, 1, 1)
    chlist += b"\0"

    header = b"\x76\x2f\x31\x01" + struct.pack("<i", 2)
    header += attr(b"channels", b"chlist", chlist)
    header += attr(b"compression", b"compression", b"\0")
    header += attr(b"dataWindow", b"box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += attr(b"displayWindow", b"box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += attr(b"lineOrder", b"lineOrder", b"\0")
    header += attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
    header += attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\0"

    offset_table_pos = len(header) + 8 * h
    scanline_size = 4 + 4 + len(names) * w * 4
    offsets = [offset_table_pos + y * scanline_size for y in range(h)]

    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{h}q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, len(names) * w * 4))
            for n in names:
                f.write(img[y, :, plane[n]].tobytes())


def load_exr(path: str) -> np.ndarray:
    """Minimal reader for files written by `save_exr` (round-trip/testing)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"\x76\x2f\x31\x01", "not an EXR file"
    pos = 8
    channels = []
    w = h = None
    while data[pos] != 0:
        e = data.index(b"\0", pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\0", pos)
        pos = e + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        val = data[pos:pos + size]
        pos += size
        if name == "channels":
            q = 0
            while val[q] != 0:
                ce = val.index(b"\0", q)
                channels.append(val[q:ce].decode())
                q = ce + 1 + 16
        elif name == "dataWindow":
            x0, y0, x1, y1 = struct.unpack("<iiii", val)
            w, h = x1 - x0 + 1, y1 - y0 + 1
    pos += 1  # header terminator
    pos += 8 * h  # offset table
    out = np.zeros((h, w, len(channels)), np.float32)
    for y in range(h):
        pos += 8
        for ci in range(len(channels)):
            out[y, :, ci] = np.frombuffer(data, "<f4", w, pos)
            pos += 4 * w
    order = {"R": 0, "G": 1, "B": 2, "A": 3, "Y": 0}
    planes = np.zeros_like(out)
    for ci, name in enumerate(channels):
        planes[:, :, order[name]] = out[:, :, ci]
    return planes[:, :, : max(order[n] for n in channels) + 1]
