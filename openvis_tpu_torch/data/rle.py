"""COCO-compatible mask encodings (RLE + polygons), self-contained.

The reference leans on pycocotools for RLE decode/encode and polygon
rasterization (``ytvis_dataset_mapper.py``, ``evals/ytvos.py:214-258``);
that package isn't available here, so this module implements the public
COCO mask format directly:

  * uncompressed RLE: alternating background/foreground run lengths in
    **column-major** (Fortran) order;
  * compressed RLE string: LEB128-style base-32 chars (offset 48) with
    second-order deltas (``x -= cnt[i-2]`` for i > 2);
  * polygon rasterization via PIL's polygon fill (matches pycocotools'
    integer-grid fill to within boundary-pixel rounding).

Used by the dataset mappers (GT decode) and the YTVIS evaluator (prediction
encode + spatio-temporal IoU).

Copy of ``openvis_tpu/data/rle.py`` for the PyTorch port.  Encoding and the
intersection/union run in the port's native library (``native/``), which
raises when it cannot be built; the pure-Python encoder stays as
``encode_counts_plain``, the plain version the tests hold the library to.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from openvis_tpu_torch.native import (
    native_encode,
    native_encode_flat,
    native_intersection_union,
)


def encode_counts(mask: np.ndarray) -> List[int]:
    """mask: (H, W) {0,1} -> run lengths, column-major, starting with 0s."""
    return native_encode(mask).tolist()


def encode_counts_plain(mask: np.ndarray) -> List[int]:
    """The pure-Python ``encode_counts``."""
    flat = np.asfortranarray(mask).reshape(-1, order="F").astype(np.uint8)
    if flat.size == 0:
        return [0]
    change = np.nonzero(np.diff(flat))[0]
    runs = np.diff(np.concatenate([[-1], change, [flat.size - 1]]))
    counts = runs.tolist()
    if flat[0] == 1:  # must start with a (possibly zero) background run
        counts = [0] + counts
    return counts


def decode_counts(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    total = h * w
    flat = np.zeros(total, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def counts_to_string(counts: Sequence[int]) -> str:
    """pycocotools rleToString: base-32 chars offset 48, 2nd-order deltas."""
    s = []
    for i, cnt in enumerate(counts):
        x = int(cnt)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return "".join(s)


def string_to_counts(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode(mask: np.ndarray) -> Dict:
    """(H, W) binary -> COCO compressed RLE dict."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": counts_to_string(encode_counts(mask))}


def encode_transposed(mask_t: np.ndarray) -> Dict:
    """``encode`` of the (H, W) mask whose transpose (W, H) is given in C
    order: its bytes are the mask's column-major order, which the encoder
    walks, so no copy is made."""
    w, h = mask_t.shape
    counts = native_encode_flat(mask_t).tolist()
    return {"size": [int(h), int(w)], "counts": counts_to_string(counts)}


def decode(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    return decode_counts(counts, h, w)


def area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    return int(sum(counts[1::2]))


def polygons_to_mask(polygons: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """COCO polygon list [[x0,y0,x1,y1,...], ...] -> (H, W) uint8 mask."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, dtype=np.uint8)


def segm_to_mask(segm, h: int, w: int) -> np.ndarray:
    """Any COCO segmentation (polygons / RLE dict / uncompressed) -> mask."""
    if segm is None:
        return np.zeros((h, w), np.uint8)
    if isinstance(segm, list):
        return polygons_to_mask(segm, h, w)
    if isinstance(segm, dict):
        return decode(segm)
    raise TypeError(f"unknown segmentation type {type(segm)}")


def _counts_list(rle: Dict) -> List[int]:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        return string_to_counts(counts)
    return list(counts)


def rle_intersection_union(d: Dict, g: Dict) -> tuple:
    """Pixel intersection and union of two RLEs, by the native run-walk
    kernel (``native/rle_ops.c``): no mask decode."""
    return native_intersection_union(
        np.asarray(_counts_list(d), np.int64),
        np.asarray(_counts_list(g), np.int64),
    )
