"""Minimal self-contained FITS reader/writer (no astropy dependency).

The port's own copy of `surfh_tpu/preprocessing/fits_io.py` (same code):
the port imports nothing of `surfh_tpu`, not even its NumPy modules.

Supports what the pipeline needs:

* reading primary/extension IMAGE HDUs (any numeric BITPIX),
* reading BINTABLE HDUs with scalar/array numeric columns (the MIRI PCE
  calibration files and JWST stage-2 products),
* writing simple IMAGE HDUs with header cards (the corrected-slice writer,
  parity with surfh/ToolsDir/fits_toolbox.py:5-36).

FITS layout: 2880-byte blocks; headers are 80-char ASCII cards; binary data is
big-endian.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

BLOCK = 2880
CARD = 80

_BITPIX_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}

_TFORM_DTYPE = {
    "L": np.dtype(">u1"),
    "B": np.dtype(">u1"),
    "I": np.dtype(">i2"),
    "J": np.dtype(">i4"),
    "K": np.dtype(">i8"),
    "E": np.dtype(">f4"),
    "D": np.dtype(">f8"),
}


def _parse_card(card: bytes):
    text = card.decode("ascii", errors="replace")
    key = text[:8].strip()
    if key in ("COMMENT", "HISTORY", "END", ""):
        return key, None, None
    if text[8:10] != "= ":
        return key, None, None
    body = text[10:]
    comment = None
    if body.lstrip().startswith("'"):
        # string value: find closing quote ('' escapes a quote)
        m = re.match(r"\s*'((?:[^']|'')*)'\s*(?:/(.*))?", body)
        if m:
            value: Union[str, float, int, bool] = m.group(1).replace("''", "'").rstrip()
            comment = m.group(2)
        else:
            value = body.strip()
    else:
        if "/" in body:
            valstr, comment = body.split("/", 1)
        else:
            valstr = body
        valstr = valstr.strip()
        if valstr == "T":
            value = True
        elif valstr == "F":
            value = False
        else:
            try:
                value = int(valstr)
            except ValueError:
                try:
                    value = float(valstr.replace("D", "E"))
                except ValueError:
                    value = valstr
    return key, value, comment


@dataclass
class HDU:
    """One header-data unit: header dict (+ card order) and data payload."""

    header: Dict[str, Union[str, int, float, bool]]
    data: Optional[np.ndarray] = None
    columns: Optional[Dict[str, np.ndarray]] = None  # for BINTABLE
    name: str = ""

    def __getitem__(self, key):
        if self.columns is not None and key in self.columns:
            return self.columns[key]
        return self.header[key]


def _read_header(buf: bytes, offset: int):
    header: Dict[str, Union[str, int, float, bool]] = {}
    pos = offset
    last_str_key = None  # FITS long-string convention (CONTINUE cards)
    while True:
        block = buf[pos : pos + BLOCK]
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        done = False
        for i in range(0, BLOCK, CARD):
            card = block[i : i + CARD]
            key, value, _ = _parse_card(card)
            if key == "END":
                done = True
                break
            if key == "CONTINUE" and last_str_key is not None:
                # continuation of a '...&' long string (real JWST headers
                # use this for S_REGION etc.): strip the trailing '&' of
                # the accumulated value and append this card's string
                m = re.match(r"CONTINUE\s+'((?:[^']|'')*)'", card.decode(
                    "ascii", errors="replace"))
                if m:
                    prev = header[last_str_key]
                    if isinstance(prev, str) and prev.endswith("&"):
                        header[last_str_key] = (
                            prev[:-1] + m.group(1).replace("''", "'").rstrip()
                        )
                continue
            if value is not None:
                header[key] = value
                last_str_key = key if isinstance(value, str) else None
        pos += BLOCK
        if done:
            return header, pos


def _data_size(header) -> int:
    naxis = int(header.get("NAXIS", 0))
    if naxis == 0:
        return 0
    n = 1
    for i in range(1, naxis + 1):
        n *= int(header[f"NAXIS{i}"])
    nbytes = n * abs(int(header["BITPIX"])) // 8
    nbytes *= int(header.get("GCOUNT", 1))
    nbytes += int(header.get("PCOUNT", 0)) * abs(int(header["BITPIX"])) // 8
    return nbytes


def _parse_bintable(header, raw: bytes) -> Dict[str, np.ndarray]:
    nrow = int(header["NAXIS2"])
    rowbytes = int(header["NAXIS1"])
    tfields = int(header["TFIELDS"])
    cols: List[Tuple[str, np.dtype, int]] = []
    for i in range(1, tfields + 1):
        tform = str(header[f"TFORM{i}"]).strip()
        name = str(header.get(f"TTYPE{i}", f"col{i}")).strip()
        m = re.match(r"(\d*)([LBIJKED])", tform)
        if m is None:
            m2 = re.match(r"(\d*)A", tform)
            if m2:
                repeat = int(m2.group(1) or 1)
                cols.append((name, np.dtype(f"S{repeat}"), 1))
                continue
            raise ValueError(f"unsupported TFORM {tform!r}")
        repeat = int(m.group(1) or 1)
        cols.append((name, _TFORM_DTYPE[m.group(2)], repeat))

    table = np.frombuffer(raw[: nrow * rowbytes], dtype=np.uint8).reshape(nrow, rowbytes)
    out: Dict[str, np.ndarray] = {}
    off = 0
    for name, dtype, repeat in cols:
        width = dtype.itemsize * repeat
        colbytes = table[:, off : off + width].tobytes()
        arr = np.frombuffer(colbytes, dtype=dtype)
        if dtype.kind != "S":
            arr = arr.reshape(nrow, repeat)
            if repeat == 1:
                arr = arr[:, 0]
            arr = arr.astype(arr.dtype.newbyteorder("="))
        out[name] = arr
        off += width
    return out


def fits_open(path: str) -> List[HDU]:
    """Read all HDUs of a FITS file."""
    with open(path, "rb") as fh:
        buf = fh.read()
    hdus: List[HDU] = []
    pos = 0
    while pos + BLOCK <= len(buf):
        header, pos = _read_header(buf, pos)
        size = _data_size(header)
        raw = buf[pos : pos + size]
        pos += ((size + BLOCK - 1) // BLOCK) * BLOCK
        xtension = str(header.get("XTENSION", "")).strip()
        name = str(header.get("EXTNAME", "")).strip()
        if xtension in ("BINTABLE", "A3DTABLE"):
            if header.get("ZIMAGE") is True:
                # Tile-compressed image stored as a BINTABLE (RICE_1/GZIP
                # convention, common in archive products).  Decompression is
                # out of scope for this reader — fail loudly rather than
                # returning the raw compressed tiles as a "table".
                raise NotImplementedError(
                    f"HDU {name or len(hdus)}: tile-compressed image "
                    f"(ZIMAGE=T, ZCMPTYPE={header.get('ZCMPTYPE', '?')}) — "
                    "decompress first (e.g. `funpack` or astropy) and rerun."
                )
            hdus.append(HDU(header, None, _parse_bintable(header, raw), name))
        else:
            naxis = int(header.get("NAXIS", 0))
            if naxis > 0 and size > 0:
                shape = tuple(
                    int(header[f"NAXIS{i}"]) for i in range(naxis, 0, -1)
                )
                dtype = _BITPIX_DTYPE[int(header["BITPIX"])]
                count = int(np.prod(shape))
                data = np.frombuffer(raw, dtype=dtype, count=count).reshape(shape)
                data = data.astype(dtype.newbyteorder("="))
                bscale = header.get("BSCALE", 1)
                bzero = header.get("BZERO", 0)
                blank = header.get("BLANK") if int(header["BITPIX"]) > 0 else None
                if blank is not None:
                    # integer undefined-pixel sentinel → NaN (must go through
                    # float, whether or not the HDU is scaled)
                    mask = data == int(blank)
                    data = data.astype(np.float64) * bscale + bzero
                    data[mask] = np.nan
                elif bscale != 1 or bzero != 0:
                    data = data * bscale + bzero
                hdus.append(HDU(header, data, None, name))
            else:
                hdus.append(HDU(header, None, None, name))
    return hdus


def _format_card(key: str, value, comment: str = "") -> bytes:
    if isinstance(value, bool):
        valstr = "T" if value else "F"
        card = f"{key:<8}= {valstr:>20}"
    elif isinstance(value, (int, np.integer)):
        card = f"{key:<8}= {value:>20}"
    elif isinstance(value, (float, np.floating)):
        card = f"{key:<8}= {value:>20.14G}"
    else:
        s = str(value).replace("'", "''")
        card = f"{key:<8}= '{s}'"
    if comment:
        card += f" / {comment}"
    return card[:CARD].ljust(CARD).encode("ascii")


def _pad_block(b: bytes, fill: bytes = b" ") -> bytes:
    rem = len(b) % BLOCK
    return b if rem == 0 else b + fill * (BLOCK - rem)


_DTYPE_BITPIX = {"u1": 8, "i2": 16, "i4": 32, "i8": 64, "f4": -32, "f8": -64}


def fits_write(path: str, data: np.ndarray, header: Optional[Dict] = None) -> None:
    """Write a single-HDU FITS image with optional extra header cards."""
    data = np.asarray(data)
    key = data.dtype.str[1:]
    if key not in _DTYPE_BITPIX:
        data = data.astype(np.float64)
        key = "f8"
    bitpix = _DTYPE_BITPIX[key]

    cards = [
        _format_card("SIMPLE", True, "conforms to FITS standard"),
        _format_card("BITPIX", bitpix),
        _format_card("NAXIS", data.ndim),
    ]
    for i, dim in enumerate(reversed(data.shape), start=1):
        cards.append(_format_card(f"NAXIS{i}", dim))
    for k, v in (header or {}).items():
        cards.append(_format_card(str(k)[:8].upper(), v))
    cards.append(b"END".ljust(CARD))
    head = _pad_block(b"".join(cards))

    payload = data.astype(np.dtype(f">{key}")).tobytes()
    with open(path, "wb") as fh:
        fh.write(head)
        fh.write(_pad_block(payload, b"\x00"))
