"""Minimal pure-Python PDF text extractor (per page); the port's own copy
of ``intool_rag_tpu/ingest/pdf.py``, stdlib only.

Replaces the reference's PyMuPDF delegation (reference:
rag/ingest/page_loader.py:82,95 — ``fitz.open`` / ``page.get_text``),
which is unavailable here. Supports the common digital-PDF profile:

- classic xref tables and xref streams, /Prev chains,
- object streams (/ObjStm), FlateDecode (with predictors) and raw streams,
- page tree traversal with inherited /Resources,
- text operators BT/ET, Tf, Td/TD/Tm/T*, Tj/TJ/'/",
- simple fonts (byte codes, /Differences honored best-effort via
  ToUnicode) and composite Type0/CIDFontType2 fonts (2-byte codes),
- /ToUnicode CMaps (bfchar + bfrange, including array destinations).

Line breaks are reconstructed from text-matrix y movement. This is a
text-layer extractor only; scanned pages yield empty text and flow to the
OCR fallback (reference behavior: page_loader.py:98-108).
"""

from __future__ import annotations

import os
import re
import zlib
from dataclasses import dataclass, field

from ..exceptions import PDFParseError

_WS = b"\x00\t\n\x0c\r "
_DELIM = b"()<>[]{}/%"


# ============================ object model ============================


class Name(str):
    """PDF name object (distinct from strings)."""


@dataclass
class Ref:
    num: int
    gen: int

    def __hash__(self) -> int:
        return hash((self.num, self.gen))


@dataclass
class Stream:
    dict: dict
    raw: bytes
    _decoded: bytes | None = field(default=None, repr=False)


# ============================ lexer/parser ============================


class _Lexer:
    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos

    def skip_ws(self) -> None:
        data, n = self.data, len(self.data)
        while self.pos < n:
            c = data[self.pos]
            if c in _WS:
                self.pos += 1
            elif c == 0x25:  # '%' comment
                eol = data.find(b"\n", self.pos)
                self.pos = n if eol < 0 else eol + 1
            else:
                return

    def peek(self) -> int:
        return self.data[self.pos] if self.pos < len(self.data) else -1

    def read_token(self) -> bytes:
        self.skip_ws()
        start = self.pos
        data, n = self.data, len(self.data)
        while self.pos < n and data[self.pos] not in _WS and data[self.pos] not in _DELIM:
            self.pos += 1
        return data[start : self.pos]


def _parse_object(lx: _Lexer, resolver=None):
    lx.skip_ws()
    c = lx.peek()
    if c < 0:
        raise PDFParseError("unexpected EOF")
    data = lx.data
    if c == 0x2F:  # /name
        lx.pos += 1
        return Name(_decode_name(lx.read_token()))
    if c == 0x28:  # ( string
        return _parse_literal_string(lx)
    if c == 0x3C:  # < hex string or << dict
        if data[lx.pos : lx.pos + 2] == b"<<":
            return _parse_dict(lx, resolver)
        return _parse_hex_string(lx)
    if c == 0x5B:  # [ array
        lx.pos += 1
        out = []
        while True:
            lx.skip_ws()
            if lx.peek() == 0x5D:
                lx.pos += 1
                return out
            out.append(_parse_object(lx, resolver))
    if c == 0x5D:
        raise PDFParseError("unbalanced ]")
    tok = lx.read_token()
    if not tok:
        lx.pos += 1
        return None
    if tok == b"true":
        return True
    if tok == b"false":
        return False
    if tok == b"null":
        return None
    # number or reference "n g R"
    try:
        if b"." in tok:
            return float(tok)
        num = int(tok)
    except ValueError:
        return None
    save = lx.pos
    lx.skip_ws()
    tok2_start = lx.pos
    tok2 = lx.read_token()
    if tok2.isdigit():
        lx.skip_ws()
        tok3 = lx.read_token()
        if tok3 == b"R":
            return Ref(num, int(tok2))
    lx.pos = save if not tok2 else min(save, tok2_start)
    lx.pos = save
    return num


def _decode_name(raw: bytes) -> str:
    out = bytearray()
    i = 0
    while i < len(raw):
        if raw[i] == 0x23 and i + 2 < len(raw):  # '#xx'
            try:
                out.append(int(raw[i + 1 : i + 3], 16))
                i += 3
                continue
            except ValueError:
                pass
        out.append(raw[i])
        i += 1
    return out.decode("latin-1")


def _parse_literal_string(lx: _Lexer) -> bytes:
    data = lx.data
    lx.pos += 1  # (
    depth = 1
    out = bytearray()
    while lx.pos < len(data):
        c = data[lx.pos]
        if c == 0x5C:  # backslash
            lx.pos += 1
            e = data[lx.pos] if lx.pos < len(data) else 0
            esc = {0x6E: 10, 0x72: 13, 0x74: 9, 0x62: 8, 0x66: 12}
            if e in esc:
                out.append(esc[e])
                lx.pos += 1
            elif 0x30 <= e <= 0x37:  # octal
                oct_digits = bytearray()
                while lx.pos < len(data) and len(oct_digits) < 3 and 0x30 <= data[lx.pos] <= 0x37:
                    oct_digits.append(data[lx.pos])
                    lx.pos += 1
                out.append(int(oct_digits, 8) & 0xFF)
            elif e in (0x0A, 0x0D):  # line continuation
                lx.pos += 1
            else:
                out.append(e)
                lx.pos += 1
        elif c == 0x28:
            depth += 1
            out.append(c)
            lx.pos += 1
        elif c == 0x29:
            depth -= 1
            lx.pos += 1
            if depth == 0:
                return bytes(out)
            out.append(c)
        else:
            out.append(c)
            lx.pos += 1
    raise PDFParseError("unterminated string")


def _parse_hex_string(lx: _Lexer) -> bytes:
    end = lx.data.find(b">", lx.pos)
    if end < 0:
        raise PDFParseError("unterminated hex string")
    hx = re.sub(rb"\s", b"", lx.data[lx.pos + 1 : end])
    lx.pos = end + 1
    if len(hx) % 2:
        hx += b"0"
    return bytes.fromhex(hx.decode("ascii"))


def _parse_dict(lx: _Lexer, resolver=None):
    lx.pos += 2  # <<
    d: dict = {}
    while True:
        lx.skip_ws()
        if lx.data[lx.pos : lx.pos + 2] == b">>":
            lx.pos += 2
            break
        key = _parse_object(lx, resolver)
        val = _parse_object(lx, resolver)
        if isinstance(key, Name):
            d[str(key)] = val
    # stream?
    lx.skip_ws()
    if lx.data[lx.pos : lx.pos + 6] == b"stream":
        lx.pos += 6
        if lx.data[lx.pos : lx.pos + 2] == b"\r\n":
            lx.pos += 2
        elif lx.data[lx.pos : lx.pos + 1] in (b"\n", b"\r"):
            lx.pos += 1
        length = d.get("Length")
        if isinstance(length, Ref) and resolver is not None:
            length = resolver(length)
        if not isinstance(length, int):
            # fall back to scanning for endstream
            end = lx.data.find(b"endstream", lx.pos)
            length = end - lx.pos
        raw = lx.data[lx.pos : lx.pos + length]
        lx.pos += length
        end = lx.data.find(b"endstream", lx.pos)
        if end >= 0:
            lx.pos = end + len(b"endstream")
        return Stream(d, raw)
    return d


# ============================ filters ============================


def _apply_png_predictor(data: bytes, colors: int, bpc: int, columns: int) -> bytes:
    bpp = max(1, (colors * bpc) // 8)
    row_len = (columns * colors * bpc + 7) // 8
    out = bytearray()
    prev = bytearray(row_len)
    i = 0
    while i + 1 + row_len <= len(data) or (i < len(data) and i + 1 <= len(data)):
        ft = data[i]
        i += 1
        row = bytearray(data[i : i + row_len])
        i += row_len
        if ft == 1:  # Sub
            for j in range(bpp, len(row)):
                row[j] = (row[j] + row[j - bpp]) & 0xFF
        elif ft == 2:  # Up
            for j in range(len(row)):
                row[j] = (row[j] + prev[j]) & 0xFF
        elif ft == 3:  # Average
            for j in range(len(row)):
                left = row[j - bpp] if j >= bpp else 0
                row[j] = (row[j] + (left + prev[j]) // 2) & 0xFF
        elif ft == 4:  # Paeth
            for j in range(len(row)):
                a = row[j - bpp] if j >= bpp else 0
                b = prev[j]
                c = prev[j - bpp] if j >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[j] = (row[j] + pred) & 0xFF
        out.extend(row)
        prev = row
        if i >= len(data):
            break
    return bytes(out)


# Cap on a single FlateDecode expansion: user uploads reach this code
# directly via /ingest, and a tiny crafted deflate bomb can expand to
# gigabytes and OOM the service. Real PDF content streams are nowhere
# near this size.
MAX_STREAM_DECODED_BYTES = int(
    os.environ.get("PDF_MAX_STREAM_BYTES", 64 * 1024 * 1024)
)


def _bounded_inflate(data: bytes, limit: int = 0) -> bytes:
    limit = limit or MAX_STREAM_DECODED_BYTES
    dobj = zlib.decompressobj()
    out = dobj.decompress(data, limit)
    if dobj.unconsumed_tail or (not dobj.eof and dobj.decompress(b"", 1)):
        raise PDFParseError(
            f"FlateDecode stream exceeds {limit} decoded bytes (bomb?)"
        )
    return out


def decode_stream(stream: Stream, resolver=None) -> bytes:
    if stream._decoded is not None:
        return stream._decoded
    data = stream.raw
    filters = stream.dict.get("Filter")
    if isinstance(filters, Ref) and resolver:
        filters = resolver(filters)
    if filters is None:
        filters = []
    elif not isinstance(filters, list):
        filters = [filters]
    parms = stream.dict.get("DecodeParms")
    if not isinstance(parms, list):
        parms = [parms] * len(filters)
    for filt, parm in zip(filters, parms):
        if isinstance(parm, Ref) and resolver:
            parm = resolver(parm)
        fname = str(filt)
        if fname == "FlateDecode":
            data = _bounded_inflate(data)
            if isinstance(parm, dict):
                pred = parm.get("Predictor", 1)
                if isinstance(pred, int) and pred >= 10:
                    data = _apply_png_predictor(
                        data,
                        int(parm.get("Colors", 1)),
                        int(parm.get("BitsPerComponent", 8)),
                        int(parm.get("Columns", 1)),
                    )
        elif fname in ("ASCIIHexDecode",):
            data = bytes.fromhex(
                re.sub(rb"[^0-9A-Fa-f]", b"", data.rstrip(b">")).decode()
            )
        else:
            raise PDFParseError(f"unsupported filter {fname}")
    stream._decoded = data
    return data


# ============================ document ============================


class PDFDocument:
    def __init__(self, data: bytes) -> None:
        if not data.startswith(b"%PDF"):
            raise PDFParseError("not a PDF (missing %PDF header)")
        self.data = data
        self._objects: dict[int, object] = {}
        self._offsets: dict[int, int] = {}
        self._in_objstm: dict[int, tuple[int, int]] = {}  # num -> (stm num, idx)
        self.trailer: dict = {}
        self._load_xref()

    # ----- xref -----

    def _load_xref(self) -> None:
        m = re.search(rb"startxref\s+(\d+)", self.data[-2048:])
        if not m:
            self._scan_all_objects()
            return
        offset = int(m.group(1))
        seen: set[int] = set()
        while offset and offset not in seen:
            seen.add(offset)
            offset = self._load_xref_section(offset)
        if not self._offsets and not self._in_objstm:
            self._scan_all_objects()

    def _load_xref_section(self, offset: int) -> int:
        lx = _Lexer(self.data, offset)
        lx.skip_ws()
        if self.data[lx.pos : lx.pos + 4] == b"xref":
            lx.pos += 4
            while True:
                lx.skip_ws()
                if self.data[lx.pos : lx.pos + 7] == b"trailer":
                    lx.pos += 7
                    trailer = _parse_object(lx, self.resolve)
                    if isinstance(trailer, dict):
                        for k, v in trailer.items():
                            self.trailer.setdefault(k, v)
                        prev = trailer.get("Prev")
                        xstm = trailer.get("XRefStm")
                        if isinstance(xstm, int):
                            self._load_xref_section(xstm)
                        return prev if isinstance(prev, int) else 0
                    return 0
                start_tok = lx.read_token()
                count_tok = lx.read_token()
                if not start_tok.isdigit() or not count_tok.isdigit():
                    return 0
                start, count = int(start_tok), int(count_tok)
                lx.skip_ws()
                for i in range(count):
                    entry = self.data[lx.pos : lx.pos + 20]
                    lx.pos += 20
                    if entry[17:18] == b"n":
                        num = start + i
                        self._offsets.setdefault(num, int(entry[0:10]))
        else:
            # xref stream
            obj = self._parse_object_at(offset)
            if not isinstance(obj, Stream):
                return 0
            self._read_xref_stream(obj)
            for k, v in obj.dict.items():
                self.trailer.setdefault(k, v)
            prev = obj.dict.get("Prev")
            return prev if isinstance(prev, int) else 0
        return 0

    def _read_xref_stream(self, stm: Stream) -> None:
        data = decode_stream(stm, self.resolve)
        w = [int(x) for x in stm.dict["W"]]
        size = int(self.resolve_val(stm.dict.get("Size", 0)))
        index = stm.dict.get("Index", [0, size])
        entry_len = sum(w)
        pos = 0
        for i in range(0, len(index), 2):
            start, count = int(index[i]), int(index[i + 1])
            for num in range(start, start + count):
                if pos + entry_len > len(data):
                    return
                fields = []
                for width in w:
                    fields.append(
                        int.from_bytes(data[pos : pos + width], "big") if width else 1
                    )
                    pos += width
                ftype = fields[0]
                if ftype == 1:
                    self._offsets.setdefault(num, fields[1])
                elif ftype == 2:
                    self._in_objstm.setdefault(num, (fields[1], fields[2]))

    def _scan_all_objects(self) -> None:
        """Degraded mode: regex-scan for 'N G obj' markers."""
        for m in re.finditer(rb"(\d+)\s+(\d+)\s+obj\b", self.data):
            self._offsets.setdefault(int(m.group(1)), m.start())
        tm = re.search(rb"trailer", self.data)
        if tm:
            lx = _Lexer(self.data, tm.end())
            t = _parse_object(lx, self.resolve)
            if isinstance(t, dict):
                self.trailer.update(t)
        elif "Root" not in self.trailer:
            # find the catalog by scanning
            for num in self._offsets:
                obj = self.get_object(num)
                d = obj.dict if isinstance(obj, Stream) else obj
                if isinstance(d, dict) and d.get("Type") == Name("Catalog"):
                    self.trailer["Root"] = Ref(num, 0)
                    break

    # ----- objects -----

    def _parse_object_at(self, offset: int):
        lx = _Lexer(self.data, offset)
        lx.read_token()  # num
        lx.read_token()  # gen
        tok = lx.read_token()
        if tok != b"obj":
            raise PDFParseError(f"bad object header at {offset}")
        return _parse_object(lx, self.resolve)

    def get_object(self, num: int):
        if num in self._objects:
            return self._objects[num]
        if num in self._offsets:
            obj = self._parse_object_at(self._offsets[num])
        elif num in self._in_objstm:
            stm_num, idx = self._in_objstm[num]
            obj = self._load_from_objstm(stm_num, idx, num)
        else:
            obj = None
        self._objects[num] = obj
        return obj

    def _load_from_objstm(self, stm_num: int, idx: int, want: int):
        stm = self.get_object(stm_num)
        if not isinstance(stm, Stream):
            return None
        data = decode_stream(stm, self.resolve)
        n = int(self.resolve_val(stm.dict["N"]))
        first = int(self.resolve_val(stm.dict["First"]))
        header = _Lexer(data[:first])
        pairs = []
        for _ in range(n):
            onum = int(header.read_token())
            ooff = int(header.read_token())
            pairs.append((onum, ooff))
        for onum, ooff in pairs:
            if onum == want:
                lx = _Lexer(data, first + ooff)
                return _parse_object(lx, self.resolve)
        return None

    def resolve(self, ref: Ref):
        return self.get_object(ref.num)

    def resolve_val(self, v):
        while isinstance(v, Ref):
            v = self.resolve(v)
        return v

    # ----- pages -----

    def pages(self) -> list[dict]:
        root = self.resolve_val(self.trailer.get("Root"))
        if not isinstance(root, dict):
            raise PDFParseError("no document catalog")
        pages_node = self.resolve_val(root.get("Pages"))
        out: list[dict] = []
        self._walk_pages(pages_node, {}, out, set())
        return out

    def _walk_pages(self, node, inherited: dict, out: list, seen: set) -> None:
        node = self.resolve_val(node)
        if not isinstance(node, dict) or id(node) in seen:
            return
        seen.add(id(node))
        merged = dict(inherited)
        for key in ("Resources", "MediaBox", "Rotate"):
            if key in node:
                merged[key] = node[key]
        if node.get("Type") == Name("Page") or ("Contents" in node and "Kids" not in node):
            page = dict(node)
            for key, val in merged.items():
                page.setdefault(key, val)
            out.append(page)
            return
        for kid in self.resolve_val(node.get("Kids", [])) or []:
            self._walk_pages(kid, merged, out, seen)

    def page_content(self, page: dict) -> bytes:
        contents = self.resolve_val(page.get("Contents"))
        if contents is None:
            return b""
        if isinstance(contents, Stream):
            return decode_stream(contents, self.resolve)
        if isinstance(contents, list):
            return b"\n".join(
                decode_stream(self.resolve_val(c), self.resolve)
                for c in contents
                if isinstance(self.resolve_val(c), Stream)
            )
        return b""


# ============================ fonts / CMap ============================


_BFCHAR = re.compile(rb"beginbfchar(.*?)endbfchar", re.S)
_BFRANGE = re.compile(rb"beginbfrange(.*?)endbfrange", re.S)
_HEX = re.compile(rb"<([0-9A-Fa-f]+)>")
_CODESPACE = re.compile(rb"begincodespacerange\s*<([0-9A-Fa-f]+)>", re.S)


def _utf16be(hx: bytes) -> str:
    try:
        return bytes.fromhex(hx.decode()).decode("utf-16-be", "ignore")
    except ValueError:
        return ""


class FontDecoder:
    """Per-font byte-code → unicode decoding."""

    def __init__(self, doc: PDFDocument, font: dict) -> None:
        self.two_byte = str(doc.resolve_val(font.get("Subtype", ""))) == "Type0"
        self.cmap: dict[int, str] = {}
        to_uni = doc.resolve_val(font.get("ToUnicode"))
        if isinstance(to_uni, Stream):
            self._parse_tounicode(decode_stream(to_uni, doc.resolve))

    def _parse_tounicode(self, data: bytes) -> None:
        cs = _CODESPACE.search(data)
        if cs:
            self.two_byte = len(cs.group(1)) >= 4
        for block in _BFCHAR.findall(data):
            hexes = _HEX.findall(block)
            for src, dst in zip(hexes[0::2], hexes[1::2]):
                self.cmap[int(src, 16)] = _utf16be(dst)
        for block in _BFRANGE.findall(data):
            lx = _Lexer(block)
            while True:
                lx.skip_ws()
                if lx.peek() != 0x3C:
                    break
                lo = _parse_hex_string(lx)
                lx.skip_ws()
                if lx.peek() != 0x3C:
                    break
                hi = _parse_hex_string(lx)
                lx.skip_ws()
                if lx.peek() == 0x5B:
                    arr = _parse_object(lx)
                    base = int.from_bytes(lo, "big")
                    for i, item in enumerate(arr or []):
                        if isinstance(item, bytes):
                            self.cmap[base + i] = item.decode("utf-16-be", "ignore")
                elif lx.peek() == 0x3C:
                    dst = _parse_hex_string(lx)
                    lo_i, hi_i = int.from_bytes(lo, "big"), int.from_bytes(hi, "big")
                    dst_i = int.from_bytes(dst, "big")
                    width = max(2, len(dst))
                    for i in range(hi_i - lo_i + 1):
                        self.cmap[lo_i + i] = (
                            (dst_i + i).to_bytes(width, "big").decode(
                                "utf-16-be", "ignore"
                            )
                        )
                else:
                    break

    def decode(self, raw: bytes) -> str:
        out = []
        if self.two_byte:
            for i in range(0, len(raw) - 1, 2):
                code = (raw[i] << 8) | raw[i + 1]
                out.append(self.cmap.get(code, ""))
        else:
            for b in raw:
                out.append(self.cmap.get(b, chr(b) if 32 <= b < 127 or b >= 160 else ""))
        return "".join(out)


# ============================ text extraction ============================

_IDENTITY = FontDecoder.__new__(FontDecoder)
_IDENTITY.two_byte = False
_IDENTITY.cmap = {}


def _page_fonts(doc: PDFDocument, page: dict) -> dict[str, FontDecoder]:
    res = doc.resolve_val(page.get("Resources")) or {}
    fonts = doc.resolve_val(res.get("Font")) or {}
    out = {}
    for name, ref in fonts.items():
        font = doc.resolve_val(ref)
        if isinstance(font, dict):
            out[name] = FontDecoder(doc, font)
    return out


@dataclass
class _Segment:
    x: float  # device-space text origin
    y: float
    size: float  # device-space font size
    text: str


Matrix = tuple[float, float, float, float, float, float]
_ID_MAT: Matrix = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


def _mat_mul(m1: Matrix, m2: Matrix) -> Matrix:
    """Apply m1 first, then m2 (PDF row-vector convention)."""
    a1, b1, c1, d1, e1, f1 = m1
    a2, b2, c2, d2, e2, f2 = m2
    return (
        a1 * a2 + b1 * c2,
        a1 * b2 + b1 * d2,
        c1 * a2 + d1 * c2,
        c1 * b2 + d1 * d2,
        e1 * a2 + f1 * c2 + e2,
        e1 * b2 + f1 * d2 + f2,
    )


def _translate(dx: float, dy: float) -> Matrix:
    return (1.0, 0.0, 0.0, 1.0, dx, dy)


def _floats(vals, n) -> list[float] | None:
    try:
        return [float(v) for v in vals[-n:]]
    except (TypeError, ValueError):
        return None


def _collect_segments(doc: PDFDocument, page: dict) -> list[_Segment]:
    content = doc.page_content(page)
    fonts = _page_fonts(doc, page)
    lx = _Lexer(content)
    stack: list = []
    cur_font = _IDENTITY
    font_size = 10.0
    leading = 0.0
    ctm: Matrix = _ID_MAT
    gs_stack: list[Matrix] = []
    tm: Matrix = _ID_MAT  # text matrix
    tlm: Matrix = _ID_MAT  # text line matrix
    segments: list[_Segment] = []

    def show(raw) -> None:
        nonlocal tm
        if not isinstance(raw, bytes):
            return
        text = cur_font.decode(raw)
        if not text:
            return
        trm = _mat_mul(tm, ctm)
        # device-space size ≈ font size scaled by the matrix's y column
        size = font_size * (trm[1] ** 2 + trm[3] ** 2) ** 0.5
        segments.append(_Segment(trm[4], trm[5], max(size, 0.1), text))
        # advance the pen by an estimated width (0.5 em per char)
        tm = _mat_mul(_translate(len(text) * 0.5 * font_size, 0.0), tm)

    def newline(dy: float) -> None:
        nonlocal tm, tlm
        tlm = _mat_mul(_translate(0.0, dy), tlm)
        tm = tlm

    while lx.pos < len(content):
        lx.skip_ws()
        if lx.pos >= len(content):
            break
        c = lx.peek()
        if c in (0x2F, 0x28, 0x3C, 0x5B) or (0x30 <= c <= 0x39) or c in (0x2B, 0x2D, 0x2E):
            try:
                stack.append(_parse_object(lx))
            except PDFParseError:
                lx.pos += 1
            continue
        op = lx.read_token()
        if not op:
            lx.pos += 1
            continue
        if op == b"q":
            gs_stack.append(ctm)
        elif op == b"Q":
            if gs_stack:
                ctm = gs_stack.pop()
        elif op == b"cm" and len(stack) >= 6:
            vals = _floats(stack, 6)
            if vals:
                ctm = _mat_mul(tuple(vals), ctm)  # type: ignore[arg-type]
        elif op == b"Tf" and len(stack) >= 2:
            fname = stack[-2]
            if isinstance(fname, Name):
                cur_font = fonts.get(str(fname), _IDENTITY)
            vals = _floats(stack, 1)
            if vals and abs(vals[0]) > 1e-6:
                font_size = abs(vals[0])
        elif op == b"TL" and stack:
            vals = _floats(stack, 1)
            if vals:
                leading = abs(vals[0])
        elif op == b"Tj" and stack:
            show(stack[-1])
        elif op in (b"'", b'"') and stack:
            newline(-(leading or font_size * 1.2))
            show(stack[-1])
        elif op == b"TJ" and stack and isinstance(stack[-1], list):
            for item in stack[-1]:
                if isinstance(item, bytes):
                    show(item)
                elif isinstance(item, (int, float)):
                    # kern in thousandths of the font size; negative → right
                    tm = _mat_mul(
                        _translate(-float(item) / 1000.0 * font_size, 0.0), tm
                    )
        elif op in (b"Td", b"TD") and len(stack) >= 2:
            vals = _floats(stack, 2)
            if vals:
                if op == b"TD" and abs(vals[1]) > 1e-6:
                    leading = abs(vals[1])
                tlm = _mat_mul(_translate(vals[0], vals[1]), tlm)
                tm = tlm
        elif op == b"Tm" and len(stack) >= 6:
            vals = _floats(stack, 6)
            if vals:
                tlm = tuple(vals)  # type: ignore[assignment]
                tm = tlm
        elif op == b"T*":
            newline(-(leading or font_size * 1.2))
        elif op == b"BT":
            tm = tlm = _ID_MAT
            stack.clear()
        if op.isalpha() or op in (b"'", b'"', b"T*"):
            stack.clear()
    return segments


def _assemble_lines(segments: list[_Segment]) -> str:
    """Group segments by baseline, order by x, and reconstruct word gaps
    from x-advance geometry (handles per-glyph positioned PDFs)."""
    if not segments:
        return ""
    has_space_glyphs = any(" " in s.text for s in segments)
    median_size = sorted(s.size for s in segments)[len(segments) // 2]
    lines: dict[int, list[_Segment]] = {}
    for seg in segments:
        key = round(seg.y / max(2.0, median_size * 0.35))
        lines.setdefault(key, []).append(seg)
    out_lines: list[tuple[float, str]] = []
    for key, segs in lines.items():
        segs.sort(key=lambda s: s.x)
        parts: list[str] = []
        pen_end: float | None = None
        for seg in segs:
            if pen_end is not None:
                gap = seg.x - pen_end
                # With explicit space glyphs present, only bridge column
                # gaps; otherwise reconstruct word gaps geometrically.
                threshold = 1.2 * seg.size if has_space_glyphs else 0.3 * seg.size
                if gap > threshold and parts and not parts[-1].endswith(" "):
                    parts.append("  " if gap > 3.0 * seg.size else " ")
            parts.append(seg.text)
            pen_end = seg.x + len(seg.text) * 0.5 * seg.size
        line = "".join(parts).rstrip()
        if line.strip():
            out_lines.append((segs[0].y, line))
    out_lines.sort(key=lambda t: -t[0])  # device y grows upward
    return "\n".join(line for _, line in out_lines)


def extract_page_text(doc: PDFDocument, page: dict) -> str:
    return _assemble_lines(_collect_segments(doc, page))


def extract_pdf_text(data: bytes) -> list[str]:
    """Extract per-page text from PDF bytes. Empty string for pages
    without a text layer (→ OCR fallback upstream).

    Corrupted inputs raise PDFParseError (internal decode errors —
    zlib, int parses, slicing — are converted at this boundary so the
    loader's error handling sees one exception type)."""
    try:
        doc = PDFDocument(data)
        return [extract_page_text(doc, page) for page in doc.pages()]
    except PDFParseError:
        raise
    except Exception as exc:
        raise PDFParseError(f"corrupted PDF: {type(exc).__name__}: {exc}") from exc
