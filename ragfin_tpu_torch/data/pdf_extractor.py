"""PDF parameter extractor (C1) — pure-Python PDF text extraction.

Rebuilds the reference's ``FinRag_Parameter_Extractor`` honestly: the
reference's ``extract_text`` (pdfplumber) is real but its value extraction
returns hardcoded numbers regardless of input
(``multi_bank_extractor.py:21-104`` — documented stub). This module
implements real text extraction with no third-party PDF library (pdfplumber
is not in this image):

- brute-scan of ``N 0 obj`` bodies plus /ObjStm object-stream expansion,
- FlateDecode stream decompression,
- content-stream interpretation of the text operators (BT/ET, Tf, Td/TD/T*/
  Tm, Tj/TJ/'/") with per-font ToUnicode CMap decoding (bfchar/bfrange) for
  CID/Type0 fonts and Latin-1 fallback for simple fonts,
- line-break heuristics from text-positioning operators,

plus an honest parameter-extraction pass: generic ``label: numbers`` line
parsing instead of the reference's hardcoded values, keyed into the same
output schema (company / reportType / extracted line items). Batch behavior
parity: report type detection keys on the ``consol`` filename substring
(reference ``multi_bank_extractor.py:107-126``).
"""

from __future__ import annotations

import os
import re
import zlib
from typing import Iterator, Optional

# ---------------------------------------------------------------------------
# Object collection
# ---------------------------------------------------------------------------

_OBJ_RE = re.compile(rb"(\d+)\s+\d+\s+obj")
_STREAM_RE = re.compile(rb"stream\r?\n")


def _iter_direct_objects(data: bytes) -> Iterator[tuple[int, bytes]]:
    for m in _OBJ_RE.finditer(data):
        start = m.end()
        end = data.find(b"endobj", start)
        if end == -1:
            end = len(data)
        yield int(m.group(1)), data[start:end]


def _stream_of(body: bytes) -> Optional[bytes]:
    m = _STREAM_RE.search(body)
    if not m:
        return None
    raw = body[m.end():]
    end = raw.rfind(b"endstream")
    if end != -1:
        raw = raw[:end]
    raw = raw.rstrip(b"\r\n")
    if b"FlateDecode" in body[: m.start()]:
        try:
            return zlib.decompress(raw)
        except zlib.error:
            try:  # some writers pad; try raw deflate
                return zlib.decompressobj().decompress(raw)
            except zlib.error:
                return None
    return raw


def collect_objects(data: bytes) -> dict[int, bytes]:
    """All object bodies, including those packed inside /ObjStm streams."""
    objects: dict[int, bytes] = {}
    for num, body in _iter_direct_objects(data):
        objects[num] = body
    # Expand object streams: header is `num offset` pairs, /First marks data start.
    for num, body in list(objects.items()):
        if b"/ObjStm" not in body:
            continue
        content = _stream_of(body)
        if content is None:
            continue
        m_n = re.search(rb"/N\s+(\d+)", body)
        m_first = re.search(rb"/First\s+(\d+)", body)
        if not (m_n and m_first):
            continue
        first = int(m_first.group(1))
        header = content[:first].split()
        pairs = [(int(header[i]), int(header[i + 1])) for i in range(0, len(header) - 1, 2)]
        for idx, (onum, ooff) in enumerate(pairs):
            oend = pairs[idx + 1][1] if idx + 1 < len(pairs) else len(content) - first
            objects.setdefault(onum, content[first + ooff : first + oend])
    return objects


# ---------------------------------------------------------------------------
# ToUnicode CMaps
# ---------------------------------------------------------------------------

_BFCHAR_RE = re.compile(rb"beginbfchar(.*?)endbfchar", re.S)
_BFRANGE_RE = re.compile(rb"beginbfrange(.*?)endbfrange", re.S)
_HEX_RE = re.compile(rb"<([0-9A-Fa-f]+)>")


def parse_tounicode(cmap: bytes) -> dict[int, str]:
    """CID code → unicode string from bfchar/bfrange sections."""
    mapping: dict[int, str] = {}

    def uni(hexs: bytes) -> str:
        try:
            raw = bytes.fromhex(hexs.decode())
            return raw.decode("utf-16-be", errors="ignore")
        except ValueError:
            return ""

    for section in _BFCHAR_RE.findall(cmap):
        hexes = _HEX_RE.findall(section)
        for src, dst in zip(hexes[0::2], hexes[1::2]):
            mapping[int(src, 16)] = uni(dst)
    # Rows are <lo> <hi> <dst> OR <lo> <hi> [<d1> <d2> ...] — the array
    # form must be parsed structurally: flattening all hex tokens and
    # striding by 3 would desync on the first array row and corrupt every
    # range after it (silently vanishing characters).
    row_re = re.compile(
        rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*"
        rb"(?:<([0-9A-Fa-f]+)>|\[((?:\s*<[0-9A-Fa-f]+>)*)\s*\])"
    )
    for section in _BFRANGE_RE.findall(cmap):
        for m in row_re.finditer(section):
            lo_i, hi_i = int(m.group(1), 16), int(m.group(2), 16)
            if hi_i - lo_i > 0xFFFF:
                continue
            if m.group(3) is not None:
                dst_i = int(m.group(3), 16)
                for code in range(lo_i, hi_i + 1):
                    try:
                        mapping[code] = chr(dst_i + (code - lo_i))
                    except ValueError:
                        pass
            else:
                dsts = _HEX_RE.findall(m.group(4))
                for code, dst in zip(range(lo_i, hi_i + 1), dsts):
                    mapping[code] = uni(dst)
    return mapping


# Adobe-Glyph-List subset covering the names bank filings actually use in
# /Encoding /Differences arrays (suffixes like "five.tab" strip to the base
# name; "f_f"-style ligature names split on underscores).
_GLYPH_NAMES = {
    "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9",
    "space": " ", "period": ".", "comma": ",", "colon": ":", "semicolon": ";",
    "hyphen": "-", "minus": "-", "plus": "+", "equal": "=", "underscore": "_",
    "slash": "/", "backslash": "\\", "percent": "%", "ampersand": "&",
    "dollar": "$", "numbersign": "#", "at": "@", "asterisk": "*",
    "exclam": "!", "question": "?", "quotesingle": "'", "quotedbl": '"',
    "quoteright": "'", "quoteleft": "'", "quotedblleft": '"', "quotedblright": '"',
    "parenleft": "(", "parenright": ")", "bracketleft": "[", "bracketright": "]",
    "braceleft": "{", "braceright": "}", "less": "<", "greater": ">",
    "bar": "|", "tilde": "~", "asciitilde": "~", "asciicircum": "^",
    "endash": "–", "emdash": "—", "bullet": "•", "rupee": "₹",
    "fi": "fi", "fl": "fl", "ff": "ff", "ffi": "ffi", "ffl": "ffl",
}
for _ch in "abcdefghijklmnopqrstuvwxyz":
    _GLYPH_NAMES[_ch] = _ch
    _GLYPH_NAMES[_ch.upper()] = _ch.upper()


def glyph_to_unicode(name: str) -> str:
    base = name.split(".")[0]
    if base.startswith("uni") and len(base) >= 7:
        try:
            return chr(int(base[3:7], 16))
        except ValueError:
            return ""
    if "_" in base:  # ligature name like f_f
        return "".join(glyph_to_unicode(part) for part in base.split("_"))
    return _GLYPH_NAMES.get(base, "")


_DIFF_RE = re.compile(rb"/Differences\s*\[(.*?)\]", re.S)
_DIFF_TOKEN_RE = re.compile(rb"(\d+)|/([^\s/\[\]<>]+)")


def parse_differences(head: bytes) -> dict[int, str]:
    """/Encoding /Differences array → code → unicode char."""
    m = _DIFF_RE.search(head)
    if not m:
        return {}
    mapping: dict[int, str] = {}
    code = 0
    for num, name in _DIFF_TOKEN_RE.findall(m.group(1)):
        if num:
            code = int(num)
        else:
            uni = glyph_to_unicode(name.decode("latin-1"))
            if uni:
                mapping[code] = uni
            code += 1
    return mapping


class Font:
    def __init__(
        self,
        two_byte: bool = False,
        cmap: Optional[dict[int, str]] = None,
        differences: Optional[dict[int, str]] = None,
    ):
        self.two_byte = two_byte
        self.cmap = cmap or {}
        self.differences = differences or {}

    def _decode_code(self, code: int) -> str:
        if code in self.cmap:
            return self.cmap[code]
        if code in self.differences:
            return self.differences[code]
        if self.cmap:  # mapped font: unmapped codes are unknown glyphs
            return ""
        return chr(code) if 32 <= code < 0x3000 else ""

    def decode_hex(self, payload: bytes) -> str:
        width = 2 if self.two_byte else 1
        return "".join(
            self._decode_code(int.from_bytes(payload[i : i + width], "big"))
            for i in range(0, len(payload) - width + 1, width)
        )

    def decode_literal(self, payload: bytes) -> str:
        if self.two_byte or self.cmap:
            # CID fonts address glyphs even in literal strings.
            return self.decode_hex(payload)
        if self.differences:
            return "".join(
                self.differences.get(b, chr(b) if 32 <= b < 256 else "") for b in payload
            )
        return payload.decode("latin-1", errors="ignore")


def build_font_table(objects: dict[int, bytes]) -> dict[int, Font]:
    """Object number of each font dict → Font with its ToUnicode map."""
    cmaps: dict[int, dict[int, str]] = {}
    for num, body in objects.items():
        if b"bfchar" in body or b"bfrange" in body:
            content = _stream_of(body) or body
            cmaps[num] = parse_tounicode(content)
    # Standalone /Encoding objects holding /Differences arrays.
    encodings: dict[int, dict[int, str]] = {}
    for num, body in objects.items():
        head = body.split(b"stream", 1)[0]
        if b"/Differences" in head:
            encodings[num] = parse_differences(head)

    fonts: dict[int, Font] = {}
    for num, body in objects.items():
        head = body.split(b"stream", 1)[0]
        if b"/Font" not in head and b"/BaseFont" not in head:
            continue
        two_byte = b"/Type0" in head or b"Identity-H" in head
        cmap = None
        m = re.search(rb"/ToUnicode\s+(\d+)\s+\d+\s+R", head)
        if m:
            cmap = cmaps.get(int(m.group(1)))
        differences = parse_differences(head)
        if not differences:
            m = re.search(rb"/Encoding\s+(\d+)\s+\d+\s+R", head)
            if m:
                differences = encodings.get(int(m.group(1)), {})
        fonts[num] = Font(two_byte=two_byte, cmap=cmap, differences=differences)
    return fonts


def resource_font_map(objects: dict[int, bytes], fonts: dict[int, Font]) -> dict[bytes, Font]:
    """Font resource name (e.g. b'F1') → Font, merged across pages.

    Bank filings reuse consistent names per document; a per-page resource
    walk is unnecessary for text recovery.
    """
    out: dict[bytes, Font] = {}
    for body in objects.values():
        head = body.split(b"stream", 1)[0]
        for m in re.finditer(rb"/(\w+)\s+(\d+)\s+\d+\s+R", head):
            name, ref = m.group(1), int(m.group(2))
            if ref in fonts and name not in out:
                out[name] = fonts[ref]
    return out


# ---------------------------------------------------------------------------
# Content-stream text interpretation
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    # Literal string, allowing ONE level of unescaped balanced parens —
    # legal per the PDF spec and ubiquitous in filings ("Profit/(Loss)");
    # without the inner alternative the match stops at the nested '(' and
    # the label extracts garbled.
    rb"\((?:\\.|\((?:\\.|[^\\()])*\)|[^\\()])*\)"  # literal string
    rb"|<[0-9A-Fa-f\s]*>"  # hex string
    rb"|\[|\]"
    rb"|/[^\s/\[\]()<>]+"
    rb"|[-+.0-9]+"
    rb"|[A-Za-z'\"*]+"
)

_ESCAPES = {b"n": "\n", b"r": "\r", b"t": "\t", b"b": "\b", b"f": "\f",
             b"(": "(", b")": ")", b"\\": "\\"}


def _unescape_literal(raw: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(raw):
        c = raw[i : i + 1]
        if c == b"\\" and i + 1 < len(raw):
            nxt = raw[i + 1 : i + 2]
            if nxt in b"01234567":  # octal escape, up to 3 OCTAL digits
                # (\8 / \9 are not octal: the PDF spec says a backslash
                # before a non-octal digit just drops; int(_, 8) on them
                # crashed the whole document's extraction.)
                j = i + 1
                digits = b""
                while j < len(raw) and raw[j : j + 1] in b"01234567" and len(digits) < 3:
                    digits += raw[j : j + 1]
                    j += 1
                out.append(int(digits, 8) & 0xFF)
                i = j
                continue
            mapped = _ESCAPES.get(nxt)
            if mapped is not None:
                out.extend(mapped.encode("latin-1"))
            else:
                out.extend(nxt)
            i += 2
            continue
        out.extend(c)
        i += 1
    return bytes(out)


def extract_stream_text(content: bytes, fontmap: dict[bytes, Font]) -> str:
    """Interpret the text operators of one content stream."""
    default_font = Font()
    font = default_font
    lines: list[str] = [""]
    pending: list[tuple[str, bytes]] = []  # (kind, payload) awaiting operator

    def emit(text: str) -> None:
        lines[-1] += text

    def newline() -> None:
        if lines[-1]:
            lines.append("")

    for m in _TOKEN_RE.finditer(content):
        token = m.group(0)
        first = token[:1]
        if first == b"(":
            pending.append(("lit", _unescape_literal(token[1:-1])))
        elif first == b"<":
            hexs = re.sub(rb"\s", b"", token[1:-1])
            if len(hexs) % 2:
                hexs += b"0"
            pending.append(("hex", bytes.fromhex(hexs.decode())))
        elif first == b"/":
            pending.append(("name", token[1:]))
        elif token in (b"Tj", b"'", b'"'):
            if token != b"Tj":
                newline()
            for kind, payload in pending:
                if kind == "lit":
                    emit(font.decode_literal(payload))
                elif kind == "hex":
                    emit(font.decode_hex(payload))
            pending.clear()
        elif token == b"TJ":
            for kind, payload in pending:
                if kind == "lit":
                    emit(font.decode_literal(payload))
                elif kind == "hex":
                    emit(font.decode_hex(payload))
            pending.clear()
        elif token == b"Tf":
            for kind, payload in reversed(pending):
                if kind == "name":
                    font = fontmap.get(payload, default_font)
                    break
            pending.clear()
        elif token in (b"Td", b"TD", b"T*", b"Tm", b"ET"):
            newline()
            pending.clear()
        elif token == b"]":
            continue
        elif token == b"[":
            continue
        elif first.isalpha():
            pending.clear()
    return "\n".join(line.rstrip() for line in lines if line.strip())


def extract_text(path: str) -> str:
    """All recoverable text of a PDF (page streams in document order)."""
    with open(path, "rb") as f:
        data = f.read()
    objects = collect_objects(data)
    fonts = build_font_table(objects)
    fontmap = resource_font_map(objects, fonts)
    pieces = []
    for num in sorted(objects):
        body = objects[num]
        content = _stream_of(body)
        if content is None:
            continue
        if b"BT" not in content or (b"Tj" not in content and b"TJ" not in content):
            continue
        text = extract_stream_text(content, fontmap)
        if text:
            pieces.append(text)
    return "\n\n".join(pieces)


# ---------------------------------------------------------------------------
# Parameter extraction (honest generic line-item parse, schema parity)
# ---------------------------------------------------------------------------

# Possessive quantifiers ([\d,]++ etc., Python 3.11+) forbid backtracking
# INTO a number token: the ambiguous split of "[\d,]+" groups under the
# outer repetition otherwise explodes combinatorially on digit/comma runs
# (a 65-char garbled line measured minutes of regex time — a hang for the
# whole extraction batch).
_LINE_ITEM_RE = re.compile(
    r"^([A-Za-z][A-Za-z &/().,'-]{3,80}?)[\s.:]*+((?:\(?-?[\d,]++(?:\.\d++)?\)?[\s]*+){1,8}+)$"
)

_BANKS = ("icici", "axis", "hdfc", "kotak", "sbi", "dbs", "yes bank", "indusind")


def detect_company(path: str, text: str) -> str:
    haystack = (os.path.basename(path) + " " + text[:2000]).lower()
    acronyms = {"sbi": "SBI", "dbs": "DBS", "hdfc": "HDFC", "icici": "ICICI"}
    for bank in _BANKS:
        if bank in haystack:
            return acronyms.get(bank, bank.title()) + (" Bank" if bank not in ("yes bank",) else "")
    return "Unknown Bank"


def detect_report_type(path: str) -> str:
    """Filename keying parity with the reference batch loop
    (multi_bank_extractor.py:107-126): 'consol' substring → consolidated."""
    return "CONSOLIDATED FINANCIAL RESULTS" if "consol" in os.path.basename(path).lower() else "STANDALONE FINANCIAL RESULTS"


def parse_line_items(text: str, max_items: int = 500) -> list[dict]:
    """Generic `label ... numbers` rows → structured line items."""
    items = []
    for line in text.splitlines():
        line = line.strip()
        m = _LINE_ITEM_RE.match(line)
        if not m:
            continue
        label = m.group(1).strip(" .:")
        numbers = []
        for tok in re.findall(r"\(?-?[\d,]+(?:\.\d+)?\)?", m.group(2)):
            neg = tok.startswith("(") and tok.endswith(")")
            tok = tok.strip("()").replace(",", "")
            try:
                value = float(tok)
            except ValueError:
                continue
            numbers.append(-value if neg else value)
        if numbers:
            items.append({"label": label, "values": numbers})
        if len(items) >= max_items:
            break
    return items


def extract_report(path: str) -> dict:
    """Full extraction: text + schema-shaped summary (no hardcoded values)."""
    text = extract_text(path)
    return {
        "company": detect_company(path, text),
        "reportType": detect_report_type(path),
        "currency": "INR crore" if re.search(r"crore|lakh|₹|rs\.", text, re.I) else "unknown",
        "source_file": os.path.basename(path),
        "char_count": len(text),
        "lineItems": parse_line_items(text),
        "text": text,
    }


def extract_batch(folder: str) -> list[dict]:
    """Batch over a folder of PDFs (reference multi_bank_extractor loop)."""
    out = []
    for name in sorted(os.listdir(folder)):
        if not name.lower().endswith(".pdf"):
            continue
        try:
            out.append(extract_report(os.path.join(folder, name)))
        except Exception as e:
            out.append({"source_file": name, "error": str(e)})
    return out
